// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// The gradient of csrc/flash_attention.cu's function.  The reference has no
// backward kernel (its Pallas call has no VJP; its gradient is autodiff of
// the plain jnp forms), so this is the port's own: the training path calls
// it once per attention layer in the backward pass.  For each (batch*head)
// slice of q (sq, dh), k and v (sk, dh), the forward's output o, the
// upstream gradient do (sq, dh) and the forward's per-row log-sum-exp in
// base 2 (lse, written by the forward kernels when asked; +inf where a row
// attends no key), it computes
//
//   t2  = s * scale * log2(e)                        (s = q . k, fp32)
//       = cap2 * tanh(s * scale / softcap)           when softcap > 0
//                                                    (cap2 = softcap log2 e)
//   P   = 2^(t2 - lse) where attended, else 0        (the forward's mask)
//   D   = rowsum(do * o)
//   dS  = P * (do . v^T - D) * scale * (1 - (t2 / cap2)^2 when capped)
//   dv  = P^T . do,   dk = dS^T . q,   dq = dS . k
//
// with fp32 accumulation, stored in the input type (fp32 or bf16).  A fully
// masked row has P = 0 and gives zero gradients.  Heads arrive already
// GQA-repeated; the caller sums the repeated heads' gradients.
//
// Bound: operations.  The five products (S and do.v^T to recompute, then
// dv, dk, dq) are 10 sq sk dh flops a slice (halved by a causal mask), at
// the H100's dense bf16 / TF32 tensor rate.  This first body runs them on
// the CUDA cores (fp32 FMA, 67 TFLOP/s peak) and recomputes S and do.v^T
// once more for dq: 14 sq sk dh flops.  The tensor-core redesign is a later
// step (ROADMAP queue 2).
//
// Design (FlashAttention-2's split, without atomics, so every sum is in a
// fixed order and a run repeats bit for bit):
//   - flash_bwd_delta_kernel: D, one warp a row.
//   - flash_bwd_dkdv_kernel<T, DP>: one 256-thread block a key tile of B
//     rows (B = 64 for dh <= 128, else 32); dk and dv of the tile stay in
//     registers (B/16 rows x DP/16 columns a thread each) while the block
//     walks the query tiles that attend any of its keys: Q, do, lse and D
//     of the tile into shared memory, S and do.v^T (B/16 x B/16 a thread),
//     P and dS into shared memory, then dv += P^T.do and dk += dS^T.q.
//   - flash_bwd_dq_kernel<T, DP>: one block a query tile, dq in registers,
//     walking the key tiles its rows attend (the forward's range).
//   - Tiles are fp32 [rows][DP + 4] in shared memory (rows past the input
//     and head dims past dh are 0), filled by 16-byte loads where dh and
//     the bases allow (element by element otherwise): the float4 reads of S's inner loop fall
//     on distinct banks for the 8 rows a quarter-warp reads, and the float2
//     reads of the accumulations are contiguous.  P and dS are
//     [B][B + 16] (two rows a warp writes land on opposite bank halves).
//   - Soft-cap: tanhf, as the fp32 forward; the bf16 forward's
//     1 - 2 / (1 + 2^(2u log2 e)) differs by ~1e-5 of a logit at cap 50.
//
// Every entry point launches on the caller's stream, allocates nothing
// (the caller passes D's buffer) and returns cudaGetLastError() (or the
// shared-memory opt-in's error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 256;
constexpr int MAX_DH = 256;

template <int DP>
struct BwdShape {
  static constexpr int B = DP <= 128 ? 64 : 32;  // rows of a q or k tile
  static constexpr int LD = DP + 4;              // row stride of a tile
  static constexpr int LDP = B + 16;             // row stride of P and dS
  static constexpr int RT = B / 16;              // rows a thread
  static constexpr int C2 = DP / 32;             // float2 columns a thread
  static constexpr size_t SMEM =
      sizeof(float) * (4 * B * LD + 2 * B * LDP + 2 * B);
  static_assert(DP % 32 == 0, "DP must be a multiple of 32");
  static_assert(SMEM <= 232448, "a block may use 227 KB of shared memory");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// 8 bf16 (one 16-byte load) or 4 floats as floats
__device__ __forceinline__ void unpack16(const uint4& raw, const float*,
                                         float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, const bf16*,
                                         float (&out)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// rows [row0, row0 + ROWS) of a (n_rows, dh) matrix into the fp32 tile dst
// ([ROWS][LD]); rows past n_rows and columns in [dh, DP) become 0.  vec:
// 16-byte loads (dh a multiple of 16 bytes' elements, 16-byte aligned
// bases), else element by element.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int row0, int n_rows, int dh,
                                          int vec) {
  constexpr int LD = DP + 4;
  if (vec) {
    constexpr int V = 16 / sizeof(T);      // elements a 16-byte load
    constexpr int CH = DP / V;
    for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
      const int r = e / CH;
      const int c = (e - r * CH) * V;
      const int gr = row0 + r;
      float vals[V];
      if (gr < n_rows && c < dh) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + static_cast<int64_t>(gr) * dh + c);
        unpack16(raw, src, vals);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) vals[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(dst + r * LD + c + i) =
            make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
      const int r = e / DP;
      const int c = e - r * DP;
      const int gr = row0 + r;
      dst[r * LD + c] = (gr < n_rows && c < dh)
                            ? to_f(src[static_cast<int64_t>(gr) * dh + c])
                            : 0.f;
    }
  }
}

// acc[i][j] += A[tq + 16 i] . Bm[tk + 16 j] over DP (A, Bm: [rows][LD])
template <int DP, int RT>
__device__ __forceinline__ void dot_tile(float (&acc)[RT][RT],
                                         const float* A, const float* Bm,
                                         int tq, int tk) {
  constexpr int LD = DP + 4;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 a[RT], b[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (tq + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < RT; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (tk + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        float x = acc[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        acc[i][j] = x;
      }
  }
}

// acc[i][2 jj + h] += sum_r W[r][tr + 16 i] * X[r][2 tc + 32 jj + h]
// over the tile's B rows r (W: [B][LDP], X: [B][LD]); TRANS reads W[tr +
// 16 i][r] instead
template <int DP, bool TRANS>
__device__ __forceinline__ void acc_tile(
    float (&acc)[BwdShape<DP>::RT][2 * BwdShape<DP>::C2], const float* W,
    const float* X, int tr, int tc) {
  using S = BwdShape<DP>;
#pragma unroll 4
  for (int r = 0; r < S::B; ++r) {
    float w[S::RT];
#pragma unroll
    for (int i = 0; i < S::RT; ++i)
      w[i] = TRANS ? W[(tr + 16 * i) * S::LDP + r]
                   : W[r * S::LDP + tr + 16 * i];
    float2 x[S::C2];
#pragma unroll
    for (int jj = 0; jj < S::C2; ++jj)
      x[jj] = *reinterpret_cast<const float2*>(X + r * S::LD + 2 * tc +
                                               32 * jj);
#pragma unroll
    for (int i = 0; i < S::RT; ++i)
#pragma unroll
      for (int jj = 0; jj < S::C2; ++jj) {
        acc[i][2 * jj] = fmaf(w[i], x[jj].x, acc[i][2 * jj]);
        acc[i][2 * jj + 1] = fmaf(w[i], x[jj].y, acc[i][2 * jj + 1]);
      }
  }
}

// P and dS of one (query tile, key tile) pair from S and do.v^T in the
// thread's (tq + 16 i, tk + 16 j) entries, into Ps and dSs
template <int DP>
__device__ __forceinline__ void p_ds(
    const float (&s)[BwdShape<DP>::RT][BwdShape<DP>::RT],
    const float (&dp)[BwdShape<DP>::RT][BwdShape<DP>::RT], float* Ps,
    float* dSs, const float* lse_s, const float* d_s, int q0, int k0,
    int tq, int tk, int sq, int sk, float scale, int causal, int window,
    float softcap, int q_offset) {
  using S = BwdShape<DP>;
  const float sc2 = scale * LOG2E;
  const float uc = softcap > 0.f ? scale / softcap : 0.f;
  const float cap2 = softcap * LOG2E;
#pragma unroll
  for (int i = 0; i < S::RT; ++i) {
    const int r = tq + 16 * i;
    const int row = q0 + r;
    const int qpos = q_offset + row;
#pragma unroll
    for (int j = 0; j < S::RT; ++j) {
      const int c = tk + 16 * j;
      const int kpos = k0 + c;
      const bool ok = row < sq && kpos < sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      float p = 0.f, ds = 0.f;
      if (ok) {
        const float t2 = softcap > 0.f ? cap2 * tanhf(s[i][j] * uc)
                                       : s[i][j] * sc2;
        p = exp2f(t2 - lse_s[r]);
        ds = p * (dp[i][j] - d_s[r]) * scale;
        if (softcap > 0.f) {
          const float th = t2 / cap2;
          ds *= 1.f - th * th;
        }
      }
      Ps[r * S::LDP + c] = p;
      dSs[r * S::LDP + c] = ds;
    }
  }
}

__global__ void flash_bwd_delta_kernel(const void* __restrict__ o_,
                                       const void* __restrict__ do_,
                                       float* __restrict__ delta,
                                       int64_t rows, int dh, int is_bf16) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  if (is_bf16) {
    const bf16* o = static_cast<const bf16*>(o_) + row * dh;
    const bf16* d = static_cast<const bf16*>(do_) + row * dh;
    for (int c = lane; c < dh; c += 32)
      acc = fmaf(__bfloat162float(o[c]), __bfloat162float(d[c]), acc);
  } else {
    const float* o = static_cast<const float*>(o_) + row * dh;
    const float* d = static_cast<const float*>(do_) + row * dh;
    for (int c = lane; c < dh; c += 32) acc = fmaf(o[c], d[c], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int dh,
                      float scale, int causal, int window, float softcap,
                      int q_offset, int vec) {
  using S = BwdShape<DP>;
  constexpr int B = S::B;
  extern __shared__ __align__(16) float bsmem[];
  float* ks = bsmem;                      // [B][LD]
  float* vs = ks + B * S::LD;
  float* qs = vs + B * S::LD;
  float* dos = qs + B * S::LD;
  float* ps = dos + B * S::LD;            // [B][LDP]
  float* dss = ps + B * S::LDP;
  float* lse_s = dss + B * S::LDP;        // [B]
  float* d_s = lse_s + B;

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * B;
  const int tq = threadIdx.x >> 4, tk = threadIdx.x & 15;   // S entries
  const int tr = tq, tc = tk;             // accumulator rows / columns
  const T* __restrict__ qb = q + bh * sq * dh;
  const T* __restrict__ dob = dout + bh * sq * dh;
  const float* __restrict__ lseb = lse + bh * sq;
  const float* __restrict__ db = delta + bh * sq;

  // query rows that may attend a key of this tile
  const int r_begin = causal ? max(0, k0 - q_offset) : 0;
  const int r_end = window > 0
                        ? min(sq, k0 + B - 1 + window - q_offset)
                        : sq;
  const int i_begin = r_begin / B;
  const int i_end = r_end > r_begin ? (r_end + B - 1) / B : i_begin;

  float dk_acc[S::RT][2 * S::C2], dv_acc[S::RT][2 * S::C2];
#pragma unroll
  for (int i = 0; i < S::RT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * S::C2; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  load_tile<T, DP, B>(ks, k + bh * sk * dh, k0, sk, dh, vec);
  load_tile<T, DP, B>(vs, v + bh * sk * dh, k0, sk, dh, vec);
  for (int it = i_begin; it < i_end; ++it) {
    const int q0 = it * B;
    __syncthreads();                      // the last tile's readers are done
    load_tile<T, DP, B>(qs, qb, q0, sq, dh, vec);
    load_tile<T, DP, B>(dos, dob, q0, sq, dh, vec);
    for (int r = threadIdx.x; r < B; r += THREADS) {
      lse_s[r] = q0 + r < sq ? lseb[q0 + r] : 0.f;
      d_s[r] = q0 + r < sq ? db[q0 + r] : 0.f;
    }
    __syncthreads();
    float s[S::RT][S::RT] = {}, dp[S::RT][S::RT] = {};
    dot_tile<DP, S::RT>(s, qs, ks, tq, tk);
    dot_tile<DP, S::RT>(dp, dos, vs, tq, tk);
    p_ds<DP>(s, dp, ps, dss, lse_s, d_s, q0, k0, tq, tk, sq, sk, scale,
             causal, window, softcap, q_offset);
    __syncthreads();
    acc_tile<DP, false>(dv_acc, ps, dos, tr, tc);
    acc_tile<DP, false>(dk_acc, dss, qs, tr, tc);
  }

  T* __restrict__ dkb = dk + bh * sk * dh;
  T* __restrict__ dvb = dv + bh * sk * dh;
#pragma unroll
  for (int i = 0; i < S::RT; ++i) {
    const int row = k0 + tr + 16 * i;
    if (row >= sk) continue;
#pragma unroll
    for (int jj = 0; jj < S::C2; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 2 * tc + 32 * jj + h;
        if (col < dh) {
          dkb[static_cast<int64_t>(row) * dh + col] =
              from_f<T>(dk_acc[i][2 * jj + h]);
          dvb[static_cast<int64_t>(row) * dh + col] =
              from_f<T>(dv_acc[i][2 * jj + h]);
        }
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int dh, float scale, int causal,
                    int window, float softcap, int q_offset, int vec) {
  using S = BwdShape<DP>;
  constexpr int B = S::B;
  extern __shared__ __align__(16) float bsmem[];
  float* qs = bsmem;                      // [B][LD]
  float* dos = qs + B * S::LD;
  float* ks = dos + B * S::LD;
  float* vs = ks + B * S::LD;
  float* ps = vs + B * S::LD;             // [B][LDP]
  float* dss = ps + B * S::LDP;
  float* lse_s = dss + B * S::LDP;        // [B]
  float* d_s = lse_s + B;

  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * B;   // last blocks first
  const int tq = threadIdx.x >> 4, tk = threadIdx.x & 15;
  const int tr = tq, tc = tk;
  const T* __restrict__ kb = k + bh * sk * dh;
  const T* __restrict__ vb = v + bh * sk * dh;

  // keys any row of this tile may attend (the forward's range)
  const int a_lo = q_offset + q0;
  const int a_hi = q_offset + min(q0 + B, sq) - 1;
  const int kv_end = causal ? min(sk, a_hi + 1) : sk;
  const int kv_begin = window > 0 ? max(0, a_lo - window + 1) : 0;
  const int j_begin = kv_begin / B;
  const int j_end = kv_end > kv_begin ? (kv_end + B - 1) / B : j_begin;

  float dq_acc[S::RT][2 * S::C2];
#pragma unroll
  for (int i = 0; i < S::RT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * S::C2; ++j) dq_acc[i][j] = 0.f;

  load_tile<T, DP, B>(qs, q + bh * sq * dh, q0, sq, dh, vec);
  load_tile<T, DP, B>(dos, dout + bh * sq * dh, q0, sq, dh,
                      vec);
  for (int r = threadIdx.x; r < B; r += THREADS) {
    lse_s[r] = q0 + r < sq ? lse[bh * sq + q0 + r] : 0.f;
    d_s[r] = q0 + r < sq ? delta[bh * sq + q0 + r] : 0.f;
  }
  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * B;
    __syncthreads();
    load_tile<T, DP, B>(ks, kb, k0, sk, dh, vec);
    load_tile<T, DP, B>(vs, vb, k0, sk, dh, vec);
    __syncthreads();
    float s[S::RT][S::RT] = {}, dp[S::RT][S::RT] = {};
    dot_tile<DP, S::RT>(s, qs, ks, tq, tk);
    dot_tile<DP, S::RT>(dp, dos, vs, tq, tk);
    p_ds<DP>(s, dp, ps, dss, lse_s, d_s, q0, k0, tq, tk, sq, sk, scale,
             causal, window, softcap, q_offset);
    __syncthreads();
    acc_tile<DP, true>(dq_acc, dss, ks, tr, tc);
  }

  T* __restrict__ dqb = dq + bh * sq * dh;
#pragma unroll
  for (int i = 0; i < S::RT; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int jj = 0; jj < S::C2; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 2 * tc + 32 * jj + h;
        if (col < dh)
          dqb[static_cast<int64_t>(row) * dh + col] =
              from_f<T>(dq_acc[i][2 * jj + h]);
      }
  }
}

template <typename T, int DP>
int launch_bwd(const T* q, const T* k, const T* v, const T* o, const T* dout,
               const float* lse, float* delta, T* dq, T* dk, T* dv, int bh,
               int sq, int sk, int dh, float scale, int causal, int window,
               float softcap, int q_offset, cudaStream_t stream) {
  using S = BwdShape<DP>;
  const int smem = static_cast<int>(S::SMEM);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte loads need rows of whole 16-byte units from aligned bases
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = dh % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  aligned(q) && aligned(k) && aligned(v) && aligned(dout);
  const int64_t rows = static_cast<int64_t>(bh) * sq;
  if (rows > 0) {
    const int warps = THREADS / 32;
    flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + warps - 1) /
                                                   warps),
                             THREADS, 0, stream>>>(
        o, dout, delta, rows, dh, std::is_same<T, bf16>::value ? 1 : 0);
  }
  if (sk > 0) {
    const dim3 grid(bh, (sk + S::B - 1) / S::B);
    flash_bwd_dkdv_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, sq, sk, dh, scale, causal,
        window, softcap, q_offset, vec);
  }
  if (sq > 0) {
    const dim3 grid(bh, (sq + S::B - 1) / S::B);
    flash_bwd_dq_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, lse, delta, dq, sq, sk, dh, scale, causal, window,
        softcap, q_offset, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int bh, int sq, int sk, int dh, float scale,
             int causal, int window, float softcap, int q_offset,
             void* stream) {
  if (dh < 1 || dh > MAX_DH || bh < 0 || bh > 65535 || sq < 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0) return 0;
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* op = static_cast<const T*>(o);
  const auto* dop = static_cast<const T*>(dout);
  auto* dqp = static_cast<T*>(dq);
  auto* dkp = static_cast<T*>(dk);
  auto* dvp = static_cast<T*>(dv);
  const auto st = static_cast<cudaStream_t>(stream);
#define FA_BWD(DP)                                                          \
  return launch_bwd<T, DP>(qp, kp, vp, op, dop, lse, delta, dqp, dkp, dvp, \
                           bh, sq, sk, dh, scale, causal, window, softcap,  \
                           q_offset, st)
  if (dh <= 64) FA_BWD(64);
  if (dh <= 128) FA_BWD(128);
  if (dh <= 224) FA_BWD(224);
  FA_BWD(256);
#undef FA_BWD
}

}  // namespace

extern "C" {

// q, o, do, dq (bh, sq, dh); k, v, dk, dv (bh, sk, dh), all contiguous
// fp32; lse (bh, sq) the forward's base-2 log-sum-exp; delta (bh, sq) fp32
// scratch for D.  causal 0/1, window 0 = none, softcap 0 = none.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int bh, int sq, int sk,
                            int dh, float scale, int causal, int window,
                            float softcap, int q_offset, void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, sq,
                         sk, dh, scale, causal, window, softcap, q_offset,
                         stream);
}

// The same over bf16 tensors (fp32 lse, delta and accumulation).
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int bh, int sq, int sk,
                             int dh, float scale, int causal, int window,
                             float softcap, int q_offset, void* stream) {
  return dispatch<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, sq,
                        sk, dh, scale, causal, window, softcap, q_offset,
                        stream);
}

// Dynamic shared memory (bytes) a backward kernel at head dim dh takes.
int flash_attention_bwd_smem(int dh) {
  if (dh <= 64) return static_cast<int>(BwdShape<64>::SMEM);
  if (dh <= 128) return static_cast<int>(BwdShape<128>::SMEM);
  if (dh <= 224) return static_cast<int>(BwdShape<224>::SMEM);
  return static_cast<int>(BwdShape<256>::SMEM);
}

}  // extern "C"
