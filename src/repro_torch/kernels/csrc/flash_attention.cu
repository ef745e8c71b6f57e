// Flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_fa_kernel), which the LM substrate's full-sequence
// forward (the prefill) calls once per attention layer.  It computes, for
// each (batch*head) slice of q (sq, dh), k and v (sk, dh):
//
//   logits = (q . k^T) * scale                      (fp32, scale after the dot)
//   logits = softcap * tanh(logits / softcap)        when softcap > 0
//   attend  kpos < sk,
//           and kpos <= q_offset + qpos              when causal,
//           and kpos >  q_offset + qpos - window     when window > 0
//   out     = online softmax(logits) . v, with the finite -1e30 sentinel,
//             divided by (l > 0 ? l : 1): a fully masked row gives exactly 0
//
// in fp32, stored in the input type (fp32 or bf16).  Heads arrive already
// GQA-repeated, as in the reference.
//
// Bound: operations.  At the prefill shape (1, 16, 8192, 224) bf16 the
// unmasked pairs need 4*h*pairs*dh = 481 GFLOP causal and ~361 GFLOP at
// window 4096: ~0.49 / 0.37 ms at the H100's 989 TFLOP/s dense bf16 peak,
// against 235 MB of q, k, v and o (0.07 ms at 3.35 TB/s).
//
// Design (simple first, no tensor cores): one 256-thread block per 64 query
// rows of one (batch*head) slice; each of the 8 warps owns 8 query rows and
// keeps their running max, sum and (8 x dh) output accumulator in registers
// (dh <= 256: 8 columns per lane).  The block walks the keys in steps of 32
// (one key per lane): K and V tiles are staged in shared memory as fp32
// (converted from the input type as they are stored), each lane computes
// its key's logit for the warp's 8 rows with float4 reads (q broadcast, K
// rows padded so that 8 lanes' float4 rows hit distinct banks), the row
// max and sum are warp-shuffle reductions, and P.V broadcasts each key's
// probabilities with shuffles against V rows read by lane-strided columns.
// The q tile (64 x dh fp32) and the two key tiles take 115 KB at dh=224,
// above the 48 KB static limit, so the launch opts in to dynamic shared
// memory with cudaFuncSetAttribute.  Key steps wholly masked for every row
// of the block (past the causal diagonal, or before the window of the
// block's first row) are skipped: for such a step the reference's update
// is the identity (alpha = 1, p = 0).  Ragged edges are masked, not read:
// q rows past sq and key rows past sk are zero-filled and never stored or
// attended.  tanhf and expf, not the approximate forms, so the soft-cap
// and the softmax stay within the plain version's tolerance.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or the shared-memory opt-in's error) so the
// Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FA_WARPS = 8;
constexpr int FA_ROWS = 8;                     // query rows per warp
constexpr int FA_BQ = FA_WARPS * FA_ROWS;      // 64 query rows per block
constexpr int FA_BK = 32;                      // keys per step, one per lane
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_MAX_DH = 256;
constexpr int FA_COLS = FA_MAX_DH / 32;        // output columns per lane
constexpr float FA_NEG = -1e30f;               // the reference's sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// dh rounded up to a multiple of 4 (float4 reads); the padding is zero
__host__ __device__ __forceinline__ int padded(int dh) {
  return (dh + 3) & ~3;
}
// K row stride in floats: a multiple of 4 whose quotient by 4 is odd, so
// the 8 lanes of each quarter-warp float4 read start on distinct banks
__host__ __device__ __forceinline__ int k_stride(int dh) {
  const int p = padded(dh);
  return ((p / 4) % 2 == 1) ? p : p + 4;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int dh) {
  return sizeof(float) *
         (static_cast<size_t>(FA_BQ) * padded(dh) +
          static_cast<size_t>(FA_BK) * k_stride(dh) +
          static_cast<size_t>(FA_BK) * padded(dh));
}

// rows [row0, row0 + n_tile) of a (n_rows, dh) matrix into dst (row stride
// ld floats); rows past n_rows and columns in [dh, padded(dh)) become 0
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int row0, int n_tile, int n_rows,
                                          int dh) {
  const int dhp = padded(dh);
  const int total = n_tile * dhp;
  for (int e = threadIdx.x; e < total; e += FA_THREADS) {
    const int r = e / dhp;
    const int c = e - r * dhp;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < n_rows && c < dh) x = to_f32(src[static_cast<int64_t>(gr) * dh + c]);
    dst[r * ld + c] = x;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int sk, int dh, float scale, int causal, int window,
                       float softcap, int q_offset) {
  extern __shared__ __align__(16) float smem[];
  const int dhp = padded(dh);
  const int ldk = k_stride(dh);
  float* qs = smem;                          // [FA_BQ][dhp]
  float* ks = qs + FA_BQ * dhp;              // [FA_BK][ldk]
  float* vs = ks + FA_BK * ldk;              // [FA_BK][dhp]

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * FA_BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * FA_ROWS;             // this warp's first local row
  const T* __restrict__ qb = q + bh * sq * dh;
  const T* __restrict__ kb = k + bh * sk * dh;
  const T* __restrict__ vb = v + bh * sk * dh;
  T* __restrict__ ob = o + bh * sq * dh;

  load_tile(qs, dhp, qb, q0, FA_BQ, sq, dh);

  // keys any row of this block may attend; steps outside are fully masked
  const int a_lo = q_offset + q0;
  const int a_hi = q_offset + min(q0 + FA_BQ, sq) - 1;
  const int kv_end = causal ? min(sk, a_hi + 1) : sk;
  const int kv_begin = window > 0 ? max(0, a_lo - window + 1) : 0;

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][FA_COLS];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    m[r] = FA_NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < FA_COLS; ++c) acc[r][c] = 0.f;
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += FA_BK) {
    __syncthreads();                         // previous tiles consumed
    load_tile(ks, ldk, kb, kv0, FA_BK, sk, dh);
    load_tile(vs, dhp, vb, kv0, FA_BK, sk, dh);
    __syncthreads();

    // this lane's key against the warp's rows
    float s[FA_ROWS];
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * ldk);
#pragma unroll 2
    for (int d4 = 0; d4 < dhp / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(qs + (r0 + r) * dhp)[d4];
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    // online softmax over this step's 32 keys, row by row
    const int kpos = kv0 + lane;
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
      const int qpos = q_offset + q0 + r0 + r;
      float x = s[r] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool ok = kpos < sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      x = ok ? x : FA_NEG;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int c = 0; c < FA_COLS; ++c) acc[r][c] *= alpha;
    }

    // acc += P . V, each key's probabilities broadcast from its lane
#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      float pj[FA_ROWS];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r)
        pj[r] = __shfl_sync(0xffffffffu, s[r], j);
      const float* vrow = vs + j * dhp;
#pragma unroll
      for (int c = 0; c < FA_COLS; ++c) {
        const int col = lane + 32 * c;
        if (col < dhp) {
          const float vv = vrow[col];
#pragma unroll
          for (int r = 0; r < FA_ROWS; ++r) acc[r][c] += pj[r] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int row = q0 + r0 + r;
    if (row >= sq) continue;
    const float denom = l[r] > 0.f ? l[r] : 1.f;
    T* orow = ob + static_cast<int64_t>(row) * dh;
#pragma unroll
    for (int c = 0; c < FA_COLS; ++c) {
      const int col = lane + 32 * c;
      if (col < dh) store(orow + col, acc[r][c] / denom);
    }
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int bh, int sq, int sk,
           int dh, float scale, int causal, int window, float softcap,
           int q_offset, void* stream) {
  if (dh < 1 || dh > FA_MAX_DH || bh > 65535 || bh < 0 || sq < 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(bh) * sq == 0) return 0;
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + FA_BQ - 1) / FA_BQ, bh);
  flash_attention_kernel<T>
      <<<grid, FA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          q, k, v, o, sq, sk, dh, scale, causal, window, softcap, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (bh, sq, dh), k and v (bh, sk, dh), o (bh, sq, dh), all contiguous
// fp32; causal 0/1, window 0 = none, softcap 0 = none.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, int bh, int sq, int sk, int dh, float scale,
                        int causal, int window, float softcap, int q_offset,
                        void* stream) {
  return launch<float>(q, k, v, o, bh, sq, sk, dh, scale, causal, window,
                       softcap, q_offset, stream);
}

// The same over bf16 tensors (fp32 accumulation, bf16 output).
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int bh, int sq, int sk, int dh, float scale,
                         int causal, int window, float softcap, int q_offset,
                         void* stream) {
  using bf = __nv_bfloat16;
  return launch<bf>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), static_cast<bf*>(o), bh, sq,
                    sk, dh, scale, causal, window, softcap, q_offset, stream);
}

}  // extern "C"
