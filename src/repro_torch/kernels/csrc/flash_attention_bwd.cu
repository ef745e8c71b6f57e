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
// GQA-repeated; the caller sums the repeated heads' gradients.  Each body
// evaluates its forward's soft-cap tanh, so that its logits meet the
// forward's log-sum-exp: the bf16 body 1 - 2 / (1 + 2^(2u log2 e)) from
// ex2.approx and rcp.approx, the fp32 body tanhf; 2^x is ex2.approx.
//
// Bound: operations.  The five products (S and do.v^T to recompute, then
// dv, dk, dq) are 10 sq sk dh flops a slice (halved by a causal mask), at
// the H100's dense bf16 rate (989 TFLOP/s) or, in fp32, at the 3xTF32 rate
// (495 / 3 TFLOP/s).  This design runs 7: S and do.v^T are computed once
// for dk / dv and once more for dq, so that no sum needs atomics.
//
// Design (FlashAttention-2's split, without atomics, so every sum is in a
// fixed order and a run repeats bit for bit):
//   - flash_bwd_delta_kernel: D, one warp a row.
//   - dk / dv: one block a key tile, dk and dv in registers, walking the
//     query tiles that attend any of its keys; dq: one block a query tile,
//     dq in registers, walking the key tiles its rows attend (the forward's
//     range), last query blocks first.  Both recompute S and do.v^T.
//
// bf16: flash_bwd_dkdv_wgmma_kernel<DP, SPLIT> and
// flash_bwd_dq_wgmma_kernel<DP>, on the tensor cores (wgmma, hopper.cuh),
// two warpgroups a block, dh padded to DP in {64, 128, 224, 256}.
//   - dk / dv: K and V of the block's keys resident in shared memory (one
//     TMA request), Q and do in tiles of 64 rows by TMA into a 2-stage ring
//     on full / empty mbarriers, each tile's lse and D beside them (copied
//     by warp 0, which arrives on the same full barrier; a third stage
//     measured no faster).  Per tile and
//     warpgroup: S^T = K.Q^T and dP^T = V.do^T (m64n64k16, both operands
//     K-major from shared memory), P^T and dS^T on the accumulator
//     registers (masks only on tiles that straddle an edge), rounded once
//     to bf16 as the A fragments of dv += P^T.do and dk += dS^T.Q (A from
//     registers, B MN-major from shared memory, as the forward's P.V).
//     Rounding P and dS once holds 2e-2 of each gradient's largest
//     magnitude with room (tools/emulate_flash_bwd_bf16.py: worst 0.27 of
//     the bar; a high + low split, 0.25, would buy nothing).
//   - Registers decide the split.  At DP <= 128 each warpgroup owns 64 of
//     the block's 128 keys, and its dk and dv (DP / 2 registers each a
//     thread) sit beside S^T and dP^T (32 each).  At DP 224 / 256 dk and dv
//     alone would take 224-256, so (SPLIT) both warpgroups take the block's
//     64 keys and each computes S^T and dP^T in full but owns 128 columns of
//     dk and dv (the second's last 32 at DP 224 are zero padding and never
//     stored): 6 products instead of 4 for dk / dv, no spill.
//   - dq: Q and do of 128 rows resident, K and V in tiles of 64 keys by TMA
//     (K 2 stages; V 2 at DP <= 128, 1 above, for shared memory), S and dP
//     as the forward's S, dq += dS.K with K read MN-major from its tile.
//   - Rows TMA cannot read (dh % 8 != 0, or unaligned) are copied element
//     by element into the same swizzled tiles by every thread.
//
// fp32: flash_bwd_dkdv_tf32_kernel<DP, SPLIT> and flash_bwd_dq_tf32_kernel
// <DP>, on the tensor cores in 3xTF32 (mma.sync.m16n8k8.tf32, hopper.cuh:
// each operand split into a TF32 big and small part as it is read, three
// products each; near fp32 accuracy), dh padded to 64, 128 or 256.
//   - S and dP are the forward's sums term for term: S's operands split as
//     the forward's (split_tf32), dk / dv's S^T and dP^T with the cross
//     terms in the order of the forward's S and of dq's dP, so both kernels
//     and the forward see the same logits bit for bit.  The accumulations'
//     operands (P, dS, do, Q, K) are split rounding to nearest
//     (split_tf32_rn), which halves their TF32 error: train_exact holds
//     parameters after two AdamW steps to 1e-4, and an entry whose gradient
//     is near Adam's eps (1e-8) moves with the gradient's last bits
//     (PERF.md).
//   - dk / dv: 8 warps of 16 keys; K and V resident, Q, do, lse and D in
//     tiles of 32 rows (16 at DP 256) by cp.async, double-buffered, one
//     block barrier a tile.  At DP 256 (SPLIT) warps w and w + 4 share 16
//     keys and split dk's and dv's columns.
//   - dq: a warp 16 query rows (128 a block, 64 at DP 256), Q and do
//     resident, K and V tiles streamed as above.
//   - Tiles are [row][DP] floats with 8-float column groups XORed by
//     swz<SW_BOTH>: the 64-bit fragment loads of S (rows g, head dims 2t,
//     2t + 1) and the 32-bit loads of the accumulations (rows 2t, 2t + 1,
//     column g) both fall on distinct banks.  A warp skips the products of
//     a tile wholly masked for its rows.
//
// Every entry point launches on the caller's stream, allocates nothing
// (the caller passes D's buffer) and returns cudaGetLastError() (or the
// shared-memory opt-in's or the tensor maps' error).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int MAX_DH = 256;
constexpr int BT = 64;          // rows of a bf16 Q / do tile, keys of a K / V tile
constexpr float INF = __builtin_huge_valf();

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

// the knobs every body reads
struct Knobs {
  int sq, sk, causal, window, q_offset;
  float scale, softcap;
};

// does query row q attend key kpos?
__device__ __forceinline__ bool attends(const Knobs& kn, int q, int kpos) {
  const int qpos = kn.q_offset + q;
  return q < kn.sq && kpos < kn.sk && (!kn.causal || kpos <= qpos) &&
         (kn.window <= 0 || kpos > qpos - kn.window);
}

// The fp32 body's P and dS of one logit (s = q . k) from its row's lse and
// D and dP = do.v (the soft-cap's tanh is tanhf, as the fp32 forward's)
__device__ __forceinline__ void p_ds(const Knobs& kn, float s, float dp,
                                     float lse, float d, float& p,
                                     float& ds) {
  float t2, f = 1.f;
  if (kn.softcap > 0.f) {
    const float th = tanhf(s * (kn.scale / kn.softcap));
    t2 = kn.softcap * LOG2E * th;
    f = 1.f - th * th;
  } else {
    t2 = s * (kn.scale * LOG2E);
  }
  p = ex2(t2 - lse);
  ds = p * (dp - d) * kn.scale * f;
}

// a pair of adjacent outputs (cols col, col + 1 of a row of dh) from fp32;
// pairs: dh even and a 4-byte (bf16) / 8-byte (fp32) aligned base
__device__ __forceinline__ void store_pair(bf16* row, int col, int dh,
                                           float a, float b, int pairs) {
  if (pairs && col + 1 < dh) {
    *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(a, b);
    return;
  }
  if (col < dh) row[col] = __float2bfloat16(a);
  if (col + 1 < dh) row[col + 1] = __float2bfloat16(b);
}
__device__ __forceinline__ void store_pair(float* row, int col, int dh,
                                           float a, float b, int pairs) {
  if (pairs && col + 1 < dh) {
    *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
    return;
  }
  if (col < dh) row[col] = a;
  if (col + 1 < dh) row[col + 1] = b;
}

// ---------------------------------------------------------------- bf16 --

// The bf16 body's logits as its forward computes them (flash_attention.cu:
// t2 = s scale log2 e, or cap2 - 2 cap2 / (1 + 2^(s ucap)), i.e. cap2 tanh(u)
// from ex2.approx and rcp.approx), so that P = 2^(t2 - lse) meets the
// forward's log-sum-exp.
struct WgLogits {
  float sc2, ucap, cap2, scale;
  __device__ explicit WgLogits(const Knobs& kn)
      : sc2(kn.scale * LOG2E),
        ucap(kn.softcap > 0.f ? 2.f * kn.scale * LOG2E / kn.softcap : 0.f),
        cap2(kn.softcap * LOG2E), scale(kn.scale) {}
};

// P and dS of one logit s = q . k from dP = do . v, the row's lse and
// dsc = scale * D; CAP (soft-capped) is a template argument, so the kernels
// branch on it once a tile
template <bool CAP>
__device__ __forceinline__ void wg_p_ds(const WgLogits& c, float s, float dp,
                                        float lse, float dsc, float& p,
                                        float& ds) {
  if (CAP) {
    const float r = rcp(1.f + ex2(s * c.ucap));
    const float th = 1.f - 2.f * r;                  // tanh(s scale / cap)
    p = ex2(c.cap2 - 2.f * c.cap2 * r - lse);
    ds = p * fmaf(dp, c.scale, -dsc) * (1.f - th * th);
  } else {
    p = ex2(fmaf(s, c.sc2, -lse));
    ds = p * fmaf(dp, c.scale, -dsc);
  }
}

template <int DP, bool SPLIT>
struct WgBwd {
  static constexpr int ATOMS = (DP + 63) / 64; // 128-byte atom columns
  static constexpr int KS = DP / 16;           // k16 steps over the head dims
  static constexpr int ROW = ATOMS * 128;      // bytes of a row over its atoms
  static constexpr int KEYS = SPLIT ? 64 : 128;        // keys a dk / dv block
  static constexpr int NC = SPLIT ? ATOMS * 32 : DP;   // dk / dv columns a wg
  static constexpr int QST = 2;                        // dk / dv's Q stages
  static constexpr int VST = DP > 128 ? 1 : 2;         // dq's V stages
  // after 1024-byte alignment: K, V; QST stages of Q, do, lse, D; barriers
  static constexpr size_t DKDV_SMEM =
      1024 + 2 * KEYS * ROW + QST * (2 * BT * ROW + 2 * BT * 4) + 128;
  // after 1024-byte alignment: Q, do (128 rows); 2 K and VST V stages
  static constexpr size_t DQ_SMEM =
      1024 + 4 * BT * ROW + (2 + VST) * BT * ROW + 128;
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448,
                "a block may use 227 KB of shared memory");
  static_assert(NC == 64 || NC == 128 || NC == 224 || NC == 256,
                "wgmma_rs takes these widths");
};

template <int DP, bool SPLIT>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            Knobs kn, int dh, int tma, int pairs) {
  using S = WgBwd<DP, SPLIT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  unsigned char* ks = base;                          // [atoms][KEYS rows]
  unsigned char* vs = ks + S::KEYS * S::ROW;
  constexpr int QST = S::QST;
  unsigned char* qs = vs + S::KEYS * S::ROW;         // [QST][atoms][BT rows]
  unsigned char* dos = qs + QST * BT * S::ROW;
  float* lse_s = reinterpret_cast<float*>(dos + QST * BT * S::ROW);
  float* d_s = lse_s + QST * BT;             // lse, scale * D: [QST][BT]
  const uint32_t kv_full = smem_u32(d_s + QST * BT);
  const uint32_t full = kv_full + 8;                 // [QST]
  const uint32_t empty = full + 8 * QST;             // [QST]

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * S::KEYS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2;                           // fragment row
  const int t = lane & 3;                            // fragment column
  const int kw = SPLIT ? 0 : wg * WG_ROWS;           // the wg's first key row
  const int c0 = SPLIT ? wg * S::NC : 0;             // its first dk/dv column
  const int k_lo = k0 + kw + (warp & 3) * 16;        // this warp's keys
  const bf16* __restrict__ qb = q + bh * kn.sq * dh;
  const bf16* __restrict__ dob = dout + bh * kn.sq * dh;
  const float* __restrict__ lseb = lse + bh * kn.sq;
  const float* __restrict__ db = delta + bh * kn.sq;

  // query rows that may attend a key of this block, in whole tiles
  const int r_begin = kn.causal ? max(0, k0 - kn.q_offset) : 0;
  const int r_end = kn.window > 0
                        ? min(kn.sq, k0 + S::KEYS - 1 + kn.window -
                                         kn.q_offset)
                        : kn.sq;
  const int i_begin = r_begin / BT;
  const int n_tiles = r_end > r_begin ? (r_end + BT - 1) / BT - i_begin : 0;

  float dk_acc[S::NC / 2], dv_acc[S::NC / 2];
#pragma unroll
  for (int j = 0; j < S::NC / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
  const WgLogits lg(kn);

  // K and V land on kv_full; query tile i (Q, do, lse, D) on full[i % QST],
  // by TMA (thread 0: one box a 64-column atom and the expected bytes; warp
  // 0 copies lse and D and arrives: 33 arrivals) or element by element by
  // every thread, which then arrives.  A stage is refilled once every
  // thread has arrived on its "empty" barrier after its products read it.
  if (threadIdx.x == 0) {
    mbar_init(kv_full, tma ? 1 : WG_THREADS);
#pragma unroll
    for (int st = 0; st < QST; ++st) {
      mbar_init(full + 8 * st, tma ? 33 : WG_THREADS);
      mbar_init(empty + 8 * st, WG_THREADS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  auto load_kv = [&]() {
    if (tma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(kv_full, 2 * S::ATOMS * S::KEYS * 128);
#pragma unroll
        for (int at = 0; at < S::ATOMS; ++at) {
          tma_load(smem_u32(ks + at * S::KEYS * 128), &tk, kv_full, at * 64,
                   k0, static_cast<int>(bh));
          tma_load(smem_u32(vs + at * S::KEYS * 128), &tv, kv_full, at * 64,
                   k0, static_cast<int>(bh));
        }
      }
    } else {
      load_rows<DP, S::KEYS>(ks, k + bh * kn.sk * dh, k0, kn.sk, dh);
      load_rows<DP, S::KEYS>(vs, v + bh * kn.sk * dh, k0, kn.sk, dh);
      fence_async_smem();
      mbar_arrive(kv_full);
    }
  };
  // tile i into stage i % QST, once tile i - QST has left it
  auto load_q = [&](int i) {
    const int st = i % QST;
    const int q0 = (i_begin + i) * BT;
    unsigned char* qd = qs + st * BT * S::ROW;
    unsigned char* dd = dos + st * BT * S::ROW;
    const uint32_t bar = full + 8 * st;
    if (tma) {
      if (warp != 0) return;
      if (i >= QST) mbar_wait(empty + 8 * st, ((i - QST) / QST) & 1);
      if (lane == 0) {
        mbar_expect_tx(bar, 2 * S::ATOMS * BT * 128);
#pragma unroll
        for (int at = 0; at < S::ATOMS; ++at) {
          tma_load(smem_u32(qd + at * BT * 128), &tq, bar, at * 64, q0,
                   static_cast<int>(bh));
          tma_load(smem_u32(dd + at * BT * 128), &tdo, bar, at * 64, q0,
                   static_cast<int>(bh));
        }
      }
      for (int r = lane; r < BT; r += 32) {
        lse_s[st * BT + r] = q0 + r < kn.sq ? lseb[q0 + r] : INF;
        d_s[st * BT + r] = q0 + r < kn.sq ? db[q0 + r] * kn.scale : 0.f;
      }
      mbar_arrive(bar);
    } else {
      if (i >= QST) mbar_wait(empty + 8 * st, ((i - QST) / QST) & 1);
      load_rows<DP, BT>(qd, qb, q0, kn.sq, dh);
      load_rows<DP, BT>(dd, dob, q0, kn.sq, dh);
      for (int r = threadIdx.x; r < BT; r += WG_THREADS) {
        lse_s[st * BT + r] = q0 + r < kn.sq ? lseb[q0 + r] : INF;
        d_s[st * BT + r] = q0 + r < kn.sq ? db[q0 + r] * kn.scale : 0.f;
      }
      fence_async_smem();
      mbar_arrive(bar);
    }
  };

  // this warpgroup's K and V rows: K-major, 8-row groups 1024 bytes apart
  const uint32_t k_addr = smem_u32(ks) + kw * 128;
  const uint32_t v_addr = smem_u32(vs) + kw * 128;
  if (n_tiles > 0) {
    load_kv();
    load_q(0);
  }
  // Tile i: tile i + 1 is requested, S^T and dP^T are issued together and
  // awaited, P^T and dS^T become the A fragments, dv and dk's products are
  // issued and awaited, and the stage is freed.  Every warpgroup walks
  // every tile of the block's range, so the products are never issued
  // under a branch; a tile wholly masked for a warpgroup adds zeros.
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_q(i + 1);
    const int st = i % QST;
    const int q0 = (i_begin + i) * BT;
    if (i == 0) mbar_wait(kv_full, 0);
    mbar_wait(full + 8 * st, (i / QST) & 1);
    const uint32_t q_addr = smem_u32(qs + st * BT * S::ROW);
    const uint32_t do_addr = smem_u32(dos + st * BT * S::ROW);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk) {
      const uint32_t off = (kk >> 2) * S::KEYS * 128 + (kk & 3) * 32;
      const uint32_t offq = (kk >> 2) * BT * 128 + (kk & 3) * 32;
      wgmma_ss_n64(s, sw128_desc(k_addr + off, 16, 1024),
                   sw128_desc(q_addr + offq, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk) {
      const uint32_t off = (kk >> 2) * S::KEYS * 128 + (kk & 3) * 32;
      const uint32_t offq = (kk >> 2) * BT * 128 + (kk & 3) * 32;
      wgmma_ss_n64(dp, sw128_desc(v_addr + off, 16, 1024),
                   sw128_desc(do_addr + offq, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep_live(s);
    keep_live(dp);
    // s[4 i + 2 h + e]: key k_lo + g + 8 h, query q0 + 8 i + 2 t + e
    const bool edge = q0 + BT > kn.sq || k_lo + 16 > kn.sk ||
                      (kn.causal && k_lo + 15 > kn.q_offset + q0) ||
                      (kn.window > 0 &&
                       k_lo <= kn.q_offset + q0 + BT - 1 - kn.window);
    uint32_t pa[BT / 16][4], da[BT / 16][4];
    const auto p_ds_tile = [&](auto capped) {
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int qi = 8 * (j >> 2) + 2 * t;
        const int key = k_lo + g + 8 * ((j >> 1) & 1);
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + st * BT + qi);
        const float2 d2 = *reinterpret_cast<const float2*>(d_s + st * BT + qi);
        float p0, p1, ds0, ds1;
        wg_p_ds<decltype(capped)::value>(lg, s[j], dp[j], l2.x, d2.x, p0,
                                         ds0);
        wg_p_ds<decltype(capped)::value>(lg, s[j + 1], dp[j + 1], l2.y, d2.y,
                                         p1, ds1);
        if (edge) {
          if (!attends(kn, q0 + qi, key)) p0 = ds0 = 0.f;
          if (!attends(kn, q0 + qi + 1, key)) p1 = ds1 = 0.f;
        }
        pa[j >> 3][(j >> 1) & 3] = pack_bf16(p0, p1);
        da[j >> 3][(j >> 1) & 3] = pack_bf16(ds0, ds1);
      }
    };
    if (kn.softcap > 0.f)
      p_ds_tile(std::true_type{});
    else
      p_ds_tile(std::false_type{});
    // dv += P^T . do, dk += dS^T . Q: B MN-major (64-column atoms BT * 128
    // bytes apart, 8-row groups 1024 apart), from the wg's first column
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_rs<S::NC>(dv_acc, pa[kk],
                      sw128_desc(do_addr + (c0 / 64) * BT * 128 +
                                     kk * 16 * 128, BT * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_rs<S::NC>(dk_acc, da[kk],
                      sw128_desc(q_addr + (c0 / 64) * BT * 128 +
                                     kk * 16 * 128, BT * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    keep_live(pa);
    keep_live(da);
    keep_live(dv_acc);
    keep_live(dk_acc);
    mbar_arrive(empty + 8 * st);
  }

  // dk_acc[4 i + 2 h + e]: key k_lo + g + 8 h, column c0 + 8 i + 2 t + e
  bf16* __restrict__ dkb = dk + bh * kn.sk * dh;
  bf16* __restrict__ dvb = dv + bh * kn.sk * dh;
#pragma unroll
  for (int j = 0; j < S::NC / 2; j += 2) {
    const int row = k_lo + g + 8 * ((j >> 1) & 1);
    const int col = c0 + 8 * (j >> 2) + 2 * t;
    if (row >= kn.sk) continue;
    store_pair(dkb + static_cast<int64_t>(row) * dh, col, dh, dk_acc[j],
               dk_acc[j + 1], pairs);
    store_pair(dvb + static_cast<int64_t>(row) * dh, col, dh, dv_acc[j],
               dv_acc[j + 1], pairs);
  }
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, Knobs kn, int dh, int tma,
                          int pairs) {
  using S = WgBwd<DP, (DP > 128)>;
  constexpr int BQ = 2 * BT;                         // query rows a block
  constexpr int VST = S::VST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  unsigned char* qs = base;                          // [atoms][BQ rows]
  unsigned char* dos = qs + BQ * S::ROW;
  unsigned char* ks = dos + BQ * S::ROW;             // [2][atoms][BT rows]
  unsigned char* vs = ks + 2 * BT * S::ROW;          // [VST][atoms][BT rows]
  const uint32_t q_full = smem_u32(vs + VST * BT * S::ROW);
  const uint32_t k_full = q_full + 8, k_empty = q_full + 24;       // [2]
  const uint32_t v_full = q_full + 40, v_empty = v_full + 8 * VST; // [VST]

  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last blocks first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* __restrict__ kb = k + bh * kn.sk * dh;
  const bf16* __restrict__ vb = v + bh * kn.sk * dh;

  // keys any row of this block may attend, in whole tiles
  const int a_lo = kn.q_offset + q0;
  const int a_hi = kn.q_offset + min(q0 + BQ, kn.sq) - 1;
  const int kv_end = kn.causal ? min(kn.sk, a_hi + 1) : kn.sk;
  const int kv_begin = kn.window > 0 ? max(0, a_lo - kn.window + 1) : 0;
  const int t_begin = kv_begin / BT;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end + BT - 1) / BT - t_begin : 0;

  // this warp's 16 rows of the block
  const int wr = wg * WG_ROWS + (warp & 3) * 16;
  const int w_lo = kn.q_offset + q0 + wr;
  const int w_hi = kn.q_offset + min(q0 + wr + 15, kn.sq - 1);
  float lr[2], dr[2];                  // rows g, g + 8: lse, scale * D
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    lr[h] = row < kn.sq ? lse[bh * kn.sq + row] : INF;
    dr[h] = row < kn.sq ? delta[bh * kn.sq + row] * kn.scale : 0.f;
  }
  const WgLogits lg(kn);

  float acc[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;

  if (threadIdx.x == 0) {
    const int count = tma ? 1 : WG_THREADS;
    mbar_init(q_full, count);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full + 8 * st, count);
      mbar_init(k_empty + 8 * st, WG_THREADS);
    }
#pragma unroll
    for (int st = 0; st < VST; ++st) {
      mbar_init(v_full + 8 * st, count);
      mbar_init(v_empty + 8 * st, WG_THREADS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // a key tile (row0 on) into dst, onto barrier bar, once `empty` has
  // completed its phase of parity `parity` (no wait when empty is 0)
  auto load_tile = [&](unsigned char* dst, const CUtensorMap* map,
                       const bf16* __restrict__ src, uint32_t bar, int row0,
                       uint32_t empty, int parity) {
    if (tma) {
      if (threadIdx.x == 0) {
        if (empty) mbar_wait(empty, parity);
        mbar_expect_tx(bar, S::ATOMS * BT * 128);
#pragma unroll
        for (int at = 0; at < S::ATOMS; ++at)
          tma_load(smem_u32(dst + at * BT * 128), map, bar, at * 64, row0,
                   static_cast<int>(bh));
      }
    } else {
      if (empty) mbar_wait(empty, parity);
      load_rows<DP, BT>(dst, src, row0, kn.sk, dh);
      fence_async_smem();
      mbar_arrive(bar);
    }
  };
  auto load_k = [&](int i) {
    load_tile(ks + (i & 1) * BT * S::ROW, &tk, kb, k_full + 8 * (i & 1),
              (t_begin + i) * BT, i >= 2 ? k_empty + 8 * (i & 1) : 0,
              ((i - 2) >> 1) & 1);
  };
  auto load_v = [&](int i) {
    load_tile(vs + (i % VST) * BT * S::ROW, &tv, vb, v_full + 8 * (i % VST),
              (t_begin + i) * BT, i >= VST ? v_empty + 8 * (i % VST) : 0,
              ((i - VST) / VST) & 1);
  };

  // this warpgroup's Q and do rows: K-major, 8-row groups 1024 bytes apart
  const uint32_t q_addr = smem_u32(qs) + wg * WG_ROWS * 128;
  const uint32_t do_addr = smem_u32(dos) + wg * WG_ROWS * 128;
  if (n_tiles > 0) {
    if (tma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(q_full, 2 * S::ATOMS * BQ * 128);
#pragma unroll
        for (int at = 0; at < S::ATOMS; ++at) {
          tma_load(smem_u32(qs + at * BQ * 128), &tq, q_full, at * 64, q0,
                   static_cast<int>(bh));
          tma_load(smem_u32(dos + at * BQ * 128), &tdo, q_full, at * 64, q0,
                   static_cast<int>(bh));
        }
      }
    } else {
      load_rows<DP, BQ>(qs, q + bh * kn.sq * dh, q0, kn.sq, dh);
      load_rows<DP, BQ>(dos, dout + bh * kn.sq * dh, q0, kn.sq, dh);
      fence_async_smem();
      mbar_arrive(q_full);
    }
    load_k(0);
    load_v(0);
  }
  // Tile i: K_(i+1) is requested, S and dP are issued together and
  // awaited, V_i is freed and V_(i+1) requested, dS becomes the A
  // fragments of dq += dS.K, which is issued and awaited, and K_i is freed.
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_k(i + 1);
    const int k0 = (t_begin + i) * BT;
    if (i == 0) mbar_wait(q_full, 0);
    mbar_wait(k_full + 8 * (i & 1), (i >> 1) & 1);
    mbar_wait(v_full + 8 * (i % VST), (i / VST) & 1);
    const uint32_t k_addr = smem_u32(ks + (i & 1) * BT * S::ROW);
    const uint32_t v_addr = smem_u32(vs + (i % VST) * BT * S::ROW);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk) {
      const uint32_t offq = (kk >> 2) * BQ * 128 + (kk & 3) * 32;
      const uint32_t off = (kk >> 2) * BT * 128 + (kk & 3) * 32;
      wgmma_ss_n64(s, sw128_desc(q_addr + offq, 16, 1024),
                   sw128_desc(k_addr + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk) {
      const uint32_t offq = (kk >> 2) * BQ * 128 + (kk & 3) * 32;
      const uint32_t off = (kk >> 2) * BT * 128 + (kk & 3) * 32;
      wgmma_ss_n64(dp, sw128_desc(do_addr + offq, 16, 1024),
                   sw128_desc(v_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep_live(s);
    keep_live(dp);
    mbar_arrive(v_empty + 8 * (i % VST));
    if (i + 1 < n_tiles) load_v(i + 1);
    // s[4 i + 2 h + e]: row g + 8 h, key k0 + 8 i + 2 t + e
    const bool edge = k0 + BT > kn.sk || q0 + wr + 16 > kn.sq ||
                      (kn.causal && k0 + BT - 1 > w_lo) ||
                      (kn.window > 0 && k0 <= w_hi - kn.window);
    uint32_t da[BT / 16][4];
    const auto ds_tile = [&](auto capped) {
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int h = (j >> 1) & 1;
        const int key = k0 + 8 * (j >> 2) + 2 * t;
        const int row = q0 + wr + g + 8 * h;
        float p0, p1, ds0, ds1;
        wg_p_ds<decltype(capped)::value>(lg, s[j], dp[j], lr[h], dr[h], p0,
                                         ds0);
        wg_p_ds<decltype(capped)::value>(lg, s[j + 1], dp[j + 1], lr[h],
                                         dr[h], p1, ds1);
        if (edge) {
          if (!attends(kn, row, key)) ds0 = 0.f;
          if (!attends(kn, row, key + 1)) ds1 = 0.f;
        }
        da[j >> 3][(j >> 1) & 3] = pack_bf16(ds0, ds1);
      }
    };
    if (kn.softcap > 0.f)
      ds_tile(std::true_type{});
    else
      ds_tile(std::false_type{});
    // dq += dS . K: K MN-major (64-column atoms BT * 128 bytes apart)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_rs<DP>(acc, da[kk],
                   sw128_desc(k_addr + kk * 16 * 128, BT * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    keep_live(da);
    keep_live(acc);
    mbar_arrive(k_empty + 8 * (i & 1));
  }

  // acc[4 i + 2 h + e]: row q0 + wr + g + 8 h, column 8 i + 2 t + e
  bf16* __restrict__ dqb = dq + bh * kn.sq * dh;
#pragma unroll
  for (int j = 0; j < DP / 2; j += 2) {
    const int row = q0 + wr + g + 8 * ((j >> 1) & 1);
    if (row >= kn.sq) continue;
    store_pair(dqb + static_cast<int64_t>(row) * dh, 8 * (j >> 2) + 2 * t,
               dh, acc[j], acc[j + 1], pairs);
  }
}

// ---------------------------------------------------------------- fp32 --

template <int DP, bool SPLIT>
struct F32Bwd {
  static constexpr int T = DP > 128 ? 16 : 32;       // rows a streamed tile
  static constexpr int KEYS = SPLIT ? 64 : 128;      // keys a dk / dv block
  static constexpr int NC = SPLIT ? DP / 2 : DP;     // dk / dv columns a warp
  static constexpr int QROWS = DP > 128 ? 64 : 128;  // query rows a dq block
  static constexpr int DQ_THREADS = QROWS * 2;       // a warp each 16 rows
  // K, V; 2 buffers of Q, do; 2 of lse, D
  static constexpr size_t DKDV_SMEM =
      sizeof(float) * (2 * KEYS * DP + 4 * T * DP + 4 * T);
  // Q, do; 2 buffers of K, V
  static constexpr size_t DQ_SMEM =
      sizeof(float) * (2 * QROWS * DP + 4 * T * DP);
  static_assert(DP % 32 == 0, "the swizzle stays inside 32-column groups");
  static_assert(NC % 32 == 0, "a warp's columns start a 32-column group");
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448,
                "a block may use 227 KB of shared memory");
};

// the 8-column group an SW_BOTH tile's row r XORs its columns by
__device__ __forceinline__ int grp(int r) { return swz<SW_BOTH>(r) >> 3; }

// A lane's swizzled column offsets in an SW_BOTH tile, computed where used
// (no arrays: ptxas may rematerialize them): S's operands read head dims
// 2t, 2t + 1 of 8-column group p of rows g, g + 8 at xk(p); the
// accumulations' B reads column g of group p of row 2t at xv0(p), of row
// 2t + 1 at xv1(p)
struct LaneCols {
  int g, t, gk, gv0, gv1;
  __device__ explicit LaneCols(int lane)
      : g(lane >> 2), t(lane & 3), gk(grp(lane >> 2)),
        gv0(grp(2 * (lane & 3))), gv1(grp(2 * (lane & 3) + 1)) {}
  __device__ int xk(int p) const { return 8 * (p ^ gk) + 2 * t; }
  __device__ int xv0(int p) const { return 8 * (p ^ gv0) + g; }
  __device__ int xv1(int p) const { return 8 * (p ^ gv1) + g; }
};


// A fragment of rows r and r + 8 of a swizzled fp32 tile (row pointer a,
// row stride DP) at column c: the head dims of a k8 step in the order 2t,
// 2t + 1 (a permutation both operands of S share), one 64-bit load a row,
// split in 3xTF32 parts
template <int DP>
__device__ __forceinline__ void frag_a(const float* a, int c,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(a + c);
  const float2 hi = *reinterpret_cast<const float2*>(a + 8 * DP + c);
  split_tf32(lo.x, ab[0], as[0]);
  split_tf32(hi.x, ab[1], as[1]);
  split_tf32(lo.y, ab[2], as[2]);
  split_tf32(hi.y, ab[3], as[3]);
}
// B fragment of S: row r of a swizzled fp32 tile at column c (as frag_a)
__device__ __forceinline__ void frag_b(const float* b, int c,
                                       uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(b + c);
  split_tf32(x.x, bb[0], bs[0]);
  split_tf32(x.y, bb[1], bs[1]);
}
// x as a TF32 pair rounded to nearest (ties away from zero, as cvt.rna):
// big is x rounded to its top 10 mantissa bits, small = x - big (exact),
// |small| <= 2^-11 |x| against split_tf32's 2^-10, which halves the part of
// small that the tensor core's TF32 read drops.  For the operands of the
// accumulations dv, dk and dq; S and dP keep split_tf32 (the forward's).
__device__ __forceinline__ void split_tf32_rn(float x, uint32_t& big,
                                              uint32_t& small) {
  const uint32_t b = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  big = b;
  small = __float_as_uint(x - __uint_as_float(b));
}

// A fragment of an accumulation from an accumulator tile (rows g, g + 8,
// columns 2t, 2t + 1): the k8 step takes the columns in that order, so a
// B fragment reads rows 2t and 2t + 1
__device__ __forceinline__ void frag_acc(const float (&x)[4],
                                         uint32_t (&ab)[4],
                                         uint32_t (&as)[4]) {
  split_tf32_rn(x[0], ab[0], as[0]);
  split_tf32_rn(x[2], ab[1], as[1]);
  split_tf32_rn(x[1], ab[2], as[2]);
  split_tf32_rn(x[3], ab[3], as[3]);
}

// out[j] = rows g, g + 8 of a (pointer a) . rows 8 j + g of b (T rows,
// both swizzled fp32 tiles of stride DP) over the DP head dims: 16 x T.
// SWAPPED: a holds the rows that b holds in the transposed product (K.Q^T
// for the forward's Q.K^T, V.do^T for dq's do.V^T), and the two cross
// terms go in that product's order, so that each element is the same sum
// of the same terms: dk / dv's S^T equals the forward's S, and its dP^T
// equals dq's dP, bit for bit
template <int DP, int T, bool SWAPPED>
__device__ __forceinline__ void product_t(float (&out)[T / 8][4],
                                          const float* a, const float* b,
                                          const LaneCols& lc) {
#pragma unroll 4
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int c = 32 * (kk >> 2) + lc.xk(kk & 3);
    uint32_t ab[4], as[4];
    frag_a<DP>(a, c, ab, as);
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      uint32_t bb[2], bs[2];
      frag_b(b + (8 * j + lc.g) * DP, c, bb, bs);
      if (SWAPPED) {
        mma_tf32(out[j], ab, bs);
        mma_tf32(out[j], as, bb);
        mma_tf32(out[j], ab, bb);
      } else {
        mma_3xtf32(out[j], ab, as, bb, bs);
      }
    }
  }
}

// out[n] += A . (rows 2t, 2t + 1 of the tile b (stride DP) at columns c0 +
// 8 n + g), n < NC / 8
template <int DP, int NC>
__device__ __forceinline__ void acc_rows(float (&out)[NC / 8][4],
                                         const float (&x)[4], const float* b,
                                         int c0, const LaneCols& lc) {
  uint32_t ab[4], as[4];
  frag_acc(x, ab, as);
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    const int cb = c0 + 32 * (n >> 2);
    uint32_t bb[2], bs[2];
    split_tf32_rn(b[cb + lc.xv0(n & 3)], bb[0], bs[0]);
    split_tf32_rn(b[DP + cb + lc.xv1(n & 3)], bb[1], bs[1]);
    mma_3xtf32(out[n], ab, as, bb, bs);
  }
}

template <int DP, bool SPLIT>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_bwd_dkdv_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           Knobs kn, int dh, int vec) {
  using S = F32Bwd<DP, SPLIT>;
  constexpr int T = S::T;
  extern __shared__ __align__(16) float fsmem[];
  float* ks = fsmem;                                 // [KEYS][DP]
  float* vs = ks + S::KEYS * DP;
  float* ring = vs + S::KEYS * DP;                   // [2][Q, do][T][DP]
  float* ld_s = ring + 4 * T * DP;                   // [2][lse, D][T]

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * S::KEYS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kr = 16 * (SPLIT ? warp & 3 : warp);     // the warp's key rows
  const int c0 = SPLIT ? S::NC * (warp >> 2) : 0;    // and first column
  const int k_lo = k0 + kr;
  const int k_hi = min(k_lo + 15, kn.sk - 1);
  const bool w_keys = k_lo < kn.sk;
  const float* __restrict__ qb = q + bh * kn.sq * dh;
  const float* __restrict__ dob = dout + bh * kn.sq * dh;
  const float* __restrict__ lseb = lse + bh * kn.sq;
  const float* __restrict__ db = delta + bh * kn.sq;

  const int r_begin = kn.causal ? max(0, k0 - kn.q_offset) : 0;
  const int r_end = kn.window > 0
                        ? min(kn.sq, k0 + S::KEYS - 1 + kn.window -
                                         kn.q_offset)
                        : kn.sq;
  const int i_begin = r_begin / T;
  const int n_tiles = r_end > r_begin ? (r_end + T - 1) / T - i_begin : 0;

  const LaneCols lc(lane);

  float dk_acc[S::NC / 8][4], dv_acc[S::NC / 8][4];
#pragma unroll
  for (int n = 0; n < S::NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // tile i (Q, do by cp.async; lse, D by plain copies) into buffer i % 2,
  // one commit group; the block barrier at the top of each tile orders the
  // buffer's reuse
  auto issue = [&](int i) {
    const int b = i & 1;
    const int q0 = (i_begin + i) * T;
    float* dst = ring + b * 2 * T * DP;
    load_f32<DP, T, SW_BOTH>(dst, qb, q0, kn.sq, dh, vec);
    load_f32<DP, T, SW_BOTH>(dst + T * DP, dob, q0, kn.sq, dh, vec);
    for (int r = threadIdx.x; r < T; r += F_THREADS) {
      ld_s[b * 2 * T + r] = q0 + r < kn.sq ? lseb[q0 + r] : INF;
      ld_s[b * 2 * T + T + r] = q0 + r < kn.sq ? db[q0 + r] : 0.f;
    }
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_f32<DP, S::KEYS, SW_BOTH>(ks, k + bh * kn.sk * dh, k0, kn.sk, dh,
                                   vec);
    load_f32<DP, S::KEYS, SW_BOTH>(vs, v + bh * kn.sk * dh, k0, kn.sk, dh,
                                   vec);
    issue(0);
  }
  const float* ka = ks + (kr + g) * DP;              // rows g, g + 8
  const float* va = vs + (kr + g) * DP;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_tiles) issue(i + 1);
    const int q0 = (i_begin + i) * T;
    // warp-uniform: does a key of this warp attend a query of the tile?
    const bool live = w_keys &&
                      !(kn.causal && kn.q_offset + q0 + T - 1 < k_lo) &&
                      !(kn.window > 0 && kn.q_offset + q0 - kn.window >= k_hi);
    if (!live) continue;
    const float* qt = ring + (i & 1) * 2 * T * DP;
    const float* dot = qt + T * DP;
    const float* lt = ld_s + (i & 1) * 2 * T;
    // S^T = K . Q^T and dP^T = V . do^T, 16 keys x T queries a warp
    float s[T / 8][4], dp[T / 8][4];
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // (two passes, so that only one A operand is live beside dk and dv)
    product_t<DP, T, true>(s, ka, qt, lc);
    product_t<DP, T, true>(dp, va, dot, lc);
    // s[j][2 h + e]: key k_lo + g + 8 h, query q0 + 8 j + 2 t + e; P^T
    // replaces s, dS^T replaces dp
    const bool edge = q0 + T > kn.sq || k_lo + 16 > kn.sk ||
                      (kn.causal && k_lo + 15 > kn.q_offset + q0) ||
                      (kn.window > 0 &&
                       k_lo <= kn.q_offset + q0 + T - 1 - kn.window);
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        float p, ds;
        p_ds(kn, s[j][e], dp[j][e], lt[qi], lt[T + qi], p, ds);
        if (edge && !attends(kn, q0 + qi, k_lo + g + 8 * (e >> 1)))
          p = ds = 0.f;
        s[j][e] = p;
        dp[j][e] = ds;
      }
    // dv += P^T . do, then dk += dS^T . Q, over the tile's queries (one
    // after the other: P^T is dead before dk's products, which keeps the
    // DP 256 body from spilling)
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
      acc_rows<DP, S::NC>(dv_acc, s[j], dot + (8 * j + 2 * t) * DP, c0, lc);
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
      acc_rows<DP, S::NC>(dk_acc, dp[j], qt + (8 * j + 2 * t) * DP, c0, lc);
  }

  // dk_acc[n][2 h + e]: key k_lo + g + 8 h, column c0 + 8 n + 2 t + e
  float* __restrict__ dkb = dk + bh * kn.sk * dh;
  float* __restrict__ dvb = dv + bh * kn.sk * dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k_lo + g + 8 * h;
    if (row >= kn.sk) continue;
#pragma unroll
    for (int n = 0; n < S::NC / 8; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      store_pair(dkb + static_cast<int64_t>(row) * dh, col, dh,
                 dk_acc[n][2 * h], dk_acc[n][2 * h + 1], vec);
      store_pair(dvb + static_cast<int64_t>(row) * dh, col, dh,
                 dv_acc[n][2 * h], dv_acc[n][2 * h + 1], vec);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(F32Bwd<DP, (DP > 128)>::DQ_THREADS, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, Knobs kn, int dh, int vec) {
  using S = F32Bwd<DP, (DP > 128)>;
  constexpr int T = S::T;
  constexpr int R = S::QROWS;
  constexpr int NT = S::DQ_THREADS;
  extern __shared__ __align__(16) float fsmem[];
  float* qs = fsmem;                                 // [R][DP]
  float* dos = qs + R * DP;
  float* ring = dos + R * DP;                        // [2][K, V][T][DP]

  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;   // last blocks first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* __restrict__ kb = k + bh * kn.sk * dh;
  const float* __restrict__ vb = v + bh * kn.sk * dh;

  const int a_lo = kn.q_offset + q0;
  const int a_hi = kn.q_offset + min(q0 + R, kn.sq) - 1;
  const int kv_end = kn.causal ? min(kn.sk, a_hi + 1) : kn.sk;
  const int kv_begin = kn.window > 0 ? max(0, a_lo - kn.window + 1) : 0;
  const int t_begin = kv_begin / T;
  const int n_tiles = kv_end > kv_begin ? (kv_end + T - 1) / T - t_begin : 0;

  const int wr = warp * 16;                          // this warp's rows
  const bool w_rows = q0 + wr < kn.sq;
  const int w_lo = kn.q_offset + q0 + wr;
  const int w_hi = kn.q_offset + min(q0 + wr + 15, kn.sq - 1);
  float lr[2], dr[2];                                // rows g, g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    lr[h] = row < kn.sq ? lse[bh * kn.sq + row] : INF;
    dr[h] = row < kn.sq ? delta[bh * kn.sq + row] : 0.f;
  }
  const LaneCols lc(lane);

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  auto issue = [&](int i) {                          // K_i, V_i: buffer i % 2
    float* dst = ring + (i & 1) * 2 * T * DP;
    const int row0 = (t_begin + i) * T;
    load_f32<DP, T, SW_BOTH, NT>(dst, kb, row0, kn.sk, dh, vec);
    load_f32<DP, T, SW_BOTH, NT>(dst + T * DP, vb, row0, kn.sk, dh, vec);
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_f32<DP, R, SW_BOTH, NT>(qs, q + bh * kn.sq * dh, q0, kn.sq, dh, vec);
    load_f32<DP, R, SW_BOTH, NT>(dos, dout + bh * kn.sq * dh, q0, kn.sq, dh,
                                 vec);
    issue(0);
  }
  const float* qa = qs + (wr + g) * DP;              // rows g, g + 8
  const float* da = dos + (wr + g) * DP;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_tiles) issue(i + 1);
    const int k0 = (t_begin + i) * T;
    const bool live = w_rows && !(kn.causal && k0 > w_hi) &&
                      !(kn.window > 0 && k0 + T - 1 <= w_lo - kn.window);
    if (!live) continue;
    const float* kt = ring + (i & 1) * 2 * T * DP;
    const float* vt = kt + T * DP;
    // S = Q . K^T and dP = do . V^T, 16 rows x T keys a warp
    float s[T / 8][4], dp[T / 8][4];
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    product_t<DP, T, false>(s, qa, kt, lc);
    product_t<DP, T, false>(dp, da, vt, lc);
    // s[j][2 h + e]: row g + 8 h, key k0 + 8 j + 2 t + e; dS replaces dp
    const bool edge = k0 + T > kn.sk || q0 + wr + 16 > kn.sq ||
                      (kn.causal && k0 + T - 1 > w_lo) ||
                      (kn.window > 0 && k0 <= w_hi - kn.window);
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p, ds;
        p_ds(kn, s[j][e], dp[j][e], lr[h], dr[h], p, ds);
        if (edge && !attends(kn, q0 + wr + g + 8 * h,
                             k0 + 8 * j + 2 * t + (e & 1)))
          ds = 0.f;
        dp[j][e] = ds;
      }
    // dq += dS . K over the tile's keys
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
      acc_rows<DP, DP>(acc, dp[j], kt + (8 * j + 2 * t) * DP, 0, lc);
  }

  float* __restrict__ dqb = dq + bh * kn.sq * dh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= kn.sq) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      store_pair(dqb + static_cast<int64_t>(row) * dh, 8 * n + 2 * t, dh,
                 acc[n][2 * h], acc[n][2 * h + 1], vec);
  }
}

// ------------------------------------------------------------- launches --

// CUDA events the launches record around the three kernels when set
// (flash_attention_bwd_marks): before D, after D, after dk / dv, after dq.
// For timing the kernels apart; null (the default) records nothing.
cudaEvent_t marks[4] = {};

void mark(int i, cudaStream_t stream) {
  if (marks[i] != nullptr) cudaEventRecord(marks[i], stream);
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

void launch_delta(const void* o, const void* dout, float* delta, int64_t rows,
                  int dh, int is_bf16, cudaStream_t stream) {
  if (rows <= 0) return;
  const int warps = F_THREADS / 32;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + warps - 1) / warps),
                           F_THREADS, 0, stream>>>(o, dout, delta, rows, dh,
                                                   is_bf16);
}

template <int DP, bool SPLIT>
int launch_wgmma_bwd(const bf16* q, const bf16* k, const bf16* v,
                     const bf16* o, const bf16* dout, const float* lse,
                     float* delta, bf16* dq, bf16* dk, bf16* dv, int bh,
                     int dh, Knobs kn, cudaStream_t stream) {
  using S = WgBwd<DP, SPLIT>;
  const size_t dkdv_smem = S::DKDV_SMEM, dq_smem = S::DQ_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<DP, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkdv_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // TMA reads rows of whole 16-byte units from 16-byte aligned bases; any
  // other input is read element by element
  const int tma = kn.sq > 0 && kn.sk > 0 && dh % 8 == 0 && aligned(q, 16) &&
                  aligned(k, 16) && aligned(v, 16) && aligned(dout, 16);
  const int pairs = dh % 2 == 0 && aligned(dq, 4) && aligned(dk, 4) &&
                    aligned(dv, 4);
  // dk / dv: Q and do in boxes of BT rows, K and V of KEYS; dq: Q and do
  // of 2 BT, K and V of BT
  CUtensorMap q_t = {}, do_t = {}, k_b = {}, v_b = {};
  CUtensorMap q_b = {}, do_b = {}, k_t = {}, v_t = {};
  if (tma) {
    int bad = tensor_map(&q_t, q, bh, kn.sq, dh, BT);
    if (!bad) bad = tensor_map(&do_t, dout, bh, kn.sq, dh, BT);
    if (!bad) bad = tensor_map(&k_b, k, bh, kn.sk, dh, S::KEYS);
    if (!bad) bad = tensor_map(&v_b, v, bh, kn.sk, dh, S::KEYS);
    if (!bad) bad = tensor_map(&q_b, q, bh, kn.sq, dh, 2 * BT);
    if (!bad) bad = tensor_map(&do_b, dout, bh, kn.sq, dh, 2 * BT);
    if (!bad) bad = tensor_map(&k_t, k, bh, kn.sk, dh, BT);
    if (!bad) bad = tensor_map(&v_t, v, bh, kn.sk, dh, BT);
    if (bad) return bad;
  }
  mark(0, stream);
  launch_delta(o, dout, delta, static_cast<int64_t>(bh) * kn.sq, dh, 1,
               stream);
  mark(1, stream);
  if (kn.sk > 0) {
    const dim3 grid(bh, (kn.sk + S::KEYS - 1) / S::KEYS);
    flash_bwd_dkdv_wgmma_kernel<DP, SPLIT>
        <<<grid, WG_THREADS, dkdv_smem, stream>>>(
            q_t, k_b, v_b, do_t, q, k, v, dout, lse, delta, dk, dv, kn, dh,
            tma, pairs);
  }
  mark(2, stream);
  if (kn.sq > 0) {
    const dim3 grid(bh, (kn.sq + 2 * BT - 1) / (2 * BT));
    flash_bwd_dq_wgmma_kernel<DP><<<grid, WG_THREADS, dq_smem, stream>>>(
        q_b, k_t, v_t, do_b, q, k, v, dout, lse, delta, dq, kn, dh, tma,
        pairs);
  }
  mark(3, stream);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool SPLIT>
int launch_tf32_bwd(const float* q, const float* k, const float* v,
                    const float* o, const float* dout, const float* lse,
                    float* delta, float* dq, float* dk, float* dv, int bh,
                    int dh, Knobs kn, cudaStream_t stream) {
  using S = F32Bwd<DP, SPLIT>;
  const size_t dkdv_smem = S::DKDV_SMEM, dq_smem = S::DQ_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_tf32_kernel<DP, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkdv_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies need rows of whole 16-byte units from aligned bases
  const int vec = dh % 4 == 0 && aligned(q, 16) && aligned(k, 16) &&
                  aligned(v, 16) && aligned(dout, 16) && aligned(dq, 16) &&
                  aligned(dk, 16) && aligned(dv, 16);
  mark(0, stream);
  launch_delta(o, dout, delta, static_cast<int64_t>(bh) * kn.sq, dh, 0,
               stream);
  mark(1, stream);
  if (kn.sk > 0) {
    const dim3 grid(bh, (kn.sk + S::KEYS - 1) / S::KEYS);
    flash_bwd_dkdv_tf32_kernel<DP, SPLIT>
        <<<grid, F_THREADS, dkdv_smem, stream>>>(q, k, v, dout, lse, delta,
                                                 dk, dv, kn, dh, vec);
  }
  mark(2, stream);
  if (kn.sq > 0) {
    const dim3 grid(bh, (kn.sq + S::QROWS - 1) / S::QROWS);
    flash_bwd_dq_tf32_kernel<DP><<<grid, S::DQ_THREADS, dq_smem, stream>>>(
        q, k, v, dout, lse, delta, dq, kn, dh, vec);
  }
  mark(3, stream);
  return static_cast<int>(cudaGetLastError());
}

// the arguments both entry points take; 0 means launch, else the error
int check_args(int bh, int sq, int sk, int dh) {
  if (dh < 1 || dh > MAX_DH || bh < 0 || bh > 65535 || sq < 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// q, o, do, dq (bh, sq, dh); k, v, dk, dv (bh, sk, dh), all contiguous
// fp32; lse (bh, sq) the forward's base-2 log-sum-exp; delta (bh, sq) fp32
// scratch for D.  causal 0/1, window 0 = none, softcap 0 = none.  On the
// tensor cores in 3xTF32, dh padded to 64, 128 or 256.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int bh, int sq, int sk,
                            int dh, float scale, int causal, int window,
                            float softcap, int q_offset, void* stream) {
  if (const int bad = check_args(bh, sq, sk, dh)) return bad;
  if (bh == 0) return 0;
  const Knobs kn{sq, sk, causal, window, q_offset, scale, softcap};
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* op = static_cast<const float*>(o);
  const auto* dop = static_cast<const float*>(dout);
  auto* dqp = static_cast<float*>(dq);
  auto* dkp = static_cast<float*>(dk);
  auto* dvp = static_cast<float*>(dv);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch_tf32_bwd<64, false>(qp, kp, vp, op, dop, lse, delta, dqp,
                                      dkp, dvp, bh, dh, kn, st);
  if (dh <= 128)
    return launch_tf32_bwd<128, false>(qp, kp, vp, op, dop, lse, delta, dqp,
                                       dkp, dvp, bh, dh, kn, st);
  return launch_tf32_bwd<256, true>(qp, kp, vp, op, dop, lse, delta, dqp,
                                    dkp, dvp, bh, dh, kn, st);
}

// The same over bf16 tensors (fp32 lse, delta and accumulation), on the
// tensor cores with wgmma, dh padded to 64, 128, 224 or 256.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int bh, int sq, int sk,
                             int dh, float scale, int causal, int window,
                             float softcap, int q_offset, void* stream) {
  if (const int bad = check_args(bh, sq, sk, dh)) return bad;
  if (bh == 0) return 0;
  const Knobs kn{sq, sk, causal, window, q_offset, scale, softcap};
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* op = static_cast<const bf16*>(o);
  const auto* dop = static_cast<const bf16*>(dout);
  auto* dqp = static_cast<bf16*>(dq);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch_wgmma_bwd<64, false>(qp, kp, vp, op, dop, lse, delta, dqp,
                                       dkp, dvp, bh, dh, kn, st);
  if (dh <= 128)
    return launch_wgmma_bwd<128, false>(qp, kp, vp, op, dop, lse, delta, dqp,
                                        dkp, dvp, bh, dh, kn, st);
  if (dh <= 224)
    return launch_wgmma_bwd<224, true>(qp, kp, vp, op, dop, lse, delta, dqp,
                                       dkp, dvp, bh, dh, kn, st);
  return launch_wgmma_bwd<256, true>(qp, kp, vp, op, dop, lse, delta, dqp,
                                     dkp, dvp, bh, dh, kn, st);
}

// Timing only: the four CUDA events (cudaEvent_t, or all null to stop)
// that each later launch records before D, after D, after dk / dv and
// after dq, on its stream.
int flash_attention_bwd_marks(void* e0, void* e1, void* e2, void* e3) {
  void* const events[4] = {e0, e1, e2, e3};
  for (int i = 0; i < 4; ++i) marks[i] = static_cast<cudaEvent_t>(events[i]);
  return 0;
}

// Dynamic shared memory (bytes) the largest backward kernel at head dim dh
// takes (the bf16 and fp32 bodies' dk / dv and dq kernels).
int flash_attention_bwd_smem(int dh) {
  size_t most = 0;
  const auto take = [&most](size_t a, size_t b) {
    most = most > a ? most : a;
    most = most > b ? most : b;
  };
  if (dh <= 64) {
    take(WgBwd<64, false>::DKDV_SMEM, WgBwd<64, false>::DQ_SMEM);
    take(F32Bwd<64, false>::DKDV_SMEM, F32Bwd<64, false>::DQ_SMEM);
  } else if (dh <= 128) {
    take(WgBwd<128, false>::DKDV_SMEM, WgBwd<128, false>::DQ_SMEM);
    take(F32Bwd<128, false>::DKDV_SMEM, F32Bwd<128, false>::DQ_SMEM);
  } else {
    if (dh <= 224)
      take(WgBwd<224, true>::DKDV_SMEM, WgBwd<224, true>::DQ_SMEM);
    else
      take(WgBwd<256, true>::DKDV_SMEM, WgBwd<256, true>::DQ_SMEM);
    take(F32Bwd<256, true>::DKDV_SMEM, F32Bwd<256, true>::DQ_SMEM);
  }
  return static_cast<int>(most);
}

}  // extern "C"
