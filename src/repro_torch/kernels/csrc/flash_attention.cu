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
// stored in the input type (fp32 or bf16).  Heads arrive already
// GQA-repeated, as in the reference.  Two bodies, one per input type; each
// entry point launches only its own, with no fallback between them.
//
// bf16: flash_attention_wgmma_kernel<DP>, on the tensor cores.
//
// Bound: operations.  At the prefill shape (1, 16, 8192, 224) the attended
// (query, key) pairs need 4*h*pairs*dh = 481 GFLOP causal and 361 GFLOP at
// window 4096: 0.486 / 0.365 ms at the H100's 989 TFLOP/s dense bf16 peak,
// against 235 MB of q, k, v and o (0.07 ms at 3.35 TB/s).  Beside it sits
// the special-function (MUFU) floor: the softmax's exp2 and the soft-cap's
// exp2 and reciprocal are three MUFU operations a pair, 537 M pairs a
// global layer at 16 a clock per SM: ~0.4 ms.
//
// Design (FA3's structure, without a producer warpgroup):
//   - One 256-thread block of two warpgroups owns 128 query rows of one
//     slice, 64 a warpgroup; each keeps its 64 x DP fp32 output (DP/2
//     registers a thread), running max and sum in registers.  dh is padded
//     to DP in {64, 128, 224, 256}; tiles live in shared memory in the
//     128-byte-swizzle layout wgmma's descriptors read, in 64-column atoms
//     (dh = 224 fills 3.5 of 4; the rest is never read).
//   - S = Q.K^T is wgmma.m64n64k16 with Q and K from shared memory (both
//     K-major); O += P.V is wgmma.m64nDPk16 with P from registers (the
//     m64n64 accumulator of S is the A fragment of two k16 steps) and V
//     from shared memory, MN-major (transposed B).
//   - Keys go in tiles of 64.  Thread 0 requests each tile by TMA (a 3-D
//     tensor map per input, one box a 64-column atom, zero past sk and dh)
//     onto the stage's "full" mbarrier; K has 2 stages and V 3, and a stage
//     is refilled once every thread has arrived on its "empty" mbarrier
//     after its warpgroup's product read it, so the warpgroups never wait
//     on each other at a block barrier.  Rows TMA cannot read (dh % 8 != 0,
//     or unaligned) are copied element by element into the same tiles by
//     every thread, which then arrives.  225 KB of shared memory at DP 224.
//   - Each warpgroup issues S of tile i and P.V of tile i - 1 together and
//     runs the softmax of tile i while the tensor cores do that P.V;
//     the warpgroups take turns issuing S (two named barriers, one each
//     way, as in FA3's ping-pong), so that each one's softmax also runs
//     under the other's products.  Named barriers have no timeout: the
//     two-way hand-off is what keeps each warpgroup within one turn of
//     the other, so that neither can complete a barrier's phase alone.
//     The products are never issued under a branch (ptxas would serialize
//     them): every warpgroup processes every key tile of the block's
//     range, and a tile wholly masked for its rows is the identity update.
//   - The softmax runs in base 2 on the accumulator registers (log2(e)
//     folded into the scale, exp2 as ex2.approx), and the soft-cap's
//     tanh(u) as 1 - 2 / (1 + 2^(2u log2 e)) from ex2.approx and
//     rcp.approx: absolute error ~1e-7 in tanh, where tanh.approx's ~5e-4
//     would move a logit capped at 50 by 0.025.
//   - P is split into a bf16 high part and a bf16 low part (P - high) and
//     both are multiplied: a single rounding of P moves an output with few
//     attended keys by up to ~2^-9 of the spread of its V rows, beyond the
//     one-bf16-rounding check, while the split leaves ~2^-17.  The row sum
//     l is taken from P in fp32.  The split costs one more P.V product:
//     1.5x the tensor work of the bound.
//   - Masking only where it applies: key tiles wholly masked for the block
//     are never loaded, and the causal, window and sk masks are evaluated
//     only on tiles that straddle one of their edges (per warp).  A masked
//     logit is the -1e30 sentinel, and a row with no attended key yet
//     exponentiates against 0 instead of its max, so its probabilities are
//     exactly 0.
//   - Blocks are ordered with the last query blocks first (grid y reversed,
//     slices along x), so the causal tail does not idle the card.
//   - The epilogue normalizes, rounds to bf16, stages each warp's rows in
//     its own Q rows of shared memory and stores 16-byte chunks.
//
// fp32: flash_attention_tf32_kernel<DP>, on the tensor cores in 3xTF32.
//
// Bound: operations.  One TF32 rounding of the operands (10 mantissa bits)
// would not hold the reference's 5e-4, so each product runs as three:
// with x = big + small (big x's top 10 mantissa bits, small = x - big), a.b
// = as.bb + ab.bs + ab.bb (the dropped as.bs and small's own rounding are
// ~2^-20 relative), near fp32 accuracy.  At (1, 16, 8192, 224) causal that
// is 3 x 481 GFLOP at the 495 TFLOP/s dense TF32 peak: 2.92 ms, the bound
// of this design (the fp32-FMA bound of the same attention is 7.18 ms at
// 67 TFLOP/s), with the MUFU floor (~0.13 ms: one ex2 a pair at soft-cap 0)
// beside it.
//
// Design (mma.sync.m16n8k8.tf32, not wgmma: TF32 wgmma reads both operands
// K-major from shared memory or A from registers, so the split halves of
// K and V would need their own tiles (V transposed) and twice the shared
// memory of an fp32 tile that already fills 227 KB at dh 224; the warp-level
// product takes each operand's halves from registers, split as it loads):
//   - One 256-thread block of 8 warps owns 128 query rows of one slice, 16
//     a warp; each warp keeps its 16 x DP fp32 output (DP/2 registers a
//     thread), running max and sum in registers.  dh is padded to DP in
//     {64, 128, 224, 256}.  Q sits in shared memory for the whole block.
//   - Keys go in tiles of 32.  K_0, V_0, K_1, V_1, ... stream through a ring
//     of 3 tiles by 16-byte cp.async copies, two entries ahead of the
//     product that reads them (element copies where dh % 4 != 0 or a base
//     is unaligned).  Tiles are [row][DP] with 32-byte column groups
//     swizzled by the row, so every fragment load is free of bank
//     conflicts.  128 x 224 fp32 Q and 3 tiles: 196 KB.
//   - Each operand is split as it is read from shared memory (two
//     instructions: a mask and a subtraction) and each product is three
//     mma.sync.  S = Q.K^T permutes the head dims of each k8 step to 2t,
//     2t + 1 in both operands, so every Q and K fragment is one 64-bit
//     load.  P.V takes the keys in the order S's accumulator holds them
//     (a thread's columns 2t, 2t + 1 are A's k-columns t and t + 4), so P
//     goes from the accumulator to the A fragment with no shuffle and V's
//     B fragment reads rows 2t, 2t + 1.
//   - The softmax is the bf16 body's (base 2, ex2.approx, the sentinel,
//     masks only on tiles that straddle an edge of this warp's rows; a warp
//     skips the products of a tile wholly masked for its rows, the identity
//     update), but the soft-cap is softcap * tanhf(s / softcap).  The bf16
//     body's 1 - 2 / (1 + 2^(2u log2 e)) subtracts two numbers near the cap:
//     its error is absolute, ~1e-5 of a logit at cap 50 even with exact
//     exp2 and reciprocal, where tanhf's is relative (~2 ulp), and that
//     difference, carried through the layers, is what an fp32 model's
//     logits show.
//   - Blocks are ordered with the last query blocks first (grid y reversed).
//   - The epilogue normalizes and stores each thread's column pairs.
//
// The Hopper machinery both flash sources use (swizzled tiles, mbarriers,
// TMA, the wgmma and 3xTF32 mma.sync products, cp.async) is in hopper.cuh.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or the shared-memory opt-in's error) so the
// Python wrapper can raise on a refused launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float FA_NEG = -1e30f;               // the reference's sentinel
constexpr int FA_MAX_DH = 256;

// The epilogue's log-sum-exp of rows row and row + 8 (base 2: the running
// max m plus log2 of the row sum l, both quad-uniform by then) for the
// backward kernels (csrc/flash_attention_bwd.cu); +inf where a row attends
// no key, so that its probabilities 2^(t - lse) are 0 there.  Written by
// one thread of the quad, only when the caller passes a buffer.
__device__ __forceinline__ void write_lse(float* __restrict__ lse, int row,
                                          int sq, const float (&m)[2],
                                          const float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (row + 8 * h < sq)
      lse[row + 8 * h] =
          l[h] > 0.f ? m[h] + log2f(l[h]) : __int_as_float(0x7f800000);
}

// ---------------------------------------------------------------- bf16 --

constexpr int WG_BQ = WG_GROUPS * WG_ROWS;     // 128 query rows per block
constexpr int WG_BK = 64;                      // keys per tile

template <int DP>
struct WgShape {
  static constexpr int KS = DP / 16;           // k16 steps of Q.K^T
  static constexpr int CH = DP / 8;            // 16-byte chunks filled a row
  static constexpr int ATOMS = (DP + 63) / 64; // 128-byte atom columns
  static constexpr int Q_BYTES = WG_BQ * ATOMS * 128;
  static constexpr int KV_BYTES = WG_BK * ATOMS * 128;
  // after 1024-byte alignment: Q, 2 K stages, 3 V stages, 11 barriers
  static constexpr size_t SMEM = 1024 + Q_BYTES + 5 * KV_BYTES + 128;
  static_assert(SMEM <= 232448, "a block may use 227 KB of shared memory");
};

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             float* __restrict__ lse, int sq, int sk, int dh,
                             float scale, int causal, int window,
                             float softcap, int q_offset, int tma) {
  using S = WgShape<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1024-byte aligned tiles: Q [atoms][128 rows], then 2 K stages and 3 V
  // stages, then the barriers: Q's, each stage's "full" and "empty"
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  unsigned char* qs = base;
  unsigned char* ks = qs + S::Q_BYTES;
  unsigned char* vs = ks + 2 * S::KV_BYTES;
  const uint32_t q_full = smem_u32(vs + 3 * S::KV_BYTES);
  const uint32_t k_full = q_full + 8, v_full = q_full + 24;    // [2], [3]
  const uint32_t k_empty = q_full + 48, v_empty = q_full + 64; // [2], [3]

  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;   // last blocks first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;                               // warpgroup
  const int g = lane >> 2;                                // fragment row
  const int t = lane & 3;                                 // fragment column
  const bf16* __restrict__ qb = q + bh * sq * dh;
  const bf16* __restrict__ kb = k + bh * sk * dh;
  const bf16* __restrict__ vb = v + bh * sk * dh;
  bf16* __restrict__ ob = o + bh * sq * dh;

  // keys any row of this block may attend, in whole tiles
  const int a_lo = q_offset + q0;
  const int a_hi = q_offset + min(q0 + WG_BQ, sq) - 1;
  const int kv_end = causal ? min(sk, a_hi + 1) : sk;
  const int kv_begin = window > 0 ? max(0, a_lo - window + 1) : 0;
  const int t_begin = kv_begin / WG_BK;
  const int t_end = kv_end > kv_begin ? (kv_end + WG_BK - 1) / WG_BK
                                      : t_begin;

  // this warp's 16 rows of the block
  const int wr = wg * WG_ROWS + (warp & 3) * 16;          // block row
  const int w_lo = q_offset + q0 + wr;
  const int w_hi = q_offset + min(q0 + wr + 15, sq - 1);
  const int qpos0 = w_lo + g;                             // rows g and g + 8

  // base-2 logits: t2 = s * sc2, or cap2 - 2 cap2 / (1 + 2^(s * ucap))
  const float sc2 = scale * LOG2E;
  const float ucap = softcap > 0.f ? 2.f * scale * LOG2E / softcap : 0.f;
  const float cap2 = softcap * LOG2E;

  float acc[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
  float m[2] = {FA_NEG, FA_NEG};
  float l[2] = {0.f, 0.f};
  // this warpgroup's Q rows: K-major, 8-row groups 1024 bytes apart
  const uint32_t q_addr = smem_u32(qs) + wg * WG_ROWS * 128;
  const int n_tiles = t_end - t_begin;

  // S = Q . K^T for the tile in K stage `st` (64 x 64 a warpgroup, both
  // K-major), issued and committed
  auto issue_s = [&](float (&s)[32], int st) {
    const uint32_t k_addr = smem_u32(ks + st * S::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n64(
          s, sw128_desc(q_addr + (kk >> 2) * WG_BQ * 128 + off, 16, 1024),
          sw128_desc(k_addr + (kk >> 2) * WG_BK * 128 + off, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
  };
  // P of a tile, high and low bf16 parts as A fragments (key step kk holds
  // accumulator tiles 2 kk and 2 kk + 1)
  uint32_t hi[WG_BK / 16][4], lo[WG_BK / 16][4];
  // O += P . V for the tile in V stage `st` (MN-major: 64-column atoms
  // 64 * 128 bytes apart, 8-key groups 1024 bytes apart), issued and
  // committed
  auto issue_pv = [&](int st) {
    const uint32_t v_addr = smem_u32(vs + st * S::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      const uint64_t dv =
          sw128_desc(v_addr + kk * 16 * 128, WG_BK * 128, 1024);
      wgmma_rs<DP>(acc, hi[kk], dv);
      wgmma_rs<DP>(acc, lo[kk], dv);
    }
    wgmma_commit();
  };
  // the online softmax of a tile's logits in s (base 2, soft-capped,
  // masked where the tile straddles a mask's edge): s becomes P, l and m
  // are updated, and the factor O must be scaled by is returned in alpha.
  // A wholly masked tile is the identity (P = 0, alpha = 1).
  auto softmax = [&](float (&s)[32], int k0, float (&alpha)[2]) {
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        s[j] = cap2 - 2.f * cap2 * rcp(1.f + ex2(s[j] * ucap));
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= sc2;
    }
    const bool masked = k0 + WG_BK > sk ||
                        (causal && k0 + WG_BK - 1 > w_lo) ||
                        (window > 0 && k0 <= w_hi - window);
    if (masked) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        // s[4 i + e]: row g + 8 (e / 2), key 8 i + 2 t + e % 2
        const int kpos = k0 + (j >> 2) * 8 + 2 * t + (j & 1);
        const int qpos = qpos0 + ((j >> 1) & 1) * 8;
        const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        if (!ok) s[j] = FA_NEG;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    float base2[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no attended key yet: masked logits (the sentinel)
      // exponentiate against 0, so they give exactly 0
      base2[r] = mx[r] == FA_NEG ? 0.f : mx[r];
      alpha[r] = ex2(m[r] - base2[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = ex2(s[j] - base2[(j >> 1) & 1]);
      rsum[(j >> 1) & 1] += s[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rsum[r];
  };
  // O *= alpha, then P (in s) into its bf16 fragments
  auto rescale_and_split = [&](const float (&s)[32], const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], hi[kk][j],
                   lo[kk][j]);
  };
  // Each tile lands on its stage's "full" barrier: by TMA (thread 0 issues
  // one box a 64-column atom and the expected bytes), or element by element
  // by every thread, which then arrives.  K of tile i sits in stage i % 2
  // and V in stage i % 3; a stage's n-th fill completes its barrier's n-th
  // phase, so the wait has parity n % 2.  Every thread arrives on the
  // stage's "empty" barrier once its warpgroup's product has read it, and
  // a stage is refilled once both warpgroups have.
  if (threadIdx.x == 0) {
    const int count = tma ? 1 : WG_THREADS;
    mbar_init(q_full, count);
#pragma unroll
    for (int st = 0; st < 3; ++st) {
      if (st < 2) mbar_init(k_full + 8 * st, count);
      if (st < 2) mbar_init(k_empty + 8 * st, WG_THREADS);
      mbar_init(v_full + 8 * st, count);
      mbar_init(v_empty + 8 * st, WG_THREADS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // fill dst once the barrier `empty` has completed its phase of parity
  // `parity` (no wait when empty is 0)
  auto load = [&](unsigned char* dst, const CUtensorMap* map,
                  const bf16* __restrict__ src, uint32_t bar, int row0,
                  int n_rows, auto rows, uint32_t empty, int parity) {
    constexpr int ROWS = decltype(rows)::value;
    if (tma) {
      if (threadIdx.x == 0) {
        if (empty) mbar_wait(empty, parity);
        mbar_expect_tx(bar, S::ATOMS * ROWS * 128);
#pragma unroll
        for (int at = 0; at < S::ATOMS; ++at)
          tma_load(smem_u32(dst + at * ROWS * 128), map, bar, at * 64, row0,
                   static_cast<int>(bh));
      }
    } else {
      if (empty) mbar_wait(empty, parity);
      load_rows<DP, ROWS>(dst, src, row0, n_rows, dh);
      fence_async_smem();
      mbar_arrive(bar);
    }
  };
  using Tile = std::integral_constant<int, WG_BK>;
  auto load_k = [&](int i) {
    load(ks + (i & 1) * S::KV_BYTES, &tk, kb, k_full + 8 * (i & 1),
         (t_begin + i) * WG_BK, sk, Tile{}, i >= 2 ? k_empty + 8 * (i & 1) : 0,
         ((i - 2) >> 1) & 1);
  };
  auto load_v = [&](int i) {
    load(vs + (i % 3) * S::KV_BYTES, &tv, vb, v_full + 8 * (i % 3),
         (t_begin + i) * WG_BK, sk, Tile{}, i >= 3 ? v_empty + 8 * (i % 3) : 0,
         ((i - 3) / 3) & 1);
  };
  auto wait_k = [&](int i) { mbar_wait(k_full + 8 * (i & 1), (i >> 1) & 1); };
  auto wait_v = [&](int i) { mbar_wait(v_full + 8 * (i % 3), (i / 3) & 1); };
  auto free_k = [&](int i) { mbar_arrive(k_empty + 8 * (i & 1)); };
  auto free_v = [&](int i) { mbar_arrive(v_empty + 8 * (i % 3)); };

  // Tile 0: Q, K_0, K_1 and V_0 are requested; S_0 and its softmax.
  // Tile i > 0: K_(i+1) and V_i are requested, S_i and the previous tile's
  // P.V are issued together, and the softmax of tile i runs while the
  // tensor cores do that P.V.  The warpgroups take turns: warpgroup 1
  // issues S_i once warpgroup 0's S_i is done (barrier 1), and warpgroup 0
  // issues S_(i+1) once warpgroup 1's S_i is done (barrier 2), so that
  // their softmaxes alternate and neither reaches a named barrier twice
  // before the other has reached it once.  Each barrier's arrivals and
  // waits pair up one to one (1..n-1 on barrier 1, 1..n-2 against 2..n-1
  // on barrier 2), so no phase is left open at exit.  Every warpgroup
  // processes every tile of the block's range, so the products are never
  // issued under a branch.
  if (n_tiles > 0) {
    load(qs, &tq, qb, q_full, q0, sq, std::integral_constant<int, WG_BQ>{}, 0,
         0);
    load_k(0);
    if (n_tiles > 1) load_k(1);
    load_v(0);
    mbar_wait(q_full, 0);
    wait_k(0);
    float s[32], alpha[2];
    wgmma_fence();
    issue_s(s, 0);
    wgmma_wait<0>();
    free_k(0);
    softmax(s, t_begin * WG_BK, alpha);
    rescale_and_split(s, alpha);
  }
  for (int i = 1; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_k(i + 1);
    load_v(i);
    wait_k(i);
    wait_v(i - 1);
    float s[32], alpha[2];
    if (wg == 1) named_sync(1);
    if (wg == 0 && i >= 2) named_sync(2);
    wgmma_fence();
    issue_s(s, i & 1);
    issue_pv((i - 1) % 3);
    wgmma_wait<1>();                       // S_i done, P.V in flight
    free_k(i);
    if (wg == 0) named_arrive(1);
    if (wg == 1 && i + 1 < n_tiles) named_arrive(2);
    softmax(s, (t_begin + i) * WG_BK, alpha);
    wgmma_wait<0>();                       // P.V has read P, written O
    free_v(i - 1);
    keep_live(hi);
    keep_live(lo);
    keep_live(acc);
    rescale_and_split(s, alpha);
  }
  if (n_tiles > 0) {                       // the last tile's P.V
    wait_v(n_tiles - 1);
    wgmma_fence();
    issue_pv((n_tiles - 1) % 3);
    wgmma_wait<0>();
    keep_live(acc);
  }

  // normalize, round to bf16, stage each warp's 16 rows where its Q rows
  // were (the same swizzled layout: only this warpgroup's products read
  // them, and they are done), and store 16-byte chunks
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / (l[0] > 0.f ? l[0] : 1.f),
                        1.f / (l[1] > 0.f ? l[1] : 1.f)};
  if (lse != nullptr && t == 0)
    write_lse(lse + bh * sq, q0 + wr + g, sq, m, l);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          qs + swizzled<WG_BQ>(wr + g + 8 * h, j) + 4 * t) =
          pack_bf16(acc[4 * j + 2 * h] * inv[h],
                    acc[4 * j + 2 * h + 1] * inv[h]);
  __syncwarp();
  if (tma) {
    for (int e = lane; e < 16 * S::CH; e += 32) {
      const int r = e / S::CH;
      const int c = e - r * S::CH;
      const int row = q0 + wr + r;
      if (row < sq && c * 8 < dh)
        *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(row) * dh +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(qs + swizzled<WG_BQ>(wr + r, c));
    }
  } else {
    for (int e = lane; e < 16 * dh; e += 32) {
      const int r = e / dh;
      const int c = e - r * dh;
      const int row = q0 + wr + r;
      if (row < sq)
        ob[static_cast<int64_t>(row) * dh + c] =
            *reinterpret_cast<const bf16*>(
                qs + swizzled<WG_BQ>(wr + r, c >> 3) + (c & 7) * 2);
    }
  }
}

template <int DP>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                 float* lse, int bh, int sq, int sk, int dh, float scale,
                 int causal, int window, float softcap, int q_offset,
                 cudaStream_t stream) {
  const size_t smem = WgShape<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // TMA reads rows of whole 16-byte units from 16-byte aligned bases; any
  // other input is read element by element
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int tma = sk > 0 && dh % 8 == 0 && aligned(q) && aligned(k) &&
                  aligned(v) && aligned(o);
  CUtensorMap tq = {}, tk = {}, tv = {};
  if (tma) {
    int bad = tensor_map(&tq, q, bh, sq, dh, WG_BQ);
    if (!bad) bad = tensor_map(&tk, k, bh, sk, dh, WG_BK);
    if (!bad) bad = tensor_map(&tv, v, bh, sk, dh, WG_BK);
    if (bad) return bad;
  }
  const dim3 grid(bh, (sq + WG_BQ - 1) / WG_BQ);
  flash_attention_wgmma_kernel<DP><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, q, k, v, o, lse, sq, sk, dh, scale, causal, window, softcap,
      q_offset, tma);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- fp32 --

constexpr int F_BQ = F_WARPS * 16;             // 128 query rows a block
constexpr int F_BK = 32;                       // keys a tile
constexpr int F_STAGES = 3;                    // tiles in the K/V ring

template <int DP>
struct F32Shape {
  static constexpr int TILE = F_BK * DP;       // floats of a K or V tile
  static constexpr size_t Q_BYTES = sizeof(float) * F_BQ * DP;
  static constexpr size_t TILE_BYTES = sizeof(float) * TILE;
  static constexpr size_t SMEM = Q_BYTES + F_STAGES * TILE_BYTES;
  static_assert(DP % 32 == 0, "the swizzle stays inside 32-column groups");
  static_assert(SMEM <= 232448, "a block may use 227 KB of shared memory");
};

template <int DP>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_attention_tf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            int sq, int sk, int dh,
                            float scale, int causal, int window,
                            float softcap, int q_offset, int vec) {
  using S = F32Shape<DP>;
  extern __shared__ __align__(16) float fsmem[];
  float* qs = fsmem;                                    // [F_BQ][DP]
  float* ring = fsmem + F_BQ * DP;                // [F_STAGES][F_BK][DP]

  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_BQ;   // last blocks first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                              // fragment row
  const int t = lane & 3;                               // fragment column
  const float* __restrict__ qb = q + bh * sq * dh;
  const float* __restrict__ kb = k + bh * sk * dh;
  const float* __restrict__ vb = v + bh * sk * dh;
  float* __restrict__ ob = o + bh * sq * dh;

  // keys any row of this block may attend, in whole tiles
  const int a_lo = q_offset + q0;
  const int a_hi = q_offset + min(q0 + F_BQ, sq) - 1;
  const int kv_end = causal ? min(sk, a_hi + 1) : sk;
  const int kv_begin = window > 0 ? max(0, a_lo - window + 1) : 0;
  const int t_begin = kv_begin / F_BK;
  const int t_end = kv_end > kv_begin ? (kv_end + F_BK - 1) / F_BK
                                      : t_begin;
  const int n_tiles = t_end - t_begin;

  // this warp's 16 rows of the block
  const int wr = warp * 16;
  const bool w_rows = q0 + wr < sq;
  const int w_lo = q_offset + q0 + wr;
  const int w_hi = q_offset + min(q0 + wr + 15, sq - 1);
  const int qpos0 = w_lo + g;                           // rows g and g + 8

  // base-2 logits: t2 = s * sc2, or cap2 tanh(s * uc)
  const float sc2 = scale * LOG2E;
  const float uc = softcap > 0.f ? scale / softcap : 0.f;
  const float cap2 = softcap * LOG2E;

  // Fragment offsets, fixed a thread.  S = Q.K^T takes the 8 head dims of
  // k-step kk in the order 2t, 2t + 1 of each lane (a permutation applied
  // to both operands alike), so each lane reads its two dims as one 64-bit
  // load: dims 8 kk + 2t, + 1 of a Q or K row r (r % 4 == g % 4) sit at
  // column 32 (kk / 4) + xk[kk % 4].  O += P.V takes keys in the order of
  // S's accumulator (row g holds keys 2t, 2t + 1 of each 8): B reads V rows
  // 8 j + 2t and + 1 at head dim 8 n + g, column 32 (n / 4) + xv[n % 4].
  int xk[4], xv[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    xk[p] = 8 * (p ^ (g & 3)) + 2 * t;
    xv[p] = 8 * (p ^ t) + g;
  }
  const float* qa = qs + (wr + g) * DP;                 // rows g, g + 8

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {FA_NEG, FA_NEG};
  float l[2] = {0.f, 0.f};
  float s[F_BK / 8][4];

  // the online softmax of a tile's logits in s (base 2, soft-capped, masked
  // where the tile straddles a mask's edge for this warp's rows): s becomes
  // P, l and m are updated, and O is scaled by the change of the max
  auto softmax = [&](int k0) {
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < F_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = cap2 * tanhf(s[j][e] * uc);
    } else {
#pragma unroll
      for (int j = 0; j < F_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sc2;
    }
    const bool masked = k0 + F_BK > sk || (causal && k0 + F_BK - 1 > w_lo) ||
                        (window > 0 && k0 <= w_hi - window);
    if (masked) {
#pragma unroll
      for (int j = 0; j < F_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // s[j][e]: row g + 8 (e / 2), key 8 j + 2 t + e % 2
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          if (!ok) s[j][e] = FA_NEG;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < F_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float base2[2], alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no attended key yet: masked logits (the sentinel)
      // exponentiate against 0, so they give exactly 0
      base2[r] = mx[r] == FA_NEG ? 0.f : mx[r];
      alpha[r] = ex2(m[r] - base2[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < F_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - base2[e >> 1]);
        rsum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rsum[r];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
  };

  // Ring entry e is K_(e/2) for even e and V_(e/2) for odd e, in slot
  // e % F_STAGES; every thread issues its copies of an entry and commits
  // one cp.async group for it (empty past the last tile), so that group e
  // holds entry e (group 0 also Q).  Tile i's K is waited for, and the
  // block synchronized, before S_i; its V before P.V_i.  Each wait allows
  // F_STAGES - 2 groups in flight, and each sync is followed by the copies
  // of the entry F_STAGES - 1 ahead, into the slot whose tile every warp
  // has finished with (V_(i-1) after the first, K_i after the second).
  auto issue = [&](int e) {
    if (e < 2 * n_tiles) {
      float* dst = ring + (e % F_STAGES) * S::TILE;
      const int row0 = (t_begin + (e >> 1)) * F_BK;
      if (e & 1)
        load_f32<DP, F_BK, SW_V>(dst, vb, row0, sk, dh, vec);
      else
        load_f32<DP, F_BK, SW_QK>(dst, kb, row0, sk, dh, vec);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_f32<DP, F_BQ, SW_QK>(qs, qb, q0, sq, dh, vec);
    for (int e = 0; e < F_STAGES - 1; ++e) issue(e);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t_begin + i) * F_BK;
    // warp-uniform: does any row of this warp attend a key of the tile?
    // (a tile wholly masked for the warp is the identity update)
    const bool live = w_rows && !(causal && k0 > w_hi) &&
                      !(window > 0 && k0 + F_BK - 1 <= w_lo - window);
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    issue(2 * i + F_STAGES - 1);
    if (live) {
      const float* kt = ring + ((2 * i) % F_STAGES) * S::TILE + g * DP;
#pragma unroll
      for (int j = 0; j < F_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const int c = 32 * (kk >> 2) + xk[kk & 3];
        const float2 q_lo = *reinterpret_cast<const float2*>(qa + c);
        const float2 q_hi = *reinterpret_cast<const float2*>(qa + 8 * DP + c);
        uint32_t ab[4], as[4];
        split_tf32(q_lo.x, ab[0], as[0]);
        split_tf32(q_hi.x, ab[1], as[1]);
        split_tf32(q_lo.y, ab[2], as[2]);
        split_tf32(q_hi.y, ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < F_BK / 8; ++j) {
          const float2 kv =
              *reinterpret_cast<const float2*>(kt + 8 * j * DP + c);
          uint32_t bb[2], bs[2];
          split_tf32(kv.x, bb[0], bs[0]);
          split_tf32(kv.y, bb[1], bs[1]);
          mma_3xtf32(s[j], ab, as, bb, bs);
        }
      }
      softmax(k0);
    }
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    issue(2 * i + F_STAGES);
    if (live) {
      const float* vt =
          ring + ((2 * i + 1) % F_STAGES) * S::TILE + 2 * t * DP;
#pragma unroll
      for (int j = 0; j < F_BK / 8; ++j) {
        // P's A fragment in the key order of S's accumulator
        uint32_t ab[4], as[4];
        split_tf32(s[j][0], ab[0], as[0]);
        split_tf32(s[j][2], ab[1], as[1]);
        split_tf32(s[j][1], ab[2], as[2]);
        split_tf32(s[j][3], ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          const float* vr = vt + 8 * j * DP + 32 * (n >> 2) + xv[n & 3];
          uint32_t bb[2], bs[2];
          split_tf32(vr[0], bb[0], bs[0]);
          split_tf32(vr[DP], bb[1], bs[1]);
          mma_3xtf32(acc[n], ab, as, bb, bs);
        }
      }
    }
  }

  // normalize and store (row g + 8 h, head dims 8 n + 2 t, + 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / (l[0] > 0.f ? l[0] : 1.f),
                        1.f / (l[1] > 0.f ? l[1] : 1.f)};
  if (lse != nullptr && t == 0)
    write_lse(lse + bh * sq, q0 + wr + g, sq, m, l);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= sq) continue;
    float* orow = ob + static_cast<int64_t>(row) * dh;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      const float x0 = acc[n][2 * h] * inv[h];
      const float x1 = acc[n][2 * h + 1] * inv[h];
      if (col >= dh) continue;
      if (vec) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        orow[col] = x0;
        if (col + 1 < dh) orow[col + 1] = x1;
      }
    }
  }
}

template <int DP>
int launch_tf32(const float* q, const float* k, const float* v, float* o,
                float* lse, int bh, int sq, int sk, int dh, float scale,
                int causal, int window, float softcap, int q_offset,
                cudaStream_t stream) {
  const size_t smem = F32Shape<DP>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tf32_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies need rows of whole 16-byte units from aligned bases
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = dh % 4 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                  aligned(o);
  const dim3 grid(bh, (sq + F_BQ - 1) / F_BQ);
  flash_attention_tf32_kernel<DP><<<grid, F_THREADS, smem, stream>>>(
      q, k, v, o, lse, sq, sk, dh, scale, causal, window, softcap, q_offset,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// the arguments both entry points take; 0 means launch, else the error
int check_args(int bh, int sq, int sk, int dh) {
  if (dh < 1 || dh > FA_MAX_DH || bh > 65535 || bh < 0 || sq < 0 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// q (bh, sq, dh), k and v (bh, sk, dh), o (bh, sq, dh), all contiguous
// fp32; causal 0/1, window 0 = none, softcap 0 = none; lse (bh, sq) fp32
// receives each row's base-2 log-sum-exp for the backward, or is null (the
// prefill), which leaves the kernel's work as it was.  On the tensor
// cores in 3xTF32 (fp32 accumulation), dh padded to 64, 128, 224 or 256.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, int bh, int sq, int sk, int dh, float scale,
                        int causal, int window, float softcap, int q_offset,
                        float* lse, void* stream) {
  if (const int bad = check_args(bh, sq, sk, dh)) return bad;
  if (static_cast<int64_t>(bh) * sq == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch_tf32<64>(q, k, v, o, lse, bh, sq, sk, dh, scale, causal,
                           window, softcap, q_offset, st);
  if (dh <= 128)
    return launch_tf32<128>(q, k, v, o, lse, bh, sq, sk, dh, scale, causal,
                            window, softcap, q_offset, st);
  if (dh <= 224)
    return launch_tf32<224>(q, k, v, o, lse, bh, sq, sk, dh, scale, causal,
                            window, softcap, q_offset, st);
  return launch_tf32<256>(q, k, v, o, lse, bh, sq, sk, dh, scale, causal,
                          window, softcap, q_offset, st);
}

// The same over bf16 tensors on the tensor cores (fp32 accumulation, bf16
// output), dh padded to 64, 128, 224 or 256.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int bh, int sq, int sk, int dh, float scale,
                         int causal, int window, float softcap, int q_offset,
                         float* lse, void* stream) {
  if (const int bad = check_args(bh, sq, sk, dh)) return bad;
  if (static_cast<int64_t>(bh) * sq == 0) return 0;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch_wgmma<64>(qp, kp, vp, op, lse, bh, sq, sk, dh, scale, causal,
                          window, softcap, q_offset, st);
  if (dh <= 128)
    return launch_wgmma<128>(qp, kp, vp, op, lse, bh, sq, sk, dh, scale, causal,
                           window, softcap, q_offset, st);
  if (dh <= 224)
    return launch_wgmma<224>(qp, kp, vp, op, lse, bh, sq, sk, dh, scale, causal,
                           window, softcap, q_offset, st);
  return launch_wgmma<256>(qp, kp, vp, op, lse, bh, sq, sk, dh, scale, causal,
                         window, softcap, q_offset, st);
}

// Dynamic shared memory (bytes) an fp32 launch at head dim dh takes.
int flash_attention_f32_smem(int dh) {
  if (dh <= 64) return static_cast<int>(F32Shape<64>::SMEM);
  if (dh <= 128) return static_cast<int>(F32Shape<128>::SMEM);
  if (dh <= 224) return static_cast<int>(F32Shape<224>::SMEM);
  return static_cast<int>(F32Shape<256>::SMEM);
}

// Dynamic shared memory (bytes) a bf16 launch at head dim dh takes.
int flash_attention_bf16_smem(int dh) {
  if (dh <= 64) return static_cast<int>(WgShape<64>::SMEM);
  if (dh <= 128) return static_cast<int>(WgShape<128>::SMEM);
  if (dh <= 224) return static_cast<int>(WgShape<224>::SMEM);
  return static_cast<int>(WgShape<256>::SMEM);
}

}  // extern "C"
