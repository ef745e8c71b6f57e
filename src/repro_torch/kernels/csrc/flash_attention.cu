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
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or the shared-memory opt-in's error) so the
// Python wrapper can raise on a refused launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

constexpr int WG_ROWS = 64;                    // query rows a warpgroup
constexpr int WG_GROUPS = 2;                   // consumer warpgroups a block
constexpr int WG_THREADS = WG_GROUPS * 128;
constexpr int WG_BQ = WG_GROUPS * WG_ROWS;     // 128 query rows per block
constexpr int WG_BK = 64;                      // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Tiles live in shared memory in the 128-byte-swizzle layout that wgmma's
// descriptors read: a row's 16-byte chunk c sits in atom column c / 8 (each
// atom column holds all rows of the tile, 128 bytes a row) at chunk
// (c % 8) ^ (row % 8).  Tile bases are 1024-byte aligned.
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

template <int ROWS>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 64-bit wgmma descriptor of a 128-byte-swizzled tile at smem address addr
// (byte offsets lbo, sbo: leading and stride dimension offsets)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// wait until the barrier's phase of parity `parity` has completed; a wait
// of more than 4 s traps, so that a broken pipeline fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (t0 == 0) t0 = now;
    else if (now - t0 > 4000000000ull) __trap();
  }
}
// one box of a 3-D tensor map into shared memory at dst, completing
// bytes on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// the warpgroups' turn-taking: a named barrier over the block's threads
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG_THREADS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(WG_THREADS)
               : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers an asynchronous wgmma reads or writes: kept in place (not
// reused, not moved) up to this point
template <int N>
__device__ __forceinline__ void keep_live(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep_live(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// d (64 x 64, fp32) += A (smem, K-major) . B (smem, K-major); d is
// zeroed first when scale_d == 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (registers) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (registers) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 224, fp32) += A (registers) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n224(float (&d)[112],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111}, "
      "{%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (registers) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 224) wgmma_rs_n224(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// the bf16 pair nearest (lo, hi), and the bf16 pair nearest what it misses
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& big,
                                           uint32_t& small) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(h);
  big = *reinterpret_cast<const uint32_t*>(&h);
  small = pack_bf16(lo - f.x, hi - f.y);
}

// rows [row0, row0 + ROWS) of a (n_rows, dh) matrix into the swizzled tile
// at dst, element by element (rows whose length is not a multiple of 16
// bytes, or unaligned, which TMA cannot read); rows past n_rows and columns
// in [dh, DP) become 0
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const bf16* __restrict__ src,
                                          int row0, int n_rows, int dh) {
  for (int e = threadIdx.x; e < ROWS * DP; e += WG_THREADS) {
    const int r = e / DP;
    const int c = e - r * DP;
    const int gr = row0 + r;
    *reinterpret_cast<bf16*>(dst + swizzled<ROWS>(r, c >> 3) + (c & 7) * 2) =
        (gr < n_rows && c < dh) ? src[static_cast<int64_t>(gr) * dh + c]
                                : __ushort_as_bfloat16(0);
  }
}

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

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// (bh, rows, dh) bf16 as a 3-D tensor map of boxes 64 columns by box_rows
// rows, 128-byte swizzled, zero outside the tensor
int tensor_map(CUtensorMap* map, const void* ptr, int bh, int rows, int dh,
               int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(rows) * dh * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
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

constexpr int F_WARPS = 8;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_BQ = F_WARPS * 16;             // 128 query rows a block
constexpr int F_BK = 32;                       // keys a tile
constexpr int F_STAGES = 3;                    // tiles in the K/V ring

// An fp32 tile is [row][DP] floats with its 8-float (32-byte) column groups
// swizzled by the row: Q and K tiles XOR the group by row % 4 (the 64-bit
// fragment loads of 4 rows x 8 columns a half-warp reads fall on distinct
// banks), V tiles by (row / 2) % 4 (the 32-bit loads of rows 2t, 2t + 1 at
// 8 columns do).  A 16-byte chunk stays whole, inside its 32-column group.
enum { SW_QK = 0, SW_V = 1 };
template <int SW>
__device__ __forceinline__ int swz(int r) {
  return SW == SW_QK ? (r & 3) << 3 : ((r >> 1) & 3) << 3;
}

template <int DP>
struct F32Shape {
  static constexpr int TILE = F_BK * DP;       // floats of a K or V tile
  static constexpr size_t Q_BYTES = sizeof(float) * F_BQ * DP;
  static constexpr size_t TILE_BYTES = sizeof(float) * TILE;
  static constexpr size_t SMEM = Q_BYTES + F_STAGES * TILE_BYTES;
  static_assert(DP % 32 == 0, "the swizzle stays inside 32-column groups");
  static_assert(SMEM <= 232448, "a block may use 227 KB of shared memory");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x as a TF32 pair: big is x with its low 13 mantissa bits cleared (exactly
// TF32), small = x - big (exact in fp32, of which the tensor core keeps the
// top 11 bits): big + small = x to ~2^-21 relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  const uint32_t b = __float_as_uint(x) & 0xffffe000u;
  big = b;
  small = __float_as_uint(x - __uint_as_float(b));
}

// d (16 x 8, fp32) += a (16 x 8, tf32) . b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a . b in 3xTF32: the two small cross terms, then big . big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// rows [row0, row0 + ROWS) of a (n_rows, dh) fp32 matrix into the swizzled
// tile at dst; rows past n_rows and columns in [dh, DP) become 0.  vec:
// 16-byte cp.async copies (dh % 4 == 0, 16-byte aligned bases), left in
// flight for the caller's commit and wait; else element by element.
template <int DP, int ROWS, int SW>
__device__ __forceinline__ void load_f32(float* dst,
                                         const float* __restrict__ src,
                                         int row0, int n_rows, int dh,
                                         int vec) {
  if (vec) {
    constexpr int CH = DP / 4;
    for (int e = threadIdx.x; e < ROWS * CH; e += F_THREADS) {
      const int r = e / CH;
      const int c = 4 * (e - r * CH);
      const int gr = row0 + r;
      const bool in = gr < n_rows && c < dh;
      cp_async16(smem_u32(dst + r * DP + (c ^ swz<SW>(r))),
                 in ? src + static_cast<int64_t>(gr) * dh + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += F_THREADS) {
      const int r = e / DP;
      const int c = e - r * DP;
      const int gr = row0 + r;
      dst[r * DP + (c ^ swz<SW>(r))] =
          (gr < n_rows && c < dh) ? src[static_cast<int64_t>(gr) * dh + c]
                                  : 0.f;
    }
  }
}

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
