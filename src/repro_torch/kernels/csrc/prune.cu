// The prune's dominance recurrence for Hopper (sm_90a), plain C interface
// for ctypes.
//
// A port-only kernel: it replaces no Pallas kernel.  The reference runs
// this recurrence as an XLA fori_loop (repro/core/prune.py:104); its plain
// version is a Python loop of ~9 ops a candidate position
// (repro_torch/kernels/ref.py::prune_recurrence_ref).  Per row of b, over
// the L candidates ascending by distance:
//
//   count = 0
//   for j in 0 .. L-1:
//     proc_j = valid[j] && count < m_limit
//     acc_j  = proc_j && !any_w(accepted[w] && may_dominate[j][w])
//     count += acc_j
//   outputs processed[j] = proc_j, accepted[j] = acc_j      (bool, b x L)
//
// Bound: bytes.  The bytes the recurrence must move are its inputs read
// once and its outputs written once: valid (b*L), m_limit (4*b), the two
// (b, L) outputs, and of may_dominate (b*L*L, the whole mask: 4.2 MB at
// the forward prune's (b, L) = (256, 128), 1.25 us at 3.35 TB/s; 18.9 MB
// at the reverse re-prune's (8192, 48), 5.6 us) only the entries it
// consults, [j][w] for an accepted w < j, far fewer on real data.  What it
// cannot avoid besides the bytes is a chain of dependent decisions a row:
// one per accepted candidate.
//
// Design: one warp per row, four rows a 128-thread block, no shared memory.
// - Per-candidate state is bitmaps in registers spread over the lanes:
//   lane l owns the candidates j = 32 i + l, bit i of its words (ceil(L /
//   1024) words a lane, L bits a row): valid, dominated (by a member
//   accepted so far), processed, accepted.
// - The loop advances by accepted candidates, not by positions.  The next
//   member is the first valid, undominated candidate at or after the
//   current position: one __ballot_sync per 32 candidates finds it (one or
//   two on real data).  Every valid candidate before it is dominated, so
//   it is processed and rejected; it is processed and accepted.  Then each
//   lane ORs the new member's column, may_dominate[j][a] for its own
//   candidates j > a not yet dominated, into its dominated bits: up to
//   ceil(L / 32) independent byte loads a lane, all in flight at once.
// - The row's may_dominate lines are prefetched into L1 when the warp
//   starts, so those column reads hit L1 after the first.
// - Once count reaches m_limit no later candidate is processed: the warp
//   stops.  Each lane writes its own candidates' output bytes once, at the
//   end (coalesced across the warp).
// Exact: the work is boolean, so the kernel equals the plain loop bit for
// bit.  L <= 8192 (the register bitmaps: eight words a lane).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PR_WARPS = 4;          // rows a block
constexpr int PR_MAX_L = 8192;       // 8 bitmap words a lane
constexpr unsigned FULL = 0xffffffffu;

// word q of a lane's bitmap, q a runtime index: a select over the
// unrolled words keeps the bitmap in registers
template <int NW>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&w)[NW], int q) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) r = (k == q) ? w[k] : r;
  return r;
}

template <int NW>
__device__ __forceinline__ bool bit_at(const uint32_t (&w)[NW], int i) {
  return (word_at<NW>(w, i >> 5) >> (i & 31)) & 1u;
}

template <int NW>
__device__ __forceinline__ void set_bit(uint32_t (&w)[NW], int i) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    if (k == (i >> 5)) w[k] |= 1u << (i & 31);
}

// bits lo .. hi (inclusive) of word q, empty when hi < lo
__device__ __forceinline__ uint32_t range_mask(int q, int lo, int hi) {
  const int a = max(lo - 32 * q, 0), b = min(hi - 32 * q, 31);
  if (b < a) return 0u;
  const uint32_t upto = b == 31 ? FULL : (1u << (b + 1)) - 1u;
  return upto & ~((1u << a) - 1u);
}

// NW: bitmap words a lane (L <= 1024 * NW).
template <int NW>
__global__ void __launch_bounds__(PR_WARPS * 32)
prune_recurrence_kernel(const uint8_t* __restrict__ valid,
                        const uint8_t* __restrict__ md,
                        const int32_t* __restrict__ m_limit,
                        uint8_t* __restrict__ processed,
                        uint8_t* __restrict__ accepted, int b, int L) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * PR_WARPS + warp;
  if (row >= b) return;                      // the whole warp leaves
  const uint8_t* md_row = md + row * L * L;
  const int64_t lines = (static_cast<int64_t>(L) * L + 127) >> 7;
  for (int64_t k = lane; k < lines; k += 32)
    asm volatile("prefetch.global.L1 [%0];" :: "l"(md_row + (k << 7)));
  const int nb = (L + 31) >> 5;              // bits a lane
  const int lim = m_limit[row];

  uint32_t vb[NW], db[NW], pb[NW], ab[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) vb[q] = db[q] = pb[q] = ab[q] = 0u;
  const uint8_t* v_row = valid + row * L;
#pragma unroll 4
  for (int i = 0; i < nb; ++i) {
    const int j = 32 * i + lane;
    if (j < L && __ldg(v_row + j)) set_bit<NW>(vb, i);
  }

  int start = 0, count = 0;                  // uniform across the warp
  while (start < L && count < lim) {
    // the next member: the first valid, undominated j >= start
    int a = L;
    for (int i = start >> 5; i < nb; ++i) {
      const bool cand = bit_at<NW>(vb, i) && !bit_at<NW>(db, i) &&
                        32 * i + lane >= start;
      const unsigned m = __ballot_sync(FULL, cand);
      if (m) {
        a = 32 * i + __ffs(m) - 1;
        break;
      }
    }
    // every valid j in [start, a] is processed (those before a rejected)
    const int hi = min(a, L - 1);
    const int lo_i = lane >= start ? 0 : (start - lane + 31) >> 5;
    const int hi_i = hi >= lane ? (hi - lane) >> 5 : -1;
#pragma unroll
    for (int q = 0; q < NW; ++q) pb[q] |= vb[q] & range_mask(q, lo_i, hi_i);
    if (a == L) break;                       // nothing left to accept
    if (lane == (a & 31)) set_bit<NW>(ab, a >> 5);
    ++count;
    // a's column into the dominated bits of the valid j > a
    for (int i0 = a >= lane ? ((a - lane) >> 5) + 1 : 0; i0 < nb; i0 += 4) {
      bool hit[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k;
        const int j = 32 * i + lane;
        hit[k] = i < nb && bit_at<NW>(vb, i) && !bit_at<NW>(db, i) &&
                 __ldg(md_row + static_cast<int64_t>(j) * L + a) != 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (hit[k]) set_bit<NW>(db, i0 + k);
    }
    start = a + 1;
  }

  uint8_t* p_row = processed + row * L;
  uint8_t* a_row = accepted + row * L;
  for (int i = 0; i < nb; ++i) {
    const int j = 32 * i + lane;
    if (j < L) {
      p_row[j] = bit_at<NW>(pb, i);
      a_row[j] = bit_at<NW>(ab, i);
    }
  }
}

template <int NW>
int launch_prune(const uint8_t* valid, const uint8_t* md, const int32_t* lim,
                 uint8_t* processed, uint8_t* accepted, int b, int L,
                 cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((b + PR_WARPS - 1) / PR_WARPS);
  prune_recurrence_kernel<NW><<<grid, PR_WARPS * 32, 0, stream>>>(
      valid, md, lim, processed, accepted, b, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest L the kernel takes.
int prune_recurrence_max_l() { return PR_MAX_L; }

// valid (b, L), may_dominate (b, L, L) and the outputs processed, accepted
// (b, L) are bool bytes; m_limit (b) int32.  Returns cudaGetLastError().
int prune_recurrence(const uint8_t* valid, const uint8_t* may_dominate,
                     const int32_t* m_limit, uint8_t* processed,
                     uint8_t* accepted, int b, int L, void* stream) {
  if (b == 0 || L == 0) return 0;
  if (L > PR_MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (L + 1023) / 1024;
  if (words <= 1)
    return launch_prune<1>(valid, may_dominate, m_limit, processed, accepted,
                           b, L, s);
  if (words <= 2)
    return launch_prune<2>(valid, may_dominate, m_limit, processed, accepted,
                           b, L, s);
  if (words <= 4)
    return launch_prune<4>(valid, may_dominate, m_limit, processed, accepted,
                           b, L, s);
  return launch_prune<8>(valid, may_dominate, m_limit, processed, accepted,
                         b, L, s);
}

}  // extern "C"
