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
// Two bodies, chosen by L in the entry point; both are exact (the work is
// boolean, so each equals the plain loop bit for bit):
//
// prune_recurrence_smem_kernel (L <= PR_SMEM_MAX_L = 1024): the rows'
// masks in shared memory as bits.
// - A 128-thread block takes R = clamp(16384 / L^2, 1, 4) consecutive rows
//   (1 at L = 128: 256 blocks for b = 256; 4 at L = 48).  Its threads first
//   read the rows' may_dominate and valid bytes, contiguous in memory, and
//   m_limit, every load in flight together (16-byte loads, PR_BATCH a
//   thread), and pack the bytes into bits in shared memory: byte f of the
//   block's range becomes bit f % 32 of word f / 32 (each 16-byte load
//   gives 16 bits; two lanes' halves join by one shuffle).  Where L % 4 !=
//   0 or a base is unaligned the bytes are read one a lane and packed by
//   __ballot_sync.  L = 128 takes 2 KB a row where the register body read
//   16 KB through L1.
// - Then warp r runs row r's recurrence from shared memory, 32 candidates
//   (a chunk) at a time, lane l holding j = 32 c + l.  A chunk's
//   candidates are first checked against the members of earlier chunks:
//   row j's 32 mask bits over chunk k (two shared words and a funnel
//   shift) ANDed with chunk k's members, all loads independent.  Then the
//   members within the chunk follow from warp-uniform words: cand (valid,
//   not dominated) gives the next member a = ffs(cand), and one
//   __ballot_sync of each lane's bit [j][a] drops what a dominates.  A
//   member costs a few dependent instructions and no memory access; a
//   chunk one shared-memory round trip.  Once count reaches m_limit the
//   warp stops; each lane writes its candidates' output bytes once, at the
//   end.
//
// prune_recurrence_kernel<NW> (1024 < L <= 8192): the first body, kept for
// rows of more than 32 chunks (a lane's processed and accepted bits are one
// word in the shared-memory body), whose packed masks (L^2 / 8 bytes, 128
// KB at L = 1024) would soon outgrow shared memory.  One warp a row, four
// rows a 128-thread block, NW bitmap words a lane in registers; each
// member's column may_dominate[j][a] is read from global memory
// (prefetched into L1 when the warp starts), up to ceil(L / 32)
// independent byte loads a lane.
//
// L <= 8192 (the register bitmaps: eight words a lane).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PR_WARPS = 4;          // warps a block (rows: register body)
constexpr int PR_THREADS = PR_WARPS * 32;
constexpr int PR_MAX_L = 8192;       // 8 bitmap words a lane
constexpr int PR_SMEM_MAX_L = 1024;  // the shared-memory body's largest L
constexpr int PR_BATCH = 8;          // mask loads a thread has in flight
constexpr int PR_BLOCK_BYTES = 16384; // mask bytes a block aims at
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
__global__ void __launch_bounds__(PR_THREADS)
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

// the bool bytes of x (0 or not) as 4 bits: byte k -> bit k
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  x &= 0x01010101u;                 // bit 0 of each byte: any bit of it
  return ((x * 0x00204081u) >> 21) & 0xFu;
}

// Packing bool bytes into bits: byte f of a range -> bit f % 32 of word
// f / 32.  A batch is U units a thread, all loaded before any is packed:
// with vec a unit is 16 bytes (the range 16-byte aligned, its length a
// multiple of 16), else one byte.  Every thread of the block calls both
// halves with the same base (units before it are done).
template <int U>
__device__ __forceinline__ void pack_load(uint4 (&x)[U],
                                          const uint8_t* __restrict__ src,
                                          int n, int base, bool vec) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * PR_THREADS + threadIdx.x;
    if (vec)
      x[u] = i < (n >> 4) ? __ldg(reinterpret_cast<const uint4*>(src) + i)
                          : make_uint4(0u, 0u, 0u, 0u);
    else
      x[u].x = i < n ? __ldg(src + i) : 0u;
  }
}

template <int U>
__device__ __forceinline__ void pack_store(uint32_t* dst,
                                           const uint4 (&x)[U], int n,
                                           int base, bool vec) {
  const int lane = threadIdx.x & 31;
  const int units = vec ? n >> 4 : n;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i0 = base + u * PR_THREADS + (threadIdx.x & ~31);  // uniform
    if (i0 >= units) break;
    if (vec) {
      // 16 bits a lane; the even lane joins its odd neighbour's
      const uint32_t h = nibble(x[u].x) | nibble(x[u].y) << 4 |
                         nibble(x[u].z) << 8 | nibble(x[u].w) << 12;
      const uint32_t other = __shfl_xor_sync(FULL, h, 1);
      if (!(lane & 1) && i0 + lane < units)
        dst[(i0 + lane) >> 1] = h | other << 16;
    } else {
      const uint32_t w = __ballot_sync(FULL, x[u].x != 0u);
      if (lane == 0) dst[i0 >> 5] = w;
    }
  }
}

// L <= PR_SMEM_MAX_L.
__global__ void __launch_bounds__(PR_THREADS)
prune_recurrence_smem_kernel(const uint8_t* __restrict__ valid,
                             const uint8_t* __restrict__ md,
                             const int32_t* __restrict__ m_limit,
                             uint8_t* __restrict__ processed,
                             uint8_t* __restrict__ accepted, int b, int L,
                             int rows) {
  extern __shared__ uint32_t psmem[];
  const int row0 = blockIdx.x * rows;
  const int here = min(rows, b - row0);
  const int n_md = here * L * L;
  const int n_v = here * L;
  uint32_t* mdw = psmem;                            // [ceil(rows L^2 / 32)]
  uint32_t* vw = mdw + ((rows * L * L + 31) >> 5);  // [ceil(rows L / 32)]
  int* lims = reinterpret_cast<int*>(vw + ((rows * L + 31) >> 5));

  // every global read of the block in flight at once: the first batch of
  // the mask, the valid bytes, m_limit
  const uint8_t* md_blk = md + static_cast<int64_t>(row0) * L * L;
  const uint8_t* v_blk = valid + static_cast<int64_t>(row0) * L;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool md_vec = aligned(md_blk) && n_md % 16 == 0;
  const bool v_vec = aligned(v_blk) && n_v % 16 == 0;
  const int md_units = md_vec ? n_md >> 4 : n_md;
  const int v_units = v_vec ? n_v >> 4 : n_v;
  uint4 xm[PR_BATCH], xv[2];
  pack_load<PR_BATCH>(xm, md_blk, n_md, 0, md_vec);
  pack_load<2>(xv, v_blk, n_v, 0, v_vec);
  const int lim_t = threadIdx.x < here ? m_limit[row0 + threadIdx.x] : 0;
  pack_store<PR_BATCH>(mdw, xm, n_md, 0, md_vec);
  for (int base = PR_BATCH * PR_THREADS; base < md_units;
       base += PR_BATCH * PR_THREADS) {
    pack_load<PR_BATCH>(xm, md_blk, n_md, base, md_vec);
    pack_store<PR_BATCH>(mdw, xm, n_md, base, md_vec);
  }
  pack_store<2>(vw, xv, n_v, 0, v_vec);
  for (int base = 2 * PR_THREADS; base < v_units; base += 2 * PR_THREADS) {
    pack_load<2>(xv, v_blk, n_v, base, v_vec);
    pack_store<2>(vw, xv, n_v, base, v_vec);
  }
  if (threadIdx.x < here) lims[threadIdx.x] = lim_t;
  __syncthreads();

  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= here) return;                     // the whole warp leaves
  const int lim = lims[r];

  // Chunk c holds candidates j = 32 c + lane.  A chunk's candidates are
  // first checked against the members of earlier chunks (row j's mask word
  // over chunk k, ANDed with chunk k's members); then the members within
  // the chunk follow one by one from two warp-uniform words: cand (valid,
  // not yet dominated) and each lane's mask word over its own chunk.
  uint32_t pb = 0u, ab = 0u;                 // bit c: processed, accepted
  uint32_t accw = 0u;                        // lane c: chunk c's members
  int count = 0;                             // uniform across the warp
  for (int c = 0; 32 * c < L && count < lim; ++c) {
    const int j = 32 * c + lane;
    const bool in = j < L;
    const int rowbit = (r * L + j) * L;      // bit of [j][0]
    // bits [j][32 k .. 32 k + 31]: two words joined by a funnel shift (the
    // bits past L in the last chunk are never tested)
    const auto row_word = [&](int k) {
      const int f = rowbit + 32 * k;
      return __funnelshift_r(mdw[f >> 5], mdw[(f >> 5) + 1], f & 31);
    };
    const uint32_t rw = in ? row_word(c) : 0u;
    bool dom = false;
    for (int k = 0; k < c; ++k) {
      const uint32_t members = __shfl_sync(FULL, accw, k);
      if (in && (row_word(k) & members) != 0u) dom = true;
    }
    const int fv = r * L + j;
    const bool v = in && ((vw[fv >> 5] >> (fv & 31)) & 1u);
    const uint32_t vmask = __ballot_sync(FULL, v);
    uint32_t cand = __ballot_sync(FULL, v && !dom);
    uint32_t acc = 0u;
    int last = 31;
    while (cand != 0u && count < lim) {
      const int a = __ffs(cand) - 1;         // the next member
      acc |= 1u << a;
      ++count;
      last = a;
      // drop a, the candidates before it, and those a dominates
      cand &= ~__ballot_sync(FULL, (rw >> a) & 1u) & ~((2u << a) - 1u);
    }
    // every valid candidate of the chunk is processed, or, once count has
    // reached m_limit, those up to the last member
    const uint32_t proc = count < lim ? vmask : vmask & ((2u << last) - 1u);
    pb |= ((proc >> lane) & 1u) << c;
    ab |= ((acc >> lane) & 1u) << c;
    if (lane == c) accw = acc;
  }

  uint8_t* p_row = processed + static_cast<int64_t>(row0 + r) * L;
  uint8_t* a_row = accepted + static_cast<int64_t>(row0 + r) * L;
  for (int c = 0; 32 * c < L; ++c) {
    const int j = 32 * c + lane;
    if (j < L) {
      p_row[j] = (pb >> c) & 1u;
      a_row[j] = (ab >> c) & 1u;
    }
  }
}

// rows a block of the shared-memory body (about 16 KB of mask a block),
// and its dynamic shared memory: the mask's bits, valid's bits (the last
// row word's funnel shift may read valid's first word, whose bits it never
// tests) and m_limit
int smem_rows(int L) {
  return max(1, min(PR_WARPS, PR_BLOCK_BYTES / (L * L)));
}
size_t smem_bytes(int L, int rows) {
  return 4 * (static_cast<size_t>((rows * L * L + 31) >> 5) +
              ((rows * L + 31) >> 5) + rows);
}

int launch_prune_smem(const uint8_t* valid, const uint8_t* md,
                      const int32_t* lim, uint8_t* processed,
                      uint8_t* accepted, int b, int L, cudaStream_t stream) {
  const int rows = smem_rows(L);
  const size_t smem = smem_bytes(L, rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        prune_recurrence_smem_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>((b + rows - 1) / rows);
  prune_recurrence_smem_kernel<<<grid, PR_THREADS, smem, stream>>>(
      valid, md, lim, processed, accepted, b, L, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_prune(const uint8_t* valid, const uint8_t* md, const int32_t* lim,
                 uint8_t* processed, uint8_t* accepted, int b, int L,
                 cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((b + PR_WARPS - 1) / PR_WARPS);
  prune_recurrence_kernel<NW><<<grid, PR_THREADS, 0, stream>>>(
      valid, md, lim, processed, accepted, b, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest L the kernel takes.
int prune_recurrence_max_l() { return PR_MAX_L; }

// The largest L the shared-memory body takes; above it, the register body.
int prune_recurrence_smem_max_l() { return PR_SMEM_MAX_L; }

// valid (b, L), may_dominate (b, L, L) and the outputs processed, accepted
// (b, L) are bool bytes; m_limit (b) int32.  Returns cudaGetLastError().
int prune_recurrence(const uint8_t* valid, const uint8_t* may_dominate,
                     const int32_t* m_limit, uint8_t* processed,
                     uint8_t* accepted, int b, int L, void* stream) {
  if (b == 0 || L == 0) return 0;
  if (L > PR_MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= PR_SMEM_MAX_L)
    return launch_prune_smem(valid, may_dominate, m_limit, processed,
                             accepted, b, L, s);
  const int words = (L + 1023) / 1024;
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
