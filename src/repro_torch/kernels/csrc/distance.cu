// Distance kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Four kernels: the fp32 pair carries FastPGT's estimation path and the
// serving re-rank; the int8 (SQ8) pair carries the quantized serving search
// (the int8 pairwise kernel is reached only from checks, as in the
// reference).
//
// 1. gather distance -- replaces the Pallas kernel
//    repro/kernels/gather_distance.py::gather_distance (_gather_dist_kernel).
//      out[b,i] = mask[b,i] ? delta(u_b, row(b,i)) : cached[b,i]
//    l2 = max(sum((u-c)^2), 0) (difference form: exact on integer-valued
//    data whatever the summation order), ip = 1 - <u,c>.  Two entry shapes
//    share one body: the slab form reads row(b,i) = c[b,i,:] from a
//    (b,k,d) slab; the ids form reads row(b,i) = data[ids[b,i],:] straight
//    from the corpus, so the search never materializes the gathered slab,
//    and treats INVALID (negative) ids like masked lanes (pass-through).
//    Bound: memory.  It reads b*k*d*4 bytes of candidate rows (only the
//    computed lanes in the ids form); at the build's hop shape b=256,
//    k=m*Mx=4*32=128, d=128 that is 16.8 MB, ~5 us at 3.35 TB/s.
//    Design: one warp per (query, candidate); lanes stride d with float4
//    loads when d % 4 == 0 and both bases are 16-byte aligned (scalar loads
//    otherwise), then a warp-shuffle reduction.  No shared memory: each
//    candidate row is read once, the query row comes from L1/L2.
//
// 2. pairwise distance -- replaces the Pallas kernel
//    repro/kernels/l2_distance.py::pairwise_distance (_dist_kernel).
//      l2 = max(|q|^2 + |x|^2 - 2 q.x, 0), ip = 1 - q.x, (nq,d)x(nx,d)->(nq,nx)
//    Bound: fp32 operations.  The estimation's ground truth at
//    (1000, 50000, 128) is 2*nq*nx*d = 12.8 GFLOP, 0.191 ms at the H100
//    SXM's 67 TFLOP/s fp32 (its 200 MB output takes 0.06 ms to write);
//    the serving ground truth at (1000, 131072, 128) 0.50 ms.  Full fp32
//    FMA: no tensor cores, no TF32 (ground truth must be bit-exact on
//    integer data, and exact_knn's stable sort turns any other rounding
//    into another tie order).
//    Design (pairwise_f32_kernel<KIND, float, VEC, false>): a
//    register-tiled SIMT product fed by a cp.async ring.
//    - 256 x 128 output tile per 256-thread block, a 16 x 8 register tile
//      per thread (query rows 4*ty + {0..3} + 64*{0..3}, corpus rows
//      4*tx + {0..3} + 64*{0,1}).  Each 16-byte shared-memory read carries
//      4 k values of one row, so a 4-deep k chunk costs 16 + 8 reads for
//      16 * 8 * 4 FMAs: 21 FMAs a read (5.3 a float), against 8 (2 a float)
//      in the earlier 64 x 64 / 4 x 4 form.  An 8 x 8 tile (16 FMAs a
//      read, the shared-memory pipe's own balance point against the FMA
//      pipe) was slower on an H100.
//    - Both operands are d-contiguous, so tiles keep the [row][k] layout
//      and are read as float4s along k.  Rows are padded to 20 floats and
//      the four 16-byte chunks of a row are XOR-swizzled by (row >> 3) & 3:
//      the 8 lanes of a quarter warp then read 8 distinct bank groups
//      (query-operand reads are broadcasts), and the per-row norm reads
//      are conflict-free too; the copies into the ring are at most 2-way.
//    - 16-deep k steps in a 4-stage ring of cp.async copies (16-byte
//      copies, zero-filled past the edges through the copy's src-size):
//      the loads of step s+3 are in flight during the FMAs of step s, with
//      one __syncthreads a step.  122,880 bytes of dynamic shared memory,
//      one block an SM at up to 255 registers.
//    - For l2, every thread accumulates the norms of 1.5 tile rows on
//      average (256 query rows, 128 corpus rows) from the same tiles; the
//      epilogue forms max(qn + xn - 2 acc, 0) or 1 - acc and stores
//      float4s where nx % 4 == 0, scalars on the ragged tail.
//    - Blocks walk the row tiles of one column tile back to back, so a
//      corpus tile is read from device memory once.
//    - d % 4 != 0 or an operand base that is not 16-byte aligned takes the
//      same kernel with 4-byte cp.async copies (VEC = false).
//    What holds it back: the FMA pipe shares its issue slots and its time
//    with the shared-memory reads and the per-step barrier; cuBLAS's own
//    fp32 product of the same operands (torch.mm, TF32 off, no norms and
//    no epilogue) is under 10% faster on an H100 (PERF.md), and a
//    persistent form that overlapped the output's write with the next
//    tile (TMA bulk stores) gained nothing.
//
// 3. gather distance, int8 -- replaces the Pallas kernel
//    repro/kernels/gather_distance.py::gather_distance_sq8
//    (_gather_dist_sq8_kernel).  Asymmetric distance computation against
//    SQ8 codes: with qs = u * scale (pre-scaled once by the caller),
//      cross = <qs_b, codes(b,i)>,  l2 = max((cn + |u|^2) - 2 cross, 0),
//      ip = 1 - cross,  cn = squared norm of the dequantized row,
//    and the same cache pass-through and slab / ids forms as kernel 1.
//    Bound: memory.  At the serving hop shape b=64, k=W*Mx=4*32=128, d=128
//    it moves 1.2 MB (~0.36 us at 3.35 TB/s), below one dependent round
//    trip to device memory: its time is latency, so the design shortens
//    the chain of dependent loads and keeps many loads in flight.
//    Design (gather_distance_sq8_kernel):
//    - one warp prices 16 candidates of one query; each 8-lane group owns
//      4 of them, and a lane reads 16 bytes of a code row a load, so one
//      warp instruction fetches 4 whole 128-byte rows;
//    - each lane holds its 16 dimensions of the query's qs row in
//      registers (4 float4s), read once a warp instead of once a
//      candidate;
//    - two serial round trips: the ids, mask bits, cached values and the
//      query slice first, then every code-row load and every cn[row] load
//      before any arithmetic;
//    - a 3-step shuffle within each 8-lane group, and one coalesced store
//      of the warp's 16 results;
//    - d % 16 != 0, or a qs or code base that is not 16-byte aligned,
//      takes the same kernel with byte loads (VEC = false).
//    __dp4a does not apply: the per-dimension scale keeps qs in fp32.
//
// 4. pairwise distance, int8 -- replaces the Pallas kernel
//    repro/kernels/l2_distance.py::pairwise_distance_sq8 (_dist_sq8_kernel).
//    With qs = q * scale (pre-scaled once by the caller), qn = |q|^2 and cn
//    the dequantized-row norms,
//      cross = <qs_i, codes_j>,  l2 = max((cn + qn) - 2 cross, 0),
//      ip = 1 - cross,  (nq,d) x (nx,d) int8 -> (nq,nx).
//    Bound: fp32 operations, 2*nq*nx*d = 33.6 GFLOP at (1000, 131072, 128),
//    0.5008 ms at 67 TFLOP/s (its 524 MB output takes 0.16 ms to write,
//    the codes 17 MB).  Full fp32 FMAs: the per-dimension scale keeps qs in
//    fp32 (no __dp4a, no int8 MMA, no TF32), and integer data stays
//    bit-exact.
//    Design: kernel 2's body with the corpus type as a parameter
//    (pairwise_f32_kernel<KIND, int8_t, VEC, CVEC>): the same tiles,
//    register tile, swizzled [row][k] fp32 layout, block order and float4
//    epilogue, and
//    - the codes staged as int8: one 16-byte cp.async a corpus row a step
//      into a 4-stage side ring of 2 KB stages (131,072 bytes of shared
//      memory in all);
//    - each code converted once, never in the FMA loop: a stage's codes are
//      widened into the fp32 corpus tile of the same ring stage, 8 codes a
//      thread, exactly (a byte permute forms the float 2^23 + (c + 128),
//      one fsub takes 2^23 + 128 off): 2,048 conversions against 524,288
//      FMAs a block a step.  Converting at the read instead would cost 32
//      conversions per 512 FMAs a thread, and int -> fp32 issues at an
//      eighth of the FMA rate;
//    - step s + 1's codes are widened at the end of step s, after its
//      FMAs, so a step still takes one __syncthreads (one more before the
//      loop, for step 0's codes).  The codes run one step ahead of the
//      query tile, in the same commit group, so step s's wait for its own
//      copies also covers step s + 1's codes and the copies keep kernel
//      2's lead of three steps (waiting for step s + 1's whole group, a
//      lead of two, ran slower: PERF.md);
//    - no norms in the loop: qn and cn go straight to shared memory while
//      the first copies are in flight, for the l2 epilogue;
//    - d % 16 != 0 or a code base that is not 16-byte aligned takes byte
//      loads of the codes (CVEC = false; an int8 row of d = 50 starts at
//      byte 50 r, where no 4-byte copy is legal), issued before a step's
//      FMAs and stored into the side ring after them; the query tile keeps
//      kernel 2's VEC rule.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KIND_L2 = 0;
constexpr int KIND_IP = 1;

// ---------------------------------------------------------------------------
// gather distance
// ---------------------------------------------------------------------------

constexpr int GATHER_THREADS = 256;   // 8 warps, one (query, candidate) each

template <int KIND, bool VEC4>
__global__ void gather_distance_kernel(const float* __restrict__ u,
                                       const float* __restrict__ rows,
                                       const int32_t* __restrict__ ids,
                                       const float* __restrict__ cached,
                                       const uint8_t* __restrict__ mask,
                                       float* __restrict__ out,
                                       int b, int k, int d) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<int64_t>(b) * k) return;   // warp-uniform exit
  const int64_t row = ids ? static_cast<int64_t>(ids[warp]) : warp;
  if (!mask[warp] || row < 0) {                       // warp-uniform branch
    if (lane == 0) out[warp] = cached[warp];
    return;
  }
  const float* __restrict__ c = rows + row * d;
  const float* __restrict__ q = u + (warp / k) * d;
  float acc = 0.f;
  if (VEC4) {
    const float4* c4 = reinterpret_cast<const float4*>(c);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int j = lane; j < (d >> 2); j += 32) {
      const float4 a = q4[j];
      const float4 x = c4[j];
      if (KIND == KIND_L2) {
        const float t0 = a.x - x.x, t1 = a.y - x.y;
        const float t2 = a.z - x.z, t3 = a.w - x.w;
        acc += t0 * t0 + t1 * t1 + t2 * t2 + t3 * t3;
      } else {
        acc += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
      }
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      if (KIND == KIND_L2) {
        const float t = q[j] - c[j];
        acc += t * t;
      } else {
        acc += q[j] * c[j];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[warp] = (KIND == KIND_L2) ? fmaxf(acc, 0.f) : 1.f - acc;
}

template <int KIND>
void launch_gather(const float* u, const float* rows, const int32_t* ids,
                   const float* cached, const uint8_t* mask, float* out,
                   int b, int k, int d, bool vec4, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(b) * k * 32;
  const unsigned grid =
      static_cast<unsigned>((threads + GATHER_THREADS - 1) / GATHER_THREADS);
  if (vec4)
    gather_distance_kernel<KIND, true><<<grid, GATHER_THREADS, 0, stream>>>(
        u, rows, ids, cached, mask, out, b, k, d);
  else
    gather_distance_kernel<KIND, false><<<grid, GATHER_THREADS, 0, stream>>>(
        u, rows, ids, cached, mask, out, b, k, d);
}

// ---------------------------------------------------------------------------
// gather distance, int8 codes (ADC)
// ---------------------------------------------------------------------------

constexpr int SQ8_THREADS = 128;              // 4 warps a block
constexpr int SQ8_SLOTS = 4;                  // candidates per 8-lane group
constexpr int SQ8_CPW = 4 * SQ8_SLOTS;        // candidates per warp

// acc + <q[0..15], the 16 int8 codes packed in w>
__device__ __forceinline__ float dot16_s8(const int4 w, const float4 q0,
                                          const float4 q1, const float4 q2,
                                          const float4 q3, float acc) {
  const int words[4] = {w.x, w.y, w.z, w.w};
  const float4 qv[4] = {q0, q1, q2, q3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = words[i];   // bytes low to high: dimensions 4i .. 4i+3
    acc = fmaf(qv[i].x, static_cast<float>(static_cast<int8_t>(v)), acc);
    acc = fmaf(qv[i].y, static_cast<float>(static_cast<int8_t>(v >> 8)),
               acc);
    acc = fmaf(qv[i].z, static_cast<float>(static_cast<int8_t>(v >> 16)),
               acc);
    acc = fmaf(qv[i].w, static_cast<float>(v >> 24), acc);
  }
  return acc;
}

// One warp: candidates [16 w', 16 w' + 16) of query qi; 8-lane group g
// owns candidates i0 = 16 w' + 4 g + {0..3}.  VEC: d % 16 == 0 and 16-byte
// aligned qs / codes bases, so lane s of a group reads 16-byte chunks
// s, s + 8, ... of each code row.
template <int KIND, bool VEC>
__global__ void __launch_bounds__(SQ8_THREADS)
gather_distance_sq8_kernel(const float* __restrict__ qs,
                           const float* __restrict__ qn,
                           const int8_t* __restrict__ codes,
                           const float* __restrict__ cn,
                           const int32_t* __restrict__ ids,
                           const float* __restrict__ cached,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ out, int b, int k, int d) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & 7;
  const int wpq = (k + SQ8_CPW - 1) / SQ8_CPW;      // warps per query
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * SQ8_THREADS + threadIdx.x) >> 5;
  if (warp >= static_cast<int64_t>(b) * wpq) return;   // warp-uniform exit
  const int64_t qi = warp / wpq;
  const int i0 = static_cast<int>(warp - qi * wpq) * SQ8_CPW +
                 (lane >> 3) * SQ8_SLOTS;
  const int64_t base = qi * k;                       // flat index of (qi, 0)
  const float* __restrict__ q = qs + qi * d;

  // round trip 1: the group's ids, mask bits and cached values (slab
  // form: codes (b,k,d) and cn (b,k) share the lane index; ids form: codes
  // (n,d) and cn (n) are indexed by the candidate id)
  int64_t row[SQ8_SLOTS];
  bool live[SQ8_SLOTS];
  float keep[SQ8_SLOTS];
#pragma unroll
  for (int t = 0; t < SQ8_SLOTS; ++t) {
    const bool in = i0 + t < k;
    const int64_t li = base + i0 + t;
    const int64_t r = !in ? -1 : ids ? static_cast<int64_t>(ids[li]) : li;
    const bool m = in && mask[li] != 0;
    live[t] = m && r >= 0;
    row[t] = live[t] ? r : 0;
    keep[t] = in ? cached[li] : 0.f;
  }
  const float qnorm = (KIND == KIND_L2) ? qn[qi] : 0.f;

  // round trip 2: every code-row load and every norm load, then the FMAs
  float cnv[SQ8_SLOTS];
#pragma unroll
  for (int t = 0; t < SQ8_SLOTS; ++t)
    cnv[t] = (KIND == KIND_L2 && live[t]) ? cn[row[t]] : 0.f;
  float acc[SQ8_SLOTS] = {0.f, 0.f, 0.f, 0.f};
  if (VEC) {
    const int nch = d >> 4;                          // 16-byte chunks a row
    for (int c = sub; c < nch; c += 8) {
      const float4* q4 = reinterpret_cast<const float4*>(q) + 4 * c;
      const float4 a0 = q4[0], a1 = q4[1], a2 = q4[2], a3 = q4[3];
      int4 w[SQ8_SLOTS];
#pragma unroll
      for (int t = 0; t < SQ8_SLOTS; ++t)
        w[t] = live[t] ? reinterpret_cast<const int4*>(codes + row[t] * d)[c]
                       : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int t = 0; t < SQ8_SLOTS; ++t)
        acc[t] = dot16_s8(w[t], a0, a1, a2, a3, acc[t]);
    }
  } else {
    for (int j = sub; j < d; j += 8) {
      const float a = q[j];
#pragma unroll
      for (int t = 0; t < SQ8_SLOTS; ++t)
        if (live[t])
          acc[t] =
              fmaf(a, static_cast<float>(codes[row[t] * d + j]), acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < SQ8_SLOTS; ++t)
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);

  // lane s < 4 of group g stores candidate i0 + s: the warp's 16 results
  // go out in one coalesced store
  if (sub < SQ8_SLOTS && i0 + sub < k) {
    float a = acc[0], cv = cnv[0], kp = keep[0];
    bool lv = live[0];
#pragma unroll
    for (int t = 1; t < SQ8_SLOTS; ++t)
      if (sub == t) {
        a = acc[t];
        cv = cnv[t];
        kp = keep[t];
        lv = live[t];
      }
    out[base + i0 + sub] =
        !lv ? kp
            : (KIND == KIND_L2) ? fmaxf((cv + qnorm) - 2.f * a, 0.f)
                                : 1.f - a;
  }
}

template <int KIND>
void launch_gather_sq8(const float* qs, const float* qn, const int8_t* codes,
                       const float* cn, const int32_t* ids,
                       const float* cached, const uint8_t* mask, float* out,
                       int b, int k, int d, bool vec, cudaStream_t stream) {
  const int64_t threads =
      static_cast<int64_t>(b) * ((k + SQ8_CPW - 1) / SQ8_CPW) * 32;
  const unsigned grid =
      static_cast<unsigned>((threads + SQ8_THREADS - 1) / SQ8_THREADS);
  if (vec)
    gather_distance_sq8_kernel<KIND, true>
        <<<grid, SQ8_THREADS, 0, stream>>>(qs, qn, codes, cn, ids, cached,
                                           mask, out, b, k, d);
  else
    gather_distance_sq8_kernel<KIND, false>
        <<<grid, SQ8_THREADS, 0, stream>>>(qs, qn, codes, cn, ids, cached,
                                           mask, out, b, k, d);
}

// ---------------------------------------------------------------------------
// pairwise distance in fp32 arithmetic over an fp32 or an int8 corpus:
// register-tiled SIMT product on a cp.async ring
// ---------------------------------------------------------------------------

constexpr int PW_THREADS = 256;                 // 16 (tx) x 16 (ty) threads
constexpr int PW_TY = PW_THREADS / 16;
constexpr int PW_TM = 16;                       // query rows per thread
constexpr int PW_TN = 8;                        // corpus rows per thread
constexpr int PW_BM = PW_TY * PW_TM;            // 256 query rows a block
constexpr int PW_BN = 16 * PW_TN;               // 128 corpus rows a block
constexpr int PW_BK = 16;                       // d elements per ring stage
constexpr int PW_LD = PW_BK + 4;                // padded row: 5 16-byte chunks
constexpr int PW_STAGES = 4;
constexpr int PW_STAGE_FLOATS = (PW_BM + PW_BN) * PW_LD;
constexpr int PW_SMEM_BYTES = PW_STAGES * PW_STAGE_FLOATS * 4;   // 122,880
// an int8 corpus adds a side ring of code tiles: 128 rows x 16 codes a stage
constexpr int PW_CODE_STAGE = PW_BN * PW_BK;                      // 2,048
constexpr int PW_SQ8_SMEM_BYTES =
    PW_SMEM_BYTES + PW_STAGES * PW_CODE_STAGE;                    // 131,072
// tile rows whose norm one thread accumulates (or, int8, reads)
constexpr int PW_NORMS = (PW_BM + PW_BN + PW_THREADS - 1) / PW_THREADS;

// Float offset of 16-byte chunk c (k = 4c .. 4c+3) of tile row r: rows
// padded to 20 floats, chunks XOR-swizzled by (r >> 3) & 3 (see the note
// at the top of the file).
__device__ __forceinline__ int pw_off(int r, int c) {
  return r * PW_LD + ((c ^ ((r >> 3) & 3)) << 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- or 4-byte async copy global -> shared; full == false zero-fills
// (src-size 0: nothing is read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool full) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(full ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy k columns [k0, k0 + 16) of the block's first ROWS tile rows (query
// rows, then corpus rows) into one ring stage; rows past nq / nx and
// columns past d are zero-filled.  An int8 corpus copies its query rows
// only (ROWS = PW_BM); its codes go through the side ring.
template <bool VEC, int ROWS = PW_BM + PW_BN>
__device__ __forceinline__ void pw_load_stage(float* stage,
                                              const float* __restrict__ q,
                                              const float* __restrict__ x,
                                              int nq, int nx, int d,
                                              int row0, int col0, int k0) {
  constexpr int PER_ROW = VEC ? PW_BK / 4 : PW_BK;   // copies per tile row
  constexpr int COPIES = ROWS * PER_ROW;
  static_assert(COPIES % PW_THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < COPIES / PW_THREADS; ++it) {
    const int e = threadIdx.x + it * PW_THREADS;
    const int rr = e / PER_ROW;                      // query rows, then corpus
    const int kk = (e % PER_ROW) * (VEC ? 4 : 1);
    const bool isx = ROWS > PW_BM && rr >= PW_BM;
    const int r = isx ? rr - PW_BM : rr;
    const int g = (isx ? col0 : row0) + r;
    const bool full = g < (isx ? nx : nq) && k0 + kk < d;
    const float* src =
        full ? (isx ? x : q) + static_cast<int64_t>(g) * d + k0 + kk : q;
    float* dst = stage + (isx ? PW_BM * PW_LD : 0) + pw_off(r, kk >> 2) +
                 (kk & 3);
    cp_async<VEC ? 16 : 4>(dst, src, full);
  }
}

// 16-byte copies of the codes of k columns [k0, k0 + 16) of the block's
// 128 corpus rows into one side-ring stage (d % 16 == 0, 16-byte aligned
// codes); rows past nx are zero-filled.
__device__ __forceinline__ void pw_copy_codes(int8_t* cstage,
                                              const int8_t* __restrict__ x,
                                              int nx, int d, int col0,
                                              int k0) {
  const int r = threadIdx.x;
  if (r < PW_BN) {
    const int g = col0 + r;
    const bool full = g < nx;
    cp_async<16>(cstage + PW_BK * r,
                 full ? x + static_cast<int64_t>(g) * d + k0 : x, full);
  }
}

// The byte-load form of pw_copy_codes: thread t reads codes
// k0 + 8 (t & 1) + {0..7} of corpus row t >> 1, zero past nx and d, packed
// low byte first; pw_store_codes puts them into a side-ring stage.
__device__ __forceinline__ uint2 pw_fetch_codes(const int8_t* __restrict__ x,
                                                int nx, int d, int col0,
                                                int k0) {
  const int g = col0 + (threadIdx.x >> 1);
  const int kk = k0 + 8 * (threadIdx.x & 1);
  uint32_t w[2] = {0u, 0u};
  if (g < nx) {
    const int8_t* __restrict__ src = x + static_cast<int64_t>(g) * d;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (kk + b < d)
        w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[kk + b]))
                     << (8 * (b & 3));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void pw_store_codes(int8_t* cstage, uint2 w) {
  *reinterpret_cast<uint2*>(cstage + 8 * threadIdx.x) = w;
}

// Widen one side-ring stage into the fp32 corpus tile xt: thread t converts
// the 4 codes of chunk t & 3 of rows t >> 2 and 64 + (t >> 2).  Exact for
// every int8 c: a byte permute forms the float 2^23 + (c + 128), and one
// fsub takes 2^23 + 128 off.
__device__ __forceinline__ void pw_widen(float* xt, const int8_t* cstage) {
#pragma unroll
  for (int p = 0; p < PW_BN * PW_BK / 4 / PW_THREADS; ++p) {
    const int e = threadIdx.x + p * PW_THREADS;
    const int r = e >> 2, c = e & 3;
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(cstage + PW_BK * r + 4 * c) ^
        0x80808080u;   // each byte c + 128
    float4 v;
    v.x = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - 8388736.f;
    v.y = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - 8388736.f;
    v.z = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - 8388736.f;
    v.w = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - 8388736.f;
    *reinterpret_cast<float4*>(xt + pw_off(r, c)) = v;
  }
}

// XT: the corpus type, float or int8_t (SQ8 codes).  VEC: 16-byte copies
// of the query tile (and of an fp32 corpus tile), else 4-byte copies.
// CVEC (int8 only): 16-byte copies of the codes, else byte loads.  qn / xn
// (int8 only): the l2 norms of the query rows and the dequantized corpus
// rows, read instead of accumulated from the tiles.
template <int KIND, typename XT, bool VEC, bool CVEC>
__global__ void __launch_bounds__(PW_THREADS, 1)
pairwise_f32_kernel(const float* __restrict__ q, const XT* __restrict__ x,
                    float* __restrict__ out, int nq, int nx, int d,
                    const float* __restrict__ qn,
                    const float* __restrict__ xn) {
  constexpr bool SQ8 = std::is_same<XT, int8_t>::value;
  extern __shared__ __align__(16) float ring[];
  __shared__ float norms[PW_BM + PW_BN];   // query rows, then corpus rows

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // the row tiles of one column tile run back to back, so each corpus
  // tile is read from device memory once
  const int64_t lin =
      static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int row0 = static_cast<int>(lin % gridDim.y) * PW_BM;
  const int col0 = static_cast<int>(lin / gridDim.y) * PW_BN;

  float acc[PW_TM][PW_TN];
#pragma unroll
  for (int i = 0; i < PW_TM; ++i)
#pragma unroll
    for (int j = 0; j < PW_TN; ++j) acc[i][j] = 0.f;
  // thread t: the norms of tile rows t, t + PW_THREADS, ... (query rows,
  // then corpus rows); an int8 corpus reads its norms instead
  float norm[PW_NORMS];
#pragma unroll
  for (int n = 0; n < PW_NORMS; ++n) norm[n] = 0.f;
  // int8: the code side ring after the fp32 ring; its stage s holds the
  // codes that are widened into the corpus tile of ring stage s
  int8_t* const codes = reinterpret_cast<int8_t*>(ring + PW_STAGES *
                                                  PW_STAGE_FLOATS);

  const int steps = (d + PW_BK - 1) / PW_BK;
  // int8: the codes run one step ahead of the query tile, in the same
  // commit group (group g holds the query tile of step g and the codes of
  // step g + 1; group 0 also step 0's), so that step s's wait also covers
  // the codes of step s + 1, which step s widens.  Codes of step t go to
  // side-ring stage t % PW_STAGES: 16-byte copies, or byte loads stored
  // at once.
#pragma unroll
  for (int s = 0; s < PW_STAGES - 1; ++s) {
    if (s < steps) {
      if constexpr (SQ8) {
        pw_load_stage<VEC, PW_BM>(ring + s * PW_STAGE_FLOATS, q, nullptr,
                                  nq, nx, d, row0, col0, s * PW_BK);
        for (int t = s == 0 ? 0 : s + 1; t <= s + 1 && t < steps; ++t) {
          if constexpr (CVEC)
            pw_copy_codes(codes + t * PW_CODE_STAGE, x, nx, d, col0,
                          t * PW_BK);
          else
            pw_store_codes(codes + t * PW_CODE_STAGE,
                           pw_fetch_codes(x, nx, d, col0, t * PW_BK));
        }
      } else {
        pw_load_stage<VEC>(ring + s * PW_STAGE_FLOATS, q, x, nq, nx, d,
                           row0, col0, s * PW_BK);
      }
    }
    cp_async_commit();
  }
  if constexpr (SQ8) {
    // the l2 norms go straight to norms[] while the copies are in flight;
    // the barrier below publishes them to the epilogue
    if (KIND == KIND_L2)
      for (int rr = tid; rr < PW_BM + PW_BN; rr += PW_THREADS) {
        const bool isx = rr >= PW_BM;
        const int g = (isx ? col0 - PW_BM : row0) + rr;
        norms[rr] = g < (isx ? nx : nq) ? (isx ? xn : qn)[g] : 0.f;
      }
    // step 0's codes are widened before the loop, step s + 1's during
    // step s
    cp_async_wait<PW_STAGES - 2>();
    __syncthreads();
    if (steps > 0) pw_widen(ring + PW_BM * PW_LD, codes);
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<PW_STAGES - 2>();   // this thread's copies of step s
    __syncthreads();                  // everyone's; step s-1's reads done
    const int next = s + PW_STAGES - 1;
    uint2 held = make_uint2(0u, 0u);   // int8 byte loads of step next + 1
    if constexpr (SQ8) {
      if (next < steps)
        pw_load_stage<VEC, PW_BM>(ring + (next % PW_STAGES) *
                                             PW_STAGE_FLOATS,
                                  q, nullptr, nq, nx, d, row0, col0,
                                  next * PW_BK);
      // side-ring stage s % PW_STAGES: its codes (step s) were widened
      // during step s - 1, before this step's barrier
      if (next + 1 < steps) {
        if constexpr (CVEC)
          pw_copy_codes(codes + (s % PW_STAGES) * PW_CODE_STAGE, x, nx, d,
                        col0, (next + 1) * PW_BK);
        else
          held = pw_fetch_codes(x, nx, d, col0, (next + 1) * PW_BK);
      }
    } else {
      if (next < steps)
        pw_load_stage<VEC>(ring + (next % PW_STAGES) * PW_STAGE_FLOATS, q,
                           x, nq, nx, d, row0, col0, next * PW_BK);
    }
    cp_async_commit();

    const float* qt = ring + (s % PW_STAGES) * PW_STAGE_FLOATS;
    const float* xt = qt + PW_BM * PW_LD;
    if (KIND == KIND_L2 && !SQ8) {
#pragma unroll
      for (int n = 0; n < PW_NORMS; ++n) {
        const int rr = tid + n * PW_THREADS;
        if (rr < PW_BM + PW_BN) {
          const float* nt = rr < PW_BM ? qt : xt;
          const int r = rr < PW_BM ? rr : rr - PW_BM;
#pragma unroll
          for (int c = 0; c < PW_BK / 4; ++c) {
            const float4 v =
                *reinterpret_cast<const float4*>(nt + pw_off(r, c));
            norm[n] = fmaf(v.x, v.x, norm[n]);
            norm[n] = fmaf(v.y, v.y, norm[n]);
            norm[n] = fmaf(v.z, v.z, norm[n]);
            norm[n] = fmaf(v.w, v.w, norm[n]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < PW_BK / 4; ++c) {
      float4 bv[PW_TN];
#pragma unroll
      for (int j = 0; j < PW_TN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(
            xt + pw_off(4 * tx + (j & 3) + 64 * (j >> 2), c));
#pragma unroll
      for (int i = 0; i < PW_TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            qt + pw_off(4 * ty + (i & 3) + 4 * PW_TY * (i >> 2), c));
#pragma unroll
        for (int j = 0; j < PW_TN; ++j) {
          acc[i][j] = fmaf(a.x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, bv[j].w, acc[i][j]);
        }
      }
    }
    if constexpr (SQ8)
      if (s + 1 < steps)
        pw_widen(ring + ((s + 1) % PW_STAGES) * PW_STAGE_FLOATS +
                     PW_BM * PW_LD,
                 codes + ((s + 1) % PW_STAGES) * PW_CODE_STAGE);
    // the byte loads were in flight during the FMAs
    if constexpr (SQ8 && !CVEC)
      if (next + 1 < steps)
        pw_store_codes(codes + (s % PW_STAGES) * PW_CODE_STAGE, held);
  }
  cp_async_wait<0>();

  if (KIND == KIND_L2 && !SQ8) {
#pragma unroll
    for (int n = 0; n < PW_NORMS; ++n)
      if (tid + n * PW_THREADS < PW_BM + PW_BN)
        norms[tid + n * PW_THREADS] = norm[n];
    __syncthreads();
  }
  const bool vec_out = (nx & 3) == 0;
#pragma unroll
  for (int i = 0; i < PW_TM; ++i) {
    const int rl = 4 * ty + (i & 3) + 4 * PW_TY * (i >> 2);
    const int r = row0 + rl;
    if (r >= nq) continue;
    float* __restrict__ orow = out + static_cast<int64_t>(r) * nx;
    const float qv = (KIND == KIND_L2) ? norms[rl] : 0.f;
#pragma unroll
    for (int h = 0; h < PW_TN / 4; ++h) {
      const int cl = 4 * tx + 64 * h;
      const int c = col0 + cl;
      if (c >= nx) continue;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = (KIND == KIND_L2) ? fmaxf(qv + norms[PW_BM + cl + u] -
                                             2.f * acc[i][4 * h + u],
                                         0.f)
                                 : 1.f - acc[i][4 * h + u];
      if (vec_out) {   // nx % 4 == 0 and c % 4 == 0: c + 3 < nx
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < nx) orow[c + u] = v[u];
      }
    }
  }
}

// Opt in to the ring's dynamic shared memory, then one block per
// 256 x 128 output tile on the caller's stream.
template <int KIND, typename XT, bool VEC, bool CVEC>
int launch_pairwise(const float* q, const XT* x, float* out, int nq, int nx,
                    int d, const float* qn, const float* xn,
                    cudaStream_t stream) {
  constexpr int smem = std::is_same<XT, int8_t>::value ? PW_SQ8_SMEM_BYTES
                                                       : PW_SMEM_BYTES;
  const auto kernel = pairwise_f32_kernel<KIND, XT, VEC, CVEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + PW_BN - 1) / PW_BN, (nq + PW_BM - 1) / PW_BM);
  kernel<<<grid, PW_THREADS, smem, stream>>>(q, x, out, nq, nx, d, qn, xn);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int KIND>
int launch_pairwise_f32(const float* q, const float* x, float* out, int nq,
                        int nx, int d, cudaStream_t stream) {
  if (d % 4 == 0 && aligned16(q) && aligned16(x))
    return launch_pairwise<KIND, float, true, false>(q, x, out, nq, nx, d,
                                                     nullptr, nullptr,
                                                     stream);
  return launch_pairwise<KIND, float, false, false>(q, x, out, nq, nx, d,
                                                    nullptr, nullptr, stream);
}

// The query tile keeps the fp32 rule (d % 4, 16-byte qs); the codes take
// 16-byte copies only where d % 16 == 0 and their base is 16-byte aligned
// (an int8 row of d = 50 starts at byte 50 r), and a query tile on 4-byte
// copies takes byte loads of the codes too.
template <int KIND>
int launch_pairwise_sq8(const float* qs, const float* qn,
                        const int8_t* codes, const float* cn, float* out,
                        int nq, int nx, int d, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && aligned16(qs);
  if (vec && d % 16 == 0 && aligned16(codes))
    return launch_pairwise<KIND, int8_t, true, true>(qs, codes, out, nq, nx,
                                                     d, qn, cn, stream);
  if (vec)
    return launch_pairwise<KIND, int8_t, true, false>(qs, codes, out, nq,
                                                      nx, d, qn, cn, stream);
  return launch_pairwise<KIND, int8_t, false, false>(qs, codes, out, nq, nx,
                                                     d, qn, cn, stream);
}

}  // namespace

extern "C" {

// Gather distance, both forms.  ids == nullptr selects the slab form
// (rows is the (b,k,d) slab); otherwise rows is the (n,d) corpus and
// ids the (b,k) int32 candidate ids.  cached/mask/out are (b,k);
// kind 0 = l2, 1 = ip.
int gather_distance_f32(const float* u, const float* rows, const int32_t* ids,
                        const float* cached, const uint8_t* mask, float* out,
                        int b, int k, int d, int kind, int vec4,
                        void* stream) {
  if (static_cast<int64_t>(b) * k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == KIND_IP)
    launch_gather<KIND_IP>(u, rows, ids, cached, mask, out, b, k, d,
                           vec4 != 0, s);
  else
    launch_gather<KIND_L2>(u, rows, ids, cached, mask, out, b, k, d,
                           vec4 != 0, s);
  return static_cast<int>(cudaGetLastError());
}

// Pairwise distance: q (nq,d), x (nx,d) -> out (nq,nx); kind 0 = l2, 1 = ip.
// 16-byte copies when d % 4 == 0 and both bases are 16-byte aligned.
int pairwise_distance_f32(const float* q, const float* x, float* out, int nq,
                          int nx, int d, int kind, void* stream) {
  if (static_cast<int64_t>(nq) * nx == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == KIND_IP)
    return launch_pairwise_f32<KIND_IP>(q, x, out, nq, nx, d, s);
  return launch_pairwise_f32<KIND_L2>(q, x, out, nq, nx, d, s);
}

// Gather distance against int8 codes, both forms.  qs (b,d) = u * scale,
// qn (b) = |u|^2.  ids == nullptr selects the slab form (codes (b,k,d),
// cn (b,k)); otherwise codes (n,d), cn (n) and ids (b,k) int32.  vec: d %
// 16 == 0 and 16-byte aligned qs and codes (16-byte code loads).
int gather_distance_sq8(const float* qs, const float* qn, const int8_t* codes,
                        const float* cn, const int32_t* ids,
                        const float* cached, const uint8_t* mask, float* out,
                        int b, int k, int d, int kind, int vec,
                        void* stream) {
  if (static_cast<int64_t>(b) * k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == KIND_IP)
    launch_gather_sq8<KIND_IP>(qs, qn, codes, cn, ids, cached, mask, out, b,
                               k, d, vec != 0, s);
  else
    launch_gather_sq8<KIND_L2>(qs, qn, codes, cn, ids, cached, mask, out, b,
                               k, d, vec != 0, s);
  return static_cast<int>(cudaGetLastError());
}

// Pairwise distance against int8 codes: qs (nq,d) = q * scale, qn (nq),
// codes (nx,d) int8, cn (nx) -> out (nq,nx); kind 0 = l2, 1 = ip.
int pairwise_distance_sq8(const float* qs, const float* qn,
                          const int8_t* codes, const float* cn, float* out,
                          int nq, int nx, int d, int kind, void* stream) {
  if (static_cast<int64_t>(nq) * nx == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == KIND_IP)
    return launch_pairwise_sq8<KIND_IP>(qs, qn, codes, cn, out, nq, nx, d, s);
  return launch_pairwise_sq8<KIND_L2>(qs, qn, codes, cn, out, nq, nx, d, s);
}

}  // extern "C"
