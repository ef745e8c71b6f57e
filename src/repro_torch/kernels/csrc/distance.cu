// fp32 distance kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels carry FastPGT's estimation path:
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
//    Bound: fp32 operations.  Ground truth at nq=1000, nx=100k, d=128 is
//    2*nq*nx*d = 25.6 GFLOP, ~0.38 ms at the H100 SXM's 67 TFLOP/s fp32
//    (the 400 MB output write takes ~0.12 ms).
//    Design: a shared-memory tiled SIMT product, 64x64 output tile per
//    256-thread block, 16-wide d steps, 4x4 outputs per thread in
//    registers; 128 threads also accumulate the tile's row norms from the
//    same shared tiles, and the epilogue forms the l2 / ip distance.  Full
//    fp32 FMA: no tensor cores, no TF32.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

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
// pairwise distance
// ---------------------------------------------------------------------------

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // corpus rows per block
constexpr int BK = 16;    // d elements per shared-memory step
constexpr int PAIR_THREADS = 256;

template <int KIND>
__global__ void __launch_bounds__(PAIR_THREADS)
pairwise_distance_kernel(const float* __restrict__ q,
                         const float* __restrict__ x,
                         float* __restrict__ out, int nq, int nx, int d) {
  __shared__ float qs[BK][BM + 4];   // transposed tiles: [d step][row]
  __shared__ float xs[BK][BN + 4];
  __shared__ float qnorm[BM];
  __shared__ float xnorm[BN];

  const int tid = threadIdx.x;
  const int ty = tid / 16;           // 16 x 16 threads, 4 x 4 outputs each
  const int tx = tid % 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;   // threads 0..63: query row norms, 64..127: corpus rows

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < BM * BK; e += PAIR_THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      qs[kk][r] = (gr < nq && gk < d)
                      ? q[static_cast<int64_t>(gr) * d + gk] : 0.f;
      const int gc = col0 + r;
      xs[kk][r] = (gc < nx && gk < d)
                      ? x[static_cast<int64_t>(gc) * d + gk] : 0.f;
    }
    __syncthreads();
    if (KIND == KIND_L2) {
      if (tid < BM) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) norm += qs[kk][tid] * qs[kk][tid];
      } else if (tid < BM + BN) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk)
          norm += xs[kk][tid - BM] * xs[kk][tid - BM];
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = xs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
  if (KIND == KIND_L2) {
    if (tid < BM) qnorm[tid] = norm;
    else if (tid < BM + BN) xnorm[tid - BM] = norm;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= nx) continue;
      float v;
      if (KIND == KIND_L2)
        v = fmaxf(qnorm[ty * 4 + i] + xnorm[tx * 4 + j] - 2.f * acc[i][j], 0.f);
      else
        v = 1.f - acc[i][j];
      out[static_cast<int64_t>(r) * nx + c] = v;
    }
  }
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
int pairwise_distance_f32(const float* q, const float* x, float* out, int nq,
                          int nx, int d, int kind, void* stream) {
  if (static_cast<int64_t>(nq) * nx == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nx + BN - 1) / BN, (nq + BM - 1) / BM);
  if (kind == KIND_IP)
    pairwise_distance_kernel<KIND_IP><<<grid, PAIR_THREADS, 0, s>>>(
        q, x, out, nq, nx, d);
  else
    pairwise_distance_kernel<KIND_L2><<<grid, PAIR_THREADS, 0, s>>>(
        q, x, out, nq, nx, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
