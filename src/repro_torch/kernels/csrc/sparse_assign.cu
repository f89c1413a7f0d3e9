// Sparsified K-means assignment for Hopper (sm_90a): K4 sparse_assign.
//
// Replaces the TPU kernel src/repro/kernels/sparse_assign.py sparse_assign
// (_kernel): for compact sparse rows (values, idx) of n samples and r sets of
// K centers over p coordinates,
//   dists[h, i, k] = Σ_j (values[i, j] − centers[h, k, idx[i, j]])²
//   argmin[h, i]   = the first k of least dists[h, i, k]   (as jnp.argmin)
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): memory. At the stream's
// shape (n = 4096, m = 819, r = 3, K = 10, p = 16384) the function reads
// 26.8 MB of values and indices and 2.0 MB of centers and writes 0.5 MB,
// ≈ 8.7 µs; its 3·n·m·K·r ≈ 0.30 GFLOP are ≈ 4.5 µs at the fp32 peak.
//
// Design. The TPU kernel densified each row block in VMEM and ran two MXU
// products. On Hopper a gather is cheap and the r·K·p centers (2 MB here) stay
// in the 50 MB L2, so one warp owns one row and one hypothesis: lanes stride
// over the row's m kept coordinates, gather centers[h, k, idx] straight from
// memory, and sum the squared differences; a butterfly shuffle leaves the same
// total in every lane. The direct difference form keeps the reference's gather
// arithmetic (repro.core.kmeans.sparse_sq_dists) instead of the expansion
// Σv² − 2⟨w, μ⟩ + ⟨s, μ²⟩. The argmin scans k upwards with a strict <, so ties
// go to the lower index. Hypotheses are the grid's y axis: one launch covers
// all r of a step.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__global__ void __launch_bounds__(kWarps * 32)
sparse_assign_rows(const float* __restrict__ values, const int* __restrict__ idx,
                   const float* __restrict__ centers, float* __restrict__ dists,
                   int* __restrict__ amin, int n, int m, int K, int p) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // uniform across the warp
  const int h = blockIdx.y;
  const float* v = values + i * m;
  const int* ix = idx + i * m;
  const float* c_h = centers + (long long)h * K * p;
  float* d_out = dists + ((long long)h * n + i) * K;

  float best = INFINITY;
  int arg = 0;
  for (int k = 0; k < K; ++k) {
    const float* c = c_h + (long long)k * p;
    float acc = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float d = v[j] - __ldg(c + ix[j]);
      acc += d * d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) d_out[k] = acc;
    if (acc < best) {
      best = acc;
      arg = k;
    }
  }
  if (lane == 0) amin[(long long)h * n + i] = arg;
}

}  // namespace

extern "C" int sparse_assign_f32(const float* values, const int* idx, const float* centers,
                                 float* dists, int* amin, int n, int m, int r, int K, int p,
                                 void* stream) {
  dim3 grid((n + kWarps - 1) / kWarps, r);
  sparse_assign_rows<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      values, idx, centers, dists, amin, n, m, K, p);
  return (int)cudaGetLastError();
}
