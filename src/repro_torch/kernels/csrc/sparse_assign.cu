// Sparsified K-means assignment for Hopper (sm_90a): K4 sparse_assign.
//
// Replaces the TPU kernel src/repro/kernels/sparse_assign.py sparse_assign
// (_kernel): for compact sparse rows (values, idx) of n samples and r sets of
// K centers over p coordinates,
//   dists[h, i, k] = Σ_j (values[i, j] − centers[h, k, idx[i, j]])²
//   argmin[h, i]   = the first k of least dists[h, i, k]   (as jnp.argmin)
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): memory. At the low-rank
// path's shape (n = 4096, m = 3277, r = 3, K = 10, p = 65536) the function
// reads 107 MB of values and indices and 7.9 MB of centers and writes 0.5 MB,
// ≈ 35 µs; its 3·n·m·K·r ≈ 1.2 GFLOP are ≈ 18 µs at the fp32 peak. What the
// bound does not count is the gather of the centers at every kept coordinate,
// which sets the time: one L2 access a kept coordinate at best.
//
// Design. The TPU kernel densified each row block in VMEM and ran two MXU
// products. Here the centers are first laid out by coordinate (layout_centers):
// (p, ld) with the S = r·K slots of coordinate c in row c, ld = S padded to
// whole float4s, so that all S center values of one coordinate share one
// 128-byte line (S ≤ 32). One warp walks one row's m kept coordinates once,
// so the row's values and indices come from device memory once, not r·K
// times, and each kept coordinate costs one read of its centers' line:
//
// - S > 16 (a step's r = 3, K = 10): lanes over slots. The warp loads 32
//   (value, index) pairs coalesced and broadcasts each by shuffle; lane s owns
//   slot s (hypothesis s / K, center s % K) and reads centers_t[idx, s], so
//   the warp reads the coordinate's one line together. Each batch of 32
//   coordinates goes into 8 interleaved partial sums, a fixed tree over them,
//   then into the lane's total. S > 32 walks the row once for each 32 slots.
// - S ≤ 16 (K-means++: r = 1, K = 5 or 1): lanes over coordinates. Lane t
//   takes coordinates t, t + 32, … and reads all S slots of each as one to
//   four float4s (one 32-byte sector for S ≤ 8), summing each slot in
//   registers; a butterfly of shuffles then gives every lane each slot's total.
//   Small S would leave most lanes idle in the first form.
//
// Both sum (v − c)² in the direct difference form (as
// repro.core.kmeans.sparse_sq_dists does, not the expansion
// Σv² − 2⟨w, μ⟩ + ⟨s, μ²⟩) in a fixed order, so the result is the same on
// every launch. The argmin, when every hypothesis lies within one warp's 32
// slots, is a shuffle reduction over each hypothesis's K lanes on
// (distance, k) taking the lexicographic minimum, NaN read as +inf; otherwise
// lane h scans hypothesis h's K written distances with a strict <. Either way
// it is the first k of least distance, as a strict-< scan from +inf gives.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // warps a block, one row each
constexpr int kParts = 8;  // interleaved partial sums in a batch of 32 coordinates
constexpr unsigned kFull = 0xffffffffu;

// centers (S, p) → centers_t (p, ld): centers_t[c, s] = centers[s, c], 0 for s ≥ S.
// A 32 × 32 tile through shared memory, so reads and writes are both coalesced.
__global__ void __launch_bounds__(256)
layout_centers(const float* __restrict__ centers, float* __restrict__ centers_t, int S, int p,
               int ld) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, s0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int k = ty; k < 32; k += 8) {
    const int s = s0 + k, c = c0 + tx;
    tile[k][tx] = (s < S && c < p) ? centers[(long long)s * p + c] : 0.f;
  }
  __syncthreads();
  for (int k = ty; k < 32; k += 8) {
    const int c = c0 + k, s = s0 + tx;
    if (c < p && s < ld) centers_t[(long long)c * ld + s] = tile[tx][k];
  }
}

// lane h < r: amin[h, i] = the first k of least dists[h, i, :], strict <
__device__ __forceinline__ void scan_argmin(const float* dists, int* amin, long long i, int n,
                                            int r, int K, int lane) {
  for (int h = lane; h < r; h += 32) {
    const float* d = dists + ((long long)h * n + i) * K;
    float best = INFINITY;
    int arg = 0;
    for (int k = 0; k < K; ++k) {
      if (d[k] < best) {
        best = d[k];
        arg = k;
      }
    }
    amin[(long long)h * n + i] = arg;
  }
}

// S > 16: lanes over slots
__global__ void __launch_bounds__(kWarps * 32)
assign_by_slot(const float* __restrict__ values, const int* __restrict__ idx,
               const float* __restrict__ centers_t, float* __restrict__ dists,
               int* __restrict__ amin, int n, int m, int r, int K, int ld) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // uniform across the warp
  const float* v = values + i * m;
  const int* ix = idx + i * m;
  const int S = r * K;

  for (int s0 = 0; s0 < S; s0 += 32) {  // one pass unless S > 32
    const int slot = s0 + lane;
    const bool live = slot < S;
    const float* c = centers_t + (live ? slot : 0);
    float acc = 0.f;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const float vj = j < m ? v[j] : 0.f;
      const int ij = j < m ? ix[j] : 0;
      float part[kParts];
#pragma unroll
      for (int k = 0; k < kParts; ++k) part[k] = 0.f;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const float vt = __shfl_sync(kFull, vj, t);
        const int it = __shfl_sync(kFull, ij, t);
        if (j0 + t < m) {  // uniform across the warp
          const float d = vt - __ldg(c + (long long)it * ld);
          part[t % kParts] = fmaf(d, d, part[t % kParts]);
        }
      }
      acc += ((part[0] + part[1]) + (part[2] + part[3])) +
             ((part[4] + part[5]) + (part[6] + part[7]));
    }
    const int h = slot / K, k = slot % K;
    if (live) dists[((long long)h * n + i) * K + k] = acc;

    if (S <= 32) {  // every hypothesis lies within the warp's lanes
      float best = (live && !isnan(acc)) ? acc : INFINITY;
      int arg = k;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float od = __shfl_down_sync(kFull, best, off);
        const int oa = __shfl_down_sync(kFull, arg, off);
        if (k + off < K && od < best) {  // the partner holds later k of the same hypothesis
          best = od;
          arg = oa;
        }
      }
      if (live && k == 0) amin[(long long)h * n + i] = arg;
    }
  }
  if (S > 32) {  // a hypothesis may straddle two passes: scan what was written
    __syncwarp();
    scan_argmin(dists, amin, i, n, r, K, lane);
  }
}

// S ≤ 4·V4 ≤ 16: lanes over coordinates
template <int V4>
__global__ void __launch_bounds__(kWarps * 32)
assign_by_coordinate(const float* __restrict__ values, const int* __restrict__ idx,
                     const float* __restrict__ centers_t, float* __restrict__ dists,
                     int* __restrict__ amin, int n, int m, int r, int K, int ld) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // uniform across the warp
  const float* v = values + i * m;
  const int* ix = idx + i * m;
  float acc[4 * V4];
#pragma unroll
  for (int s = 0; s < 4 * V4; ++s) acc[s] = 0.f;
#pragma unroll 4
  for (int j = lane; j < m; j += 32) {
    const float vj = v[j];
    const float4* c = reinterpret_cast<const float4*>(centers_t + (long long)ix[j] * ld);
#pragma unroll
    for (int q = 0; q < V4; ++q) {
      const float4 cq = __ldg(c + q);
      const float d0 = vj - cq.x, d1 = vj - cq.y, d2 = vj - cq.z, d3 = vj - cq.w;
      acc[4 * q] = fmaf(d0, d0, acc[4 * q]);
      acc[4 * q + 1] = fmaf(d1, d1, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(d2, d2, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(d3, d3, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int s = 0; s < 4 * V4; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[s] += __shfl_xor_sync(kFull, acc[s], off);
  }
  const int S = r * K;
#pragma unroll
  for (int s = 0; s < 4 * V4; ++s) {
    if (lane == s && s < S) dists[((long long)(s / K) * n + i) * K + s % K] = acc[s];
  }
  __syncwarp();
  scan_argmin(dists, amin, i, n, r, K, lane);
}

}  // namespace

// centers (r, K, p); centers_t a (p, ld) scratch with ld ≥ r·K, a multiple of 4
extern "C" int sparse_assign_f32(const float* values, const int* idx, const float* centers,
                                 float* centers_t, float* dists, int* amin, int n, int m, int r,
                                 int K, int p, int ld, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = r * K;
  layout_centers<<<dim3((p + 31) / 32, (ld + 31) / 32), 256, 0, s>>>(centers, centers_t, S, p, ld);
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  const int V4 = ld / 4;
  if (S > 16) {
    assign_by_slot<<<blocks, kWarps * 32, 0, s>>>(values, idx, centers_t, dists, amin, n, m, r,
                                                   K, ld);
  } else if (V4 == 1) {
    assign_by_coordinate<1><<<blocks, kWarps * 32, 0, s>>>(values, idx, centers_t, dists, amin,
                                                           n, m, r, K, ld);
  } else if (V4 == 2) {
    assign_by_coordinate<2><<<blocks, kWarps * 32, 0, s>>>(values, idx, centers_t, dists, amin,
                                                           n, m, r, K, ld);
  } else if (V4 == 3) {
    assign_by_coordinate<3><<<blocks, kWarps * 32, 0, s>>>(values, idx, centers_t, dists, amin,
                                                           n, m, r, K, ld);
  } else {
    assign_by_coordinate<4><<<blocks, kWarps * 32, 0, s>>>(values, idx, centers_t, dists, amin,
                                                           n, m, r, K, ld);
  }
  return (int)cudaGetLastError();
}
