// Sparse-times-dense kernels for Hopper (sm_90a): K5 spmm and K6 spmm_t.
//
// Replaces the TPU kernels
//   K5  src/repro/kernels/spmm.py  spmm    (_spmm_kernel, _densify)
//       T (n, l) = W·Ω:   T[i] = Σ_j v[i, j]·Ω[idx[i, j], :]
//   K6  src/repro/kernels/spmm.py  spmm_t  (_spmm_t_kernel, _densify)
//       Y (p, l) = Wᵀ·T:  Y[c] = Σ_{(i, j): idx[i, j] = c} v[i, j]·T[i, :]
// for compact sparse rows W (values (n, m) f32, idx (n, m) int32 < p) and a
// narrow dense operand of l columns. Together they give the low-rank
// range-finder's delta Wᵀ(W·Ω) without densifying the (n, p) batch.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): operations at the
// low-rank path's shapes. Each product does 2·n·m·l flops (3.44 GFLOP at
// n = 4096, m = 3277, l = 128: 51 µs) against 143 MB of inputs and outputs
// (43 µs). The real cost is the gather: every kept coordinate reads a whole
// 512-byte row of Ω (or of T), 6.9 GB from L2 a call, which the bound does not
// count.
//
// The TPU kernel densifies a block of rows in VMEM and runs MXU matmuls; on
// Hopper the gather is direct.
//
// K5 design. One warp per row. Lane k holds columns [4k, 4k+4) of a 128-column
// chunk (a float4; one float when l is not a multiple of 4), so a warp reads
// one Ω row as one coalesced 512-byte load. The warp loads 32 (value, index)
// pairs at a time and broadcasts each with a shuffle. Ω (32 MiB at p = 65536,
// l = 128) stays in the 50 MB L2. The j order is fixed, so the result is the
// same on every launch.
//
// K6 design. A stable sort of the flat indices by column (done by the wrapper
// with torch.sort and searchsorted: index preparation the TPU kernel's body
// does not compute) gives each column its entries in row order. Then one warp
// per column sums v·T[i] over them in registers, in that order, and writes
// Y[c] once — no atomics, so repeated launches are bit-identical, as the TPU
// kernel's reduction grid is. On request the same walk also gives each
// column's Σv and Σv² (the range-finder's sum_w and diag): lane partials in
// a fixed order, then a butterfly of shuffles, so they too are bit-identical.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // 8 warps a block
constexpr int kWarps = kThreads / 32;

template <int VEC>
struct Acc {
  float a[VEC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = 0.f;
  }
  // a += v · row[0:VEC]
  __device__ __forceinline__ void fma_row(float v, const float* __restrict__ row) {
    if constexpr (VEC == 4) {
      const float4 d = *reinterpret_cast<const float4*>(row);
      a[0] = fmaf(v, d.x, a[0]);
      a[1] = fmaf(v, d.y, a[1]);
      a[2] = fmaf(v, d.z, a[2]);
      a[3] = fmaf(v, d.w, a[3]);
    } else {
      a[0] = fmaf(v, row[0], a[0]);
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ out) const {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(out) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
      out[0] = a[0];
    }
  }
};

// K5: warp w computes T[w, :]
template <int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_rows(const float* __restrict__ values, const int* __restrict__ idx,
          const float* __restrict__ dense, float* __restrict__ out, int n, int m, int ell) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* vrow = values + (long long)row * m;
  const int* irow = idx + (long long)row * m;
  for (int c0 = 0; c0 < ell; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < ell;
    Acc<VEC> acc;
    acc.zero();
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const float vj = j < m ? vrow[j] : 0.f;
      const int ij = j < m ? irow[j] : 0;
      const int cnt = m - j0 < 32 ? m - j0 : 32;
#pragma unroll 8
      for (int t = 0; t < cnt; ++t) {
        const float v = __shfl_sync(0xffffffffu, vj, t);
        const int i = __shfl_sync(0xffffffffu, ij, t);
        if (active) acc.fma_row(v, dense + (long long)i * ell + col);
      }
    }
    if (active) acc.store(out + (long long)row * ell + col);
  }
}

// K6: warp w computes Y[w, :] from its column's entries order[starts[w] .. starts[w+1]),
// and, when sum_v is not null, sum_v[w] = Σv and sum_v2[w] = Σv² over them
template <int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_t_cols(const float* __restrict__ values, const int* __restrict__ order,
            const int* __restrict__ starts, const float* __restrict__ t,
            float* __restrict__ out, float* __restrict__ sum_v, float* __restrict__ sum_v2,
            int p, int m, int ell) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= p) return;
  const int s = starts[c], e = starts[c + 1];
  float sv = 0.f, sv2 = 0.f;   // this lane's share of Σv and Σv², taken on the first chunk
  for (int c0 = 0; c0 == 0 || c0 < ell; c0 += 32 * VEC) {   // one chunk at least, for the sums
    const int col = c0 + lane * VEC;
    const bool active = col < ell;
    Acc<VEC> acc;
    acc.zero();
    for (int k0 = s; k0 < e; k0 += 32) {
      const int k = k0 + lane;
      const int pos = k < e ? order[k] : 0;
      const float vk = k < e ? values[pos] : 0.f;
      const int rk = pos / m;
      if (c0 == 0) {
        sv += vk;
        sv2 = fmaf(vk, vk, sv2);
      }
      const int cnt = e - k0 < 32 ? e - k0 : 32;
#pragma unroll 8
      for (int u = 0; u < cnt; ++u) {
        const float v = __shfl_sync(0xffffffffu, vk, u);
        const int r = __shfl_sync(0xffffffffu, rk, u);
        if (active) acc.fma_row(v, t + (long long)r * ell + col);
      }
    }
    if (active) acc.store(out + (long long)c * ell + col);
  }
  if (sum_v != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sv += __shfl_xor_sync(0xffffffffu, sv, o);
      sv2 += __shfl_xor_sync(0xffffffffu, sv2, o);
    }
    if (lane == 0) {
      sum_v[c] = sv;
      sum_v2[c] = sv2;
    }
  }
}

unsigned blocks_for(int rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

}  // namespace

// vec4 = 1 needs l % 4 == 0 and 16-byte aligned operands (the wrapper checks).
extern "C" int spmm_f32(const float* values, const int* idx, const float* dense, float* out,
                        int n, int m, int ell, int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    spmm_rows<4><<<blocks_for(n), kThreads, 0, s>>>(values, idx, dense, out, n, m, ell);
  } else {
    spmm_rows<1><<<blocks_for(n), kThreads, 0, s>>>(values, idx, dense, out, n, m, ell);
  }
  return (int)cudaGetLastError();
}

// sum_v and sum_v2 (p,) may both be null: then only Y is written.
extern "C" int spmm_t_f32(const float* values, const int* order, const int* starts,
                          const float* t, float* out, float* sum_v, float* sum_v2,
                          int p, int m, int ell, int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    spmm_t_cols<4><<<blocks_for(p), kThreads, 0, s>>>(values, order, starts, t, out, sum_v,
                                                      sum_v2, p, m, ell);
  } else {
    spmm_t_cols<1><<<blocks_for(p), kThreads, 0, s>>>(values, order, starts, t, out, sum_v,
                                                      sum_v2, p, m, ell);
  }
  return (int)cudaGetLastError();
}
