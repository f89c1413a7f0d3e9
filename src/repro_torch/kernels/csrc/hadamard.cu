// Walsh-Hadamard kernels for Hopper (sm_90a): K1 sketch_fused, K2 hd_precondition
// and K3 hd_precondition_chunked.
//
// Replaces the TPU kernels
//   K1  src/repro/kernels/sketch_fused.py  sketch_fused  (_kernel)
//       values[i, j] = (H·(d ⊙ x_i))[idx[i, j]]
//   K2  src/repro/kernels/fwht.py          hd_precondition  (_kernel)
//       y = H·(d ⊙ x), and (for unmix) y = d ⊙ (H·x)
// for p a power of two up to 2^15, and
//   K3  src/repro/kernels/fwht.py          hd_precondition_chunked
//       (_factor_pass, _pass_kernel, _pass_signs_kernel)
//       the same transform for 2^15 < p <= 2^30.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): memory. A row of p floats
// is read once and m (K1) or p (K2) floats are written; the log2(p) butterfly
// stages cost p·log2(p) adds a row, 0.94 G adds for (4096, 16384) — about
// 14 µs at the fp32 peak against about 88 µs for the 295 MB K1 moves.
//
// Design. One block holds one row in shared memory (dynamic: 66 KiB at
// p = 2^14, 132 KiB at 2^15), multiplying it by the signs as it is loaded with
// coalesced reads. The butterflies run in phases of five index bits: in each
// phase a thread pulls 32 elements that differ only in those bits into
// registers, runs the five stages there, and writes them back; one
// __syncthreads() per phase. The kernel is instantiated for every log2(p), so
// the phase layout is known at compile time and every shared-memory address
// is a register plus a constant: with p a runtime value the index arithmetic,
// not the memory, bounded the kernel (about 25 integer operations per element
// per phase on the SM's 64 integer lanes). Stages run in the reference's order
// (h = 1, 2, …, p/2 with a+b, a−b) and the 1/√p scale comes last, so the result
// matches repro.core.ros.fwht bit for bit. The row is padded by one float
// every 32 so the strided phases do not conflict on shared-memory banks.
// K1 then writes only row[idx[i, j]]; K2 writes the whole row.
//
// K3. The TPU kernel splits a row into three Kronecker factors of order <= 512
// because a row does not fit VMEM. Here 2^15 floats fit one block's shared
// memory, so the schedule is the butterfly's own, cut by index bits:
//   pass 1  every contiguous chunk of 2^15 values is one row of the K2 kernel
//           above (signs applied on load in precondition mode, none in unmix
//           mode, no scale): stages h = 1 … 2^14, in shared memory;
//   pass 2+ the remaining stages h = 2^15 … p/2, at most five index bits a
//           pass: a thread loads the 2^E values of its group, which lie 2^lo
//           apart, into registers, runs the E stages, and writes them back in
//           place. Neighbouring threads take neighbouring offsets, so every
//           load and store is coalesced. The last pass applies the scale (and
//           the signs, in unmix mode).
// Up to p = 2^20 that is two passes over device memory, so at (4096, 65536)
// the kernel moves twice the 2.15 GB the bound counts and can reach at most
// half of it. Stage order and scale are the butterfly's, so K3 too is
// bit-equal to repro.core.ros.fwht.
#include <cuda_runtime.h>

namespace {

constexpr int kLogE = 5;           // index bits per register phase
constexpr int kE = 1 << kLogE;     // elements a thread holds in a phase

// kChunkSigns / kChunkPlain: a row is one 2^LOG_P chunk of a longer row (K3's
// first pass): signs indexed by the chunk's place in its row, or none; no scale
enum Mode { kSignsBefore = 0, kSignsAfter = 1, kGather = 2, kChunkSigns = 3, kChunkPlain = 4 };

constexpr int kChunkLog = 15;      // K3: log2 of the chunk that pass 1 transforms

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Shape of a row of 2^LOG_P floats: each of T threads holds E elements.
template <int LOG_P>
struct Geom {
  static_assert(0 <= LOG_P && LOG_P <= 15, "one row per block: p <= 2^15");
  static constexpr int P = 1 << LOG_P;
  static constexpr int E = 1 << (LOG_P < kLogE ? LOG_P : kLogE);
  static constexpr int T = P / E;
  static constexpr int SMEM = (P + (P >> 5) + 1) * (int)sizeof(float);
};

// The butterfly stages on index bits [LO, LO + EP) of the shared row. A thread
// holds PER groups of 2^EP elements that differ only in those bits; element
// vv of a group sits (vv << LO) past the group's first one, plus the padding
// that adds (one float per 32), so every address is a register plus a
// constant. LO is 0 or a multiple of 5.
template <int LOG_P, int LO>
__device__ __forceinline__ void phase(float* row, float (&v)[kE], int t) {
  constexpr int EP = LOG_P - LO < kLogE ? LOG_P - LO : kLogE;
  constexpr int PER = Geom<LOG_P>::E >> EP;
  int first[PER];
#pragma unroll
  for (int sub = 0; sub < PER; ++sub) {
    const int g = t * PER + sub;
    first[sub] = padded(((g >> LO) << (LO + EP)) | (g & ((1 << LO) - 1)));
  }
#pragma unroll
  for (int r = 0; r < Geom<LOG_P>::E; ++r) {
    const int vv = r & ((1 << EP) - 1);
    v[r] = row[first[r >> EP] + (vv << LO) + (LO >= 5 ? (vv << LO) >> 5 : 0)];
  }
#pragma unroll
  for (int s = 0; s < EP; ++s) {
#pragma unroll
    for (int r = 0; r < Geom<LOG_P>::E; ++r) {
      if (!(r & (1 << s))) {
        const float a = v[r], b = v[r | (1 << s)];
        v[r] = a + b;
        v[r | (1 << s)] = a - b;
      }
    }
  }
  // each element belongs to one thread within a phase: write back in place
#pragma unroll
  for (int r = 0; r < Geom<LOG_P>::E; ++r) {
    const int vv = r & ((1 << EP) - 1);
    row[first[r >> EP] + (vv << LO) + (LO >= 5 ? (vv << LO) >> 5 : 0)] = v[r];
  }
  __syncthreads();
}

// padded address of element r * T + t, the coalesced layout of loads and stores
template <int LOG_P>
__device__ __forceinline__ int strided(int r, int t) {
  constexpr int T = Geom<LOG_P>::T;
  if constexpr (T % 32 == 0) return r * (T + T / 32) + padded(t);
  return padded(r * T + t);
}

template <int MODE, int LOG_P>
__global__ void __launch_bounds__(Geom<LOG_P>::T)
hadamard_rows(const float* __restrict__ x, const float* __restrict__ signs,
              const int* __restrict__ idx, float* __restrict__ out, int m, float scale,
              int chunk_mask) {
  using G = Geom<LOG_P>;
  extern __shared__ float row[];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * G::P;
  if constexpr (MODE == kChunkSigns) signs += (blockIdx.x & chunk_mask) << LOG_P;

  // all E loads of a thread are issued before the first store, so the row's
  // global reads are in flight together rather than one latency at a time
  float v[kE];
#pragma unroll
  for (int r = 0; r < G::E; ++r) v[r] = x[base + r * G::T + t];
#pragma unroll
  for (int r = 0; r < G::E; ++r) {
    const bool sign = MODE == kSignsBefore || MODE == kGather || MODE == kChunkSigns;
    row[strided<LOG_P>(r, t)] = sign ? v[r] * signs[r * G::T + t] : v[r];
  }
  __syncthreads();

  if constexpr (LOG_P > 0) phase<LOG_P, 0>(row, v, t);
  if constexpr (LOG_P > 5) phase<LOG_P, 5>(row, v, t);
  if constexpr (LOG_P > 10) phase<LOG_P, 10>(row, v, t);

  if constexpr (MODE == kGather) {
    const long long ob = (long long)blockIdx.x * m;
    for (int j = t; j < m; j += G::T) out[ob + j] = row[padded(idx[ob + j])] * scale;
  } else if constexpr (MODE == kChunkSigns || MODE == kChunkPlain) {
#pragma unroll
    for (int r = 0; r < G::E; ++r) out[base + r * G::T + t] = row[strided<LOG_P>(r, t)];
  } else {
#pragma unroll
    for (int r = 0; r < G::E; ++r) {
      const float y = row[strided<LOG_P>(r, t)] * scale;
      out[base + r * G::T + t] = MODE == kSignsAfter ? y * signs[r * G::T + t] : y;
    }
  }
}

template <int MODE, int LOG_P>
int launch_p(const float* x, const float* signs, const int* idx, float* out, int n, int m,
             float scale, cudaStream_t stream, int chunk_mask = 0) {
  using G = Geom<LOG_P>;
  cudaError_t err = cudaFuncSetAttribute(hadamard_rows<MODE, LOG_P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  hadamard_rows<MODE, LOG_P><<<n, G::T, G::SMEM, stream>>>(x, signs, idx, out, m, scale,
                                                           chunk_mask);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(const float* x, const float* signs, const int* idx, float* out, int n, int log_p,
           int m, float scale, cudaStream_t stream) {
  switch (log_p) {
#define HADAMARD_CASE(L) \
  case L: return launch_p<MODE, L>(x, signs, idx, out, n, m, scale, stream);
    HADAMARD_CASE(0) HADAMARD_CASE(1) HADAMARD_CASE(2) HADAMARD_CASE(3)
    HADAMARD_CASE(4) HADAMARD_CASE(5) HADAMARD_CASE(6) HADAMARD_CASE(7)
    HADAMARD_CASE(8) HADAMARD_CASE(9) HADAMARD_CASE(10) HADAMARD_CASE(11)
    HADAMARD_CASE(12) HADAMARD_CASE(13) HADAMARD_CASE(14) HADAMARD_CASE(15)
#undef HADAMARD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K3, passes 2+: the stages on index bits [lo, lo + E) of every row of 2^log_p
// floats, in place. Thread g owns the 2^E values at first + r·2^lo; the low lo
// bits of g are the offset, so a warp touches 32 consecutive floats per load.
template <int E>
__global__ void __launch_bounds__(256)
hadamard_stride(float* __restrict__ y, const float* __restrict__ signs, long long groups,
                int log_p, int lo, int last, int signs_after, float scale) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long first = ((g >> lo) << (lo + E)) | (g & ((1LL << lo) - 1));
  float v[1 << E];
#pragma unroll
  for (int r = 0; r < (1 << E); ++r) v[r] = y[first + ((long long)r << lo)];
#pragma unroll
  for (int s = 0; s < E; ++s) {
#pragma unroll
    for (int r = 0; r < (1 << E); ++r) {
      if (!(r & (1 << s))) {
        const float a = v[r], b = v[r | (1 << s)];
        v[r] = a + b;
        v[r | (1 << s)] = a - b;
      }
    }
  }
  const long long pmask = (1LL << log_p) - 1;
#pragma unroll
  for (int r = 0; r < (1 << E); ++r) {
    const long long at = first + ((long long)r << lo);
    float o = v[r];
    if (last) {
      o *= scale;
      if (signs_after) o *= signs[at & pmask];
    }
    y[at] = o;
  }
}

template <int E>
int launch_stride(float* y, const float* signs, long long groups, int log_p, int lo, int last,
                  int signs_after, float scale, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hadamard_stride<E><<<(unsigned)blocks, kThreads, 0, stream>>>(y, signs, groups, log_p, lo,
                                                                last, signs_after, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hd_precondition_f32(const float* x, const float* signs, float* out, int n,
                                   int log_p, int signs_after, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (signs_after) return launch<kSignsAfter>(x, signs, nullptr, out, n, log_p, 0, scale, s);
  return launch<kSignsBefore>(x, signs, nullptr, out, n, log_p, 0, scale, s);
}

extern "C" int sketch_fused_f32(const float* x, const float* signs, const int* idx, float* out,
                                int n, int log_p, int m, float scale, void* stream) {
  return launch<kGather>(x, signs, idx, out, n, log_p, m, scale, static_cast<cudaStream_t>(stream));
}

// K3: H·(d ⊙ x), or d ⊙ (H·x), for 2^15 < p <= 2^30 (log_p in (15, 30]); n·p/2^15
// must stay below 2^31 (one block per chunk in pass 1).
extern "C" int hd_precondition_chunked_f32(const float* x, const float* signs, float* out, int n,
                                           int log_p, int signs_after, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_p <= kChunkLog || log_p > 30 || n < 1) return (int)cudaErrorInvalidValue;
  const long long chunks = (long long)n << (log_p - kChunkLog);
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int chunk_mask = (1 << (log_p - kChunkLog)) - 1;
  int err = signs_after
      ? launch_p<kChunkPlain, kChunkLog>(x, signs, nullptr, out, (int)chunks, 0, 1.0f, s, chunk_mask)
      : launch_p<kChunkSigns, kChunkLog>(x, signs, nullptr, out, (int)chunks, 0, 1.0f, s, chunk_mask);
  for (int lo = kChunkLog; err == 0 && lo < log_p; lo += kLogE) {
    const int e = log_p - lo < kLogE ? log_p - lo : kLogE;
    const int last = lo + e == log_p;
    const long long groups = ((long long)n << log_p) >> e;
    switch (e) {
      case 1: err = launch_stride<1>(out, signs, groups, log_p, lo, last, signs_after, scale, s); break;
      case 2: err = launch_stride<2>(out, signs, groups, log_p, lo, last, signs_after, scale, s); break;
      case 3: err = launch_stride<3>(out, signs, groups, log_p, lo, last, signs_after, scale, s); break;
      case 4: err = launch_stride<4>(out, signs, groups, log_p, lo, last, signs_after, scale, s); break;
      default: err = launch_stride<5>(out, signs, groups, log_p, lo, last, signs_after, scale, s); break;
    }
  }
  return err;
}
