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
// because a row does not fit VMEM. Here a row of p = C·2^CL floats (C = 2, 4,
// 8 or 16) fits the shared memory of one thread-block cluster: each of its C
// blocks holds one contiguous chunk of 2^CL values, padded as above: 2^14
// (66 KiB, two blocks an SM, so one block's loads overlap another's stages)
// where the row fits a cluster of such blocks, else 2^15 (132 KiB, one). So
// the whole transform is one read and one write of the row:
//   1. each block loads its chunk (signs applied in precondition mode) and runs
//      the stages h = 1 … 2^(CL-1) in its own shared memory (the phases above);
//   2. cluster.sync(); the log2(C) stages h = 2^CL … p/2 then combine values
//      at the same in-chunk offset o of all C chunks: each block takes 1/C of
//      the offsets, a thread reads the C values at o from every block's shared
//      memory (distributed shared memory, map_shared_rank), runs the stages in
//      registers, applies the 1/√p scale (and in unmix mode the signs) last
//      and writes the C outputs, coalesced across threads;
//   3. a block arrives at a cluster barrier once its reads of the peers'
//      chunks are done and waits on it just before it exits, since its peers
//      read its chunk.
// In gather mode (K1's function for 2^15 < p <= C_max·2^15), once that
// barrier completes, each block puts the 2^CL results it computed into its
// own shared memory and writes out[i, j] = row[idx[i, j]]·scale for the j
// whose positions it holds, scanning the row's indices, so neither the (n, p)
// intermediate nor a gather pass touches device memory. (Writing results back
// to their owners' chunks and gathering across blocks, the first design, cost
// more than the composition it replaces: PERF.md §6.)
// K2 with few rows. One block a row leaves most SMs idle when a call has fewer
// rows than the card has SMs (the finalize unmixes: 3 calls of at most 10
// rows at p = 2^14), and each row's stages run serially in its one block. So
// there the cluster kernel above takes the whole row too, in smaller chunks
// (2^11 to 2^13 values a block, C·2^CL = p <= 2^15): a row's loads, stages
// and writes spread over C SMs. fwht.split_plan picks (C, CL) from (n, p, the
// SM count, C_max): 2^11-value blocks, larger ones only where C_max caps C, so
// only the (C, CL) it can pick are built. The result is the same butterfly in
// the same order, bit-equal to the one-block kernel.
// Each instantiation's attributes (its dynamic shared memory, a cluster size
// above 8) are set once a device, at its first launch, not at every launch.
//
// C_max is the largest C for which cudaOccupancyMaxActiveClusters places a
// cluster of 132 KiB blocks (hadamard_max_cluster; 16 needs the non-portable
// cluster size). Above C_max·2^15 (up to 2^30) the cluster kernel runs first
// on every C_max·2^15 segment of a row (no scale), then register passes run
// the remaining stages, at most five index bits a pass: a thread loads the
// 2^E values of its group, which lie 2^lo apart, runs the E stages, and writes
// them back in place, coalesced; the last pass applies the scale (and the
// signs, in unmix mode). fwht.chunk_plan in Python mirrors this schedule.
// Every stage runs in the butterfly's order with the scale last, so K3 stays
// bit-equal to repro.core.ros.fwht.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLogE = 5;           // index bits per register phase
constexpr int kE = 1 << kLogE;     // elements a thread holds in a phase

// kChunkSigns / kChunkPlain: a row is one segment of a longer row (K3's first
// pass above C_max·2^15): signs indexed by the segment's place in its row, or
// none; no scale
enum Mode { kSignsBefore = 0, kSignsAfter = 1, kGather = 2, kChunkSigns = 3, kChunkPlain = 4 };

constexpr int kChunkLog = 15;      // K3: log2 of the largest chunk a block of a cluster holds
constexpr int kMaxClusterLog = 4;  // clusters of at most 16 blocks

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// cluster.sync() in two halves: this thread's earlier accesses are released
// at the arrive, and the wait returns once every thread of the cluster arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Run set() (a kernel's cudaFuncSetAttribute calls) once a device: ``done``
// holds a bit for each device it succeeded on. Two threads may both run it
// the first time, which is harmless.
template <typename F>
cudaError_t once_per_device(unsigned& done, F set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit)) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return err;
}

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
              const int* __restrict__ idx, float* __restrict__ out, int m, float scale) {
  using G = Geom<LOG_P>;
  extern __shared__ float row[];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * G::P;

  // all E loads of a thread are issued before the first store, so the row's
  // global reads are in flight together rather than one latency at a time
  float v[kE];
#pragma unroll
  for (int r = 0; r < G::E; ++r) v[r] = x[base + r * G::T + t];
#pragma unroll
  for (int r = 0; r < G::E; ++r) {
    const bool sign = MODE == kSignsBefore || MODE == kGather;
    row[strided<LOG_P>(r, t)] = sign ? v[r] * signs[r * G::T + t] : v[r];
  }
  __syncthreads();

  if constexpr (LOG_P > 0) phase<LOG_P, 0>(row, v, t);
  if constexpr (LOG_P > 5) phase<LOG_P, 5>(row, v, t);
  if constexpr (LOG_P > 10) phase<LOG_P, 10>(row, v, t);

  if constexpr (MODE == kGather) {
    const long long ob = (long long)blockIdx.x * m;
    for (int j = t; j < m; j += G::T) out[ob + j] = row[padded(idx[ob + j])] * scale;
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
             float scale, cudaStream_t stream) {
  using G = Geom<LOG_P>;
  static unsigned done = 0;
  cudaError_t err = once_per_device(done, [] {
    return cudaFuncSetAttribute(hadamard_rows<MODE, LOG_P>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  });
  if (err != cudaSuccess) return (int)err;
  hadamard_rows<MODE, LOG_P><<<n, G::T, G::SMEM, stream>>>(x, signs, idx, out, m, scale);
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

// K3: one cluster of C = 2^LOG_C blocks transforms one segment of C·2^CL
// floats; segment g = blockIdx.x / C, and block r of the cluster holds its
// chunk r of 2^CL floats (CL = 14: 66 KiB, two blocks an SM, so one block's
// loads overlap the other's stages; CL = 15: 132 KiB, one; CL = 11 … 13: K2's
// split of a row of at most 2^15 values when a call has few rows). MODE
// kSignsBefore / kSignsAfter / kGather: the segment is a whole row (seg_mask
// 0); kChunkSigns / kChunkPlain: one segment of a longer row, g & seg_mask its
// place there, no scale.
template <int MODE, int LOG_C, int CL>
__global__ void __launch_bounds__(Geom<CL>::T, CL == 14 ? 2 : 1)
hadamard_cluster(const float* __restrict__ x, const float* __restrict__ signs,
                 const int* __restrict__ idx, float* __restrict__ out, int m, float scale,
                 int seg_mask) {
  namespace cg = cooperative_groups;
  using G = Geom<CL>;
  constexpr int C = 1 << LOG_C;
  constexpr int kLen = 1 << CL;
  constexpr long long kSeg = (long long)C << CL;
  constexpr int PER = kE / C;            // offsets a thread takes in the high stages
  constexpr int kHalf = kE / 2;
  constexpr bool kLoadSigns = MODE == kSignsBefore || MODE == kGather || MODE == kChunkSigns;
  extern __shared__ float row[];
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int r = (int)cluster.block_rank();
  const long long g = blockIdx.x / C;
  const float* sg = signs + (MODE == kChunkSigns ? (g & seg_mask) * kSeg : 0);

  // 1. this block's chunk, in two halves whose values and signs are all in
  // flight before the half's first store; then the stages h = 1 … 2^(CL-1)
  {
    const float* xc = x + g * kSeg + ((long long)r << CL);
    const float* sc = sg + (r << CL);
    float v[kE];
#pragma unroll
    for (int h0 = 0; h0 < kE; h0 += kHalf) {
      float d[kHalf];
#pragma unroll
      for (int e = 0; e < kHalf; ++e) {
        v[h0 + e] = xc[(h0 + e) * G::T + t];
        d[e] = kLoadSigns ? sc[(h0 + e) * G::T + t] : 1.f;
      }
#pragma unroll
      for (int e = 0; e < kHalf; ++e)
        row[strided<CL>(h0 + e, t)] = kLoadSigns ? v[h0 + e] * d[e] : v[h0 + e];
    }
    __syncthreads();
    phase<CL, 0>(row, v, t);
    phase<CL, 5>(row, v, t);
    phase<CL, 10>(row, v, t);
  }
  cluster.sync();

  // 2. the high stages on offsets o = r·2^CL/C + q·T + t of every chunk k
  float h[PER][C];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int o = r * (kLen / C) + q * G::T + t;
#pragma unroll
    for (int k = 0; k < C; ++k) h[q][k] = *cluster.map_shared_rank(row + padded(o), k);
  }
#pragma unroll
  for (int s = 0; s < LOG_C; ++s) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (!(k & (1 << s))) {
          const float a = h[q][k], b = h[q][k | (1 << s)];
          h[q][k] = a + b;
          h[q][k | (1 << s)] = a - b;
        }
      }
    }
  }
  // every read of a peer's chunk is done (the stages consumed the values): the
  // arrive lets the peers go on, and this block waits only before it
  // overwrites its chunk or exits
  cluster_arrive();
  if constexpr (MODE == kGather) {
    // this block's results go into its own chunk (slot k·2^CL/C + q·T + t
    // holds position k·2^CL + o), and the block writes the kept values at the
    // positions it holds, scanning the row's indices (in any order)
    cluster_wait();
#pragma unroll
    for (int q = 0; q < PER; ++q)
#pragma unroll
      for (int k = 0; k < C; ++k) row[k * (kLen / C) + q * G::T + t] = h[q][k];
    __syncthreads();
    const long long ob = g * m;
    for (int j = t; j < m; j += G::T) {
      const int c = idx[ob + j];
      const int o = c & (kLen - 1);
      if (o / (kLen / C) == r) out[ob + j] = row[(c >> CL) * (kLen / C) + o % (kLen / C)] * scale;
    }
    return;   // no block reads another's chunk after the wait above
  } else {
    float* oseg = out + g * kSeg;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int o = r * (kLen / C) + q * G::T + t;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int at = (k << CL) + o;
        float y = h[q][k];
        if constexpr (MODE == kSignsBefore || MODE == kSignsAfter) y *= scale;
        if constexpr (MODE == kSignsAfter) y *= sg[at];
        oseg[at] = y;
      }
    }
  }
  cluster_wait();   // peers may still be reading this block's chunk
}

template <int MODE, int LOG_C, int CL>
cudaError_t cluster_attrs() {
  static unsigned done = 0;
  return once_per_device(done, [] {
    auto kernel = hadamard_cluster<MODE, LOG_C, CL>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Geom<CL>::SMEM);
    if (err == cudaSuccess && LOG_C > 3)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  });
}

template <int LOG_C, int CL>
cudaLaunchConfig_t cluster_config(long long segments, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(segments << LOG_C));
  cfg.blockDim = dim3(Geom<CL>::T);
  cfg.dynamicSmemBytes = Geom<CL>::SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << LOG_C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MODE, int LOG_C, int CL>
int launch_cluster_c(const float* x, const float* signs, const int* idx, float* out,
                     long long segments, int m, float scale, int seg_mask, cudaStream_t stream) {
  cudaError_t err = cluster_attrs<MODE, LOG_C, CL>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<LOG_C, CL>(segments, stream, attr);
  err = cudaLaunchKernelEx(&cfg, hadamard_cluster<MODE, LOG_C, CL>, x, signs, idx, out, m, scale,
                           seg_mask);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the cluster kernel on segments of 2^(chunk_log + log_c) floats; the chunk
// modes (a segment of a longer row) only with chunk_log 15, the gather mode
// with 14 or 15, and K2's split (chunk_log 11 … 13) for rows of at most 2^15
template <int MODE>
int launch_cluster(const float* x, const float* signs, const int* idx, float* out,
                   long long segments, int log_c, int chunk_log, int m, float scale,
                   int seg_mask, cudaStream_t s) {
  constexpr bool kWhole = MODE == kSignsBefore || MODE == kSignsAfter || MODE == kGather;
  constexpr bool kSplit = MODE == kSignsBefore || MODE == kSignsAfter;
  if (segments < 1 || (segments << log_c) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#define CLUSTER_CASE(LC, CL)                                                              \
  if (log_c == LC && chunk_log == CL)                                                     \
    return launch_cluster_c<MODE, LC, CL>(x, signs, idx, out, segments, m, scale, seg_mask, s);
  CLUSTER_CASE(1, 15) CLUSTER_CASE(2, 15) CLUSTER_CASE(3, 15) CLUSTER_CASE(4, 15)
  if constexpr (kWhole) {
    CLUSTER_CASE(1, 14) CLUSTER_CASE(2, 14) CLUSTER_CASE(3, 14) CLUSTER_CASE(4, 14)
  }
  if constexpr (kSplit) {
    CLUSTER_CASE(1, 11) CLUSTER_CASE(2, 11) CLUSTER_CASE(3, 11) CLUSTER_CASE(4, 11)
    CLUSTER_CASE(1, 12) CLUSTER_CASE(2, 12) CLUSTER_CASE(3, 12)
    CLUSTER_CASE(1, 13) CLUSTER_CASE(2, 13)
  }
#undef CLUSTER_CASE
  return (int)cudaErrorInvalidValue;
}

template <int LOG_C>
int active_clusters() {
  cudaError_t err = cluster_attrs<kSignsBefore, LOG_C, kChunkLog>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<LOG_C, kChunkLog>(1, nullptr, attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, hadamard_cluster<kSignsBefore, LOG_C, kChunkLog>,
                                       &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();   // a cluster size the card cannot place: clear the error, count none
    return 0;
  }
  return count;
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

// K2: H·(d ⊙ x), or d ⊙ (H·x), for p = 2^log_p <= 2^15: one block a row
// (log_c 0), or a row split over a cluster of 2^log_c blocks of 2^chunk_log
// values (chunk_log 11 … 13, chunk_log + log_c = log_p).
extern "C" int hd_precondition_f32(const float* x, const float* signs, float* out, int n,
                                   int log_p, int signs_after, float scale, int log_c,
                                   int chunk_log, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_c == 0) {
    if (signs_after) return launch<kSignsAfter>(x, signs, nullptr, out, n, log_p, 0, scale, s);
    return launch<kSignsBefore>(x, signs, nullptr, out, n, log_p, 0, scale, s);
  }
  if (n < 1 || log_p > kChunkLog || chunk_log < 11 || chunk_log > 13 || log_c < 1 ||
      chunk_log + log_c != log_p)
    return (int)cudaErrorInvalidValue;
  return signs_after
      ? launch_cluster<kSignsAfter>(x, signs, nullptr, out, n, log_c, chunk_log, 0, scale, 0, s)
      : launch_cluster<kSignsBefore>(x, signs, nullptr, out, n, log_c, chunk_log, 0, scale, 0, s);
}

extern "C" int sketch_fused_f32(const float* x, const float* signs, const int* idx, float* out,
                                int n, int log_p, int m, float scale, void* stream) {
  return launch<kGather>(x, signs, idx, out, n, log_p, m, scale, static_cast<cudaStream_t>(stream));
}

// The largest cluster of 132 KiB blocks that the card places (C_max: 16, 8,
// 4 or 2, after cudaOccupancyMaxActiveClusters), or 0 if none; a negative
// value is a cudaError_t from setting the kernel's attributes.
extern "C" int hadamard_max_cluster(void) {
  int counts[kMaxClusterLog + 1] = {0, active_clusters<1>(), active_clusters<2>(),
                                    active_clusters<3>(), active_clusters<4>()};
  for (int lc = kMaxClusterLog; lc >= 1; --lc) {
    if (counts[lc] < 0) return counts[lc];
    if (counts[lc] > 0) return 1 << lc;
  }
  return 0;
}

// K3: H·(d ⊙ x), or d ⊙ (H·x), for 2^15 < p <= 2^30 (log_p in (15, 30]):
// clusters of 2^log_c blocks of 2^chunk_log values (14 or 15) on segments of
// 2^(chunk_log + log_c) values — the whole row when that is log_p — then
// register passes for the rest (chunk_log 15 there).
extern "C" int hd_precondition_chunked_f32(const float* x, const float* signs, float* out, int n,
                                           int log_p, int signs_after, float scale, int log_c,
                                           int chunk_log, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int seg_log = chunk_log + log_c;
  if (log_p <= kChunkLog || log_p > 30 || n < 1 || log_c < 1 || log_c > kMaxClusterLog ||
      seg_log > log_p || (chunk_log != 14 && chunk_log != 15))
    return (int)cudaErrorInvalidValue;
  const long long segments = (long long)n << (log_p - seg_log);
  if (seg_log == log_p)
    return signs_after
        ? launch_cluster<kSignsAfter>(x, signs, nullptr, out, segments, log_c, chunk_log, 0, scale,
                                      0, s)
        : launch_cluster<kSignsBefore>(x, signs, nullptr, out, segments, log_c, chunk_log, 0,
                                       scale, 0, s);
  const int seg_mask = (1 << (log_p - seg_log)) - 1;
  int err = signs_after
      ? launch_cluster<kChunkPlain>(x, signs, nullptr, out, segments, log_c, chunk_log, 0, 1.0f,
                                    seg_mask, s)
      : launch_cluster<kChunkSigns>(x, signs, nullptr, out, segments, log_c, chunk_log, 0, 1.0f,
                                    seg_mask, s);
  for (int lo = seg_log; err == 0 && lo < log_p; lo += kLogE) {
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

// K1's function for p = 2^(chunk_log + log_c): values (n, m) =
// (H·(d ⊙ x))[i, idx[i, j]] in one cluster pass (the gather mode of K3's
// cluster kernel).
extern "C" int sketch_cluster_f32(const float* x, const float* signs, const int* idx, float* out,
                                  int n, int log_c, int chunk_log, int m, float scale,
                                  void* stream) {
  if (n < 1 || log_c < 1 || log_c > kMaxClusterLog) return (int)cudaErrorInvalidValue;
  return launch_cluster<kGather>(x, signs, idx, out, n, log_c, chunk_log, m, scale, 0,
                                 static_cast<cudaStream_t>(stream));
}
