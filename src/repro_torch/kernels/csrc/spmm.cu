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
// K5 design. Each kept coordinate needs a whole 512-byte row of Ω, and each Ω
// row is wanted by n·m/p sample rows (≈ 205 at the path's shape), so the
// windowed kernel shares those loads through shared memory. A block owns
// R = 96 rows (3 a warp) and walks its range of Ω's rows in windows of
// W = 160 rows, brought in by cp.async and double-buffered, so the next
// window loads while the block consumes this one. A sketch row's indices
// increase strictly, so a row's entries in a window are contiguous: each row
// has a ring of two halves of 32 (value, index) pairs in shared memory, the
// next half fetched by cp.async while this one is consumed, so no lane waits
// on device memory for its next pairs; a ballot over the lanes' indices
// counts the pairs that fall in the window, and for each the warp reads the
// pair by a broadcast load and FMAs v·Ω[idx − w0] from shared memory, lane k
// holding columns [4k, 4k+4) of a 128-column chunk (a float4; one float a
// lane of a 32-column chunk when l is not a multiple of 4). Ω's L2 traffic
// falls from n·m·l·4 bytes (6.9 GB) to (n/R)·p·l·4 (1.44 GB). To fill the
// card the coordinate range is split over S blocks a row tile (the rows'
// starting cursors by a 32-way search); the S partial (n, l) tiles are
// summed by a second pass in split order, so the result is deterministic,
// and with S = 1 each row's sum runs in j order with the same FMAs as the
// row kernel below, which makes it bit-equal. Before it, a pass (K6's pass 0,
// row_order) flags each row whose indices do not increase strictly; those
// rows go to the row kernel, one warp a row, which gathers Ω rows from L2 in
// j order. Where m/p is small (a few entries a row and window) the windows
// do not pay and spmm.py's spmm_plan sends every row to the row kernel; it
// also picks S. What bounds the windowed kernel is each entry's 512 bytes of
// shared-memory reads and the window barriers, not L2 (PERF.md §6).
//
// K6 design. First a transposition (index preparation the TPU kernel's body
// does not compute) turns the compact rows into columns: each column's
// (row, value) pairs, contiguous, in row order and within a row in j order,
// exactly the order of a stable sort of the flat indices by column. It is a
// counting sort over tiles of rows: per (tile, column) counts, a scan to
// column starts and to each tile's offset within each column, then the
// placement. Pass 0 flags each row whose indices increase strictly (every
// sketch's: a row holds a column at most once). Where all do and the fast
// passes' scratch fits in the entry arrays' size (2·n·m words: m/p above
// about 0.024), tiles are 64 rows: pass 0 also finds each row's boundaries at
// every 512 columns, pass 1 stores for each (tile, column) the 64-bit mask of
// the tile's rows that hold it (its popcount is the count), and an entry's
// rank in its column is the number of earlier rows in those masks, so a block
// places all its entries at once. Scattered 8-byte writes of pairs cost most
// (partial sectors), so the placement goes piece by piece of 512 columns, and
// each block stages its pairs column by column in shared memory and writes
// them run by run. Otherwise (the host picks that when the masks do not fit;
// pass 0 sets a flag on the device when a row does not increase, and the fast
// passes return at once) general passes walk each tile's rows in order, a
// slab of 32768 columns a block, with a cursor per column in shared memory:
// a row that increases is cut to the slab by binary search, any other is read
// whole, its repeats of a column ranked in j order with __match_any_sync.
// Their tiles are as wide as they must be for the counts (tiles·p words) to
// fit in the entry arrays' size. Every grid is one-dimensional, so no p or n
// meets a grid's y limit.
// Then one warp per column sums v·T[i] over its pairs in registers, in that
// order, and writes Y[c] once — no atomics, so repeated launches are
// bit-identical, as the TPU kernel's reduction grid is. On request the same
// walk also gives each column's Σv and Σv² (the range-finder's sum_w and
// diag): lane partials in a fixed order, then a butterfly of shuffles, so
// they too are bit-identical. The walk can also read the entries through a
// flat-position order (values[order[k]], row order[k] / m): the same
// arithmetic in the same order, kept to check the pair walk bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // 8 warps a block
constexpr int kWarps = kThreads / 32;
// the transposition's (python spmm.py mirrors kTileRows, kPiece and kScanBlock)
constexpr int kTileRows = 64;            // rows a tile: one bit each of a 64-bit mask
constexpr int kPiece = 512;              // columns a placement block holds
constexpr int kGroupTiles = 4;           // tiles a placement block places
constexpr int kGroupRows = kGroupTiles * kTileRows;
constexpr int kStage = 8192;             // pairs a placement block stages: 64 KB
constexpr int kMaskCols = 2048;          // columns a mask block holds, a multiple of kPiece
constexpr int kFastThreads = 512;        // threads of a placement or mask block
constexpr int kScanBlock = 256;          // columns a scan block sums
constexpr int kPlaceThreads = 1024;      // threads of a general block
constexpr int kSlab = 32768;             // columns a general block holds: 128 KB
constexpr int kPer = 4;                  // loads a thread has in flight
constexpr int kOrderThreads = 256;       // threads of a pass-0 block
// K5's windowed kernel (python spmm.py mirrors kWinRows and kWindow): warps
// a block, rows a warp, and Ω rows a window
constexpr int kWinWarps = 32;
constexpr int kRowsAWarp = 3;
constexpr int kWinRows = kWinWarps * kRowsAWarp;
constexpr int kWindow = 160;
// its shared memory: two windows of 32·vec columns, and each row's ring of
// 64 (value, index) pairs
constexpr int window_smem(int vec) { return 2 * kWindow * 32 * vec * 4 + kWinRows * 64 * 8; }
constexpr int kOrderChunk = 4 * kOrderThreads;   // entries of a row a pass-0 block reads

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

// K5, the row kernel: warp w computes T[w, :]; with general not null only the
// rows that unord flags, and nothing when no row is flagged
template <int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_rows(const float* __restrict__ values, const int* __restrict__ idx,
          const float* __restrict__ dense, float* __restrict__ out, const int* __restrict__ unord,
          const int* __restrict__ general, int n, int m, int ell) {
  if (general != nullptr && !*general) return;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n || (general != nullptr && !unord[row])) return;
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

// VEC floats from global to shared memory, asynchronously (cp.async)
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// the first j of the m increasing indices ix with ix[j] >= key, by the 32
// lanes of a warp together (a 32-way search: each step samples 32 places)
__device__ int warp_first_at_least(const int* __restrict__ ix, int m, int key, int lane) {
  int a = 0, b = m;   // the answer lies in [a, b]
  while (a < b) {
    const int step = (b - a + 31) / 32;
    const int at = a + lane * step;
    const unsigned below = __ballot_sync(0xffffffffu, at < b && ix[at] < key);
    const int cnt = __popc(below);   // the samples below key come first
    if (cnt == 0) break;             // ix[a] >= key
    b = a + cnt * step < b ? a + cnt * step : b;
    a += (cnt - 1) * step + 1;
  }
  return a;
}

// 4 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// K5, the windowed kernel: block b takes row tile b % tiles (kWinRows rows,
// warp w its rows w·kRowsAWarp …) and Ω's rows [lo, lo + span) of split
// b / tiles; with splits > 1 it writes its partial sums to out + split·n·l,
// else T itself. Rows that unord flags are left alone. Shared memory: two
// windows of kWindow × CW floats, then each row's ring of two halves of 32
// (value, index bits) pairs.
template <int VEC>
__global__ void __launch_bounds__(kWinWarps * 32)
spmm_windows(const float* __restrict__ values, const int* __restrict__ idx,
             const float* __restrict__ dense, float* __restrict__ out,
             const int* __restrict__ unord, int n, int m, int p, int ell, int splits, int span) {
  constexpr int CW = 32 * VEC;          // columns a chunk
  constexpr int RW = kRowsAWarp, W = kWindow, R = kWinRows;
  constexpr int kNone = 0x7fffffff;     // the index of a pair past the row's end
  extern __shared__ __align__(16) float win[];
  float2* ring = reinterpret_cast<float2*>(win + 2 * W * CW);   // [R][2][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (n + R - 1) / R;
  const int tile = blockIdx.x % tiles, sp = blockIdx.x / tiles;
  const int lo = sp * span;
  const int hi = p - lo < span ? p : lo + span;
  const int nwin = (hi - lo + W - 1) / W;
  float* dst = splits > 1 ? out + (long long)sp * n * ell : out;
  int rowi[RW];
  bool live[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    rowi[rr] = tile * R + warp * RW + rr;
    live[rr] = rowi[rr] < n && !unord[rowi[rr]];
  }
  // this lane's pair j0 + lane of row rr into half h of its ring
  auto fetch = [&](int rr, int h, int j0) {
    float2* slot = ring + ((warp * RW + rr) * 2 + h) * 32 + lane;
    const int j = j0 + lane;
    if (j < m) {
      const long long at = (long long)rowi[rr] * m + j;
      copy_async4(&slot->x, values + at);
      copy_async4(&slot->y, idx + at);
    } else {
      *slot = make_float2(0.f, __int_as_float(kNone));
    }
  };
  for (int c0 = 0; c0 < ell; c0 += CW) {
    const int col = c0 + lane * VEC;
    const bool active = col < ell;
    auto load = [&](int k) {
      const int w0 = lo + k * W;
      const int rows = hi - w0 < W ? hi - w0 : W;
      float* buf = win + (k & 1) * W * CW;
      for (int e = threadIdx.x; e < rows * (CW / VEC); e += kWinWarps * 32) {
        const int r = e / (CW / VEC), c = c0 + (e % (CW / VEC)) * VEC;
        if (c < ell) copy_async<VEC>(buf + r * CW + c - c0, dense + (long long)(w0 + r) * ell + c);
      }
      copy_commit();
    };
    Acc<VEC> acc[RW];
    int base[RW], used[RW], half[RW], bi[RW], fetched[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      acc[rr].zero();
      used[rr] = 0;
      half[rr] = 0;
      base[rr] = 0;
      fetched[rr] = -1;
      if (live[rr]) {
        base[rr] = lo == 0 ? 0 : warp_first_at_least(idx + (long long)rowi[rr] * m, m, lo, lane);
        fetch(rr, 0, base[rr]);
        fetch(rr, 1, base[rr] + 32);
      }
    }
    load(0);
    copy_wait<0>();
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
      bi[rr] = live[rr] ? __float_as_int(ring[((warp * RW + rr) * 2) * 32 + lane].y) : kNone;
    for (int k = 0; k < nwin; ++k) {
      if (k + 1 < nwin) {
        load(k + 1);
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
      __syncthreads();
      const int w0 = lo + k * W;
      const int wend = hi - w0 < W ? hi : w0 + W;
      const float* buf = win + (k & 1) * W * CW + lane * VEC;
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        if (!live[rr]) continue;
        while (true) {
          const unsigned in = __ballot_sync(0xffffffffu, lane >= used[rr] && bi[rr] < wend);
          const int end = used[rr] + __popc(in);
          const float2* pr = ring + ((warp * RW + rr) * 2 + half[rr]) * 32;
          int t = used[rr];
          if ((t & 1) && t < end) {
            const float2 q = pr[t];
            if (active) acc[rr].fma_row(q.x, buf + (__float_as_int(q.y) - w0) * CW);
            ++t;
          }
#pragma unroll 2
          for (; t + 2 <= end; t += 2) {
            const float4 two = *reinterpret_cast<const float4*>(pr + t);
            if (active) {
              acc[rr].fma_row(two.x, buf + (__float_as_int(two.y) - w0) * CW);
              acc[rr].fma_row(two.z, buf + (__float_as_int(two.w) - w0) * CW);
            }
          }
          if (t < end) {
            const float2 q = pr[t];
            if (active) acc[rr].fma_row(q.x, buf + (__float_as_int(q.y) - w0) * CW);
          }
          used[rr] = end;
          if (end < 32) break;
          // the half is spent: take the other, and fetch the pairs after it into this one
          const int spent = half[rr];
          half[rr] ^= 1;
          base[rr] += 32;
          used[rr] = 0;
          if (fetched[rr] == k) copy_wait<0>();   // fetched in this window: wait for it
          __syncwarp();
          bi[rr] = __float_as_int(ring[((warp * RW + rr) * 2 + half[rr]) * 32 + lane].y);
          __syncwarp();
          fetch(rr, spent, base[rr] + 32);
          copy_commit();
          fetched[rr] = k;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
      if (live[rr] && active) acc[rr].store(dst + (long long)rowi[rr] * ell + col);
    copy_wait<0>();   // no fetch is left in flight into the ring of the next chunk
    __syncthreads();
  }
}

// K5's second pass for splits > 1: T[i, c] = Σ_s partial[s, i, c] in split
// order, for the rows unord does not flag
__global__ void __launch_bounds__(kThreads)
sum_splits(const float* __restrict__ partial, const int* __restrict__ unord,
           float* __restrict__ out, int n, int ell, int splits) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long total = (long long)n * ell;
  if (e >= total || unord[e / ell]) return;
  float s = partial[e];
  for (int k = 1; k < splits; ++k) s += partial[k * total + e];
  out[e] = s;
}

// K6 walk: warp w computes Y[w, :] from its column's entries k in
// [starts[w], starts[w+1]) — pairs[k] = (row, value bits), or with PAIRS false
// values[order[k]] in row order[k] / m — and, when sum_v is not null,
// sum_v[w] = Σv and sum_v2[w] = Σv² over them
template <int VEC, bool PAIRS>
__global__ void __launch_bounds__(kThreads)
spmm_t_cols(const int2* __restrict__ pairs, const float* __restrict__ values,
            const int* __restrict__ order, const int* __restrict__ starts,
            const float* __restrict__ t, float* __restrict__ out, float* __restrict__ sum_v,
            float* __restrict__ sum_v2, int p, int m, int ell) {
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
      float vk;
      int rk;
      if constexpr (PAIRS) {
        const int2 pr = k < e ? pairs[k] : make_int2(0, 0);
        rk = pr.x;
        vk = __int_as_float(pr.y);
      } else {
        const int pos = k < e ? order[k] : 0;
        vk = k < e ? values[pos] : 0.f;
        rk = pos / m;
      }
      if (c0 == 0) {
        sv += vk;
        sv2 = fmaf(vk, vk, sv2);
      }
      const int cnt = e - k0 < 32 ? e - k0 : 32;
#pragma unroll 4   // measured faster than 8, 3, 2 or 1 at the range-finder's shape
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

// ---- K6 transposition. counts (tiles, p) holds each tile's count in each
// column, then its offset within the column.

// pass 0, block b: entries [ch·kOrderChunk, (ch + 1)·kOrderChunk) of row
// i = b / chunks (ch = b % chunks). Sets unord[i] and *general (both zeroed
// before) to 1 if an index there is at or below its left neighbour: the row
// may repeat a column, so the general passes run instead of the fast ones.
// With rs not null (the fast passes), rs[i, s] = the first j of row i with
// idx ≥ s·kPiece (rs[i, pieces] = m).
__global__ void __launch_bounds__(kOrderThreads)
row_order(const int* __restrict__ idx, int* __restrict__ rs, int* __restrict__ unord,
          int* __restrict__ general, int m, int pieces, int chunks) {
  const long long i = blockIdx.x / chunks;
  const int j0 = (blockIdx.x % chunks) * kOrderChunk;
  const int j1 = m - j0 < kOrderChunk ? m : j0 + kOrderChunk;
  const int* ix = idx + i * m;
  int* r = rs == nullptr ? nullptr : rs + i * (pieces + 1);
  auto piece = [&](int c) { return c < 0 ? 0 : (c / kPiece < pieces ? c / kPiece : pieces); };
  int unordered = 0;
#pragma unroll 4
  for (int j = j0 + threadIdx.x; j < j1; j += kOrderThreads) {
    const int c = ix[j];
    const int prev = j > 0 ? ix[j - 1] : 0;
    if (j > 0) unordered |= c <= prev;
    if (r == nullptr) continue;
    const int sc = piece(c);
    for (int s = j > 0 ? piece(prev) + 1 : 0; s <= sc; ++s) r[s] = j;
    if (j == m - 1)
      for (int s = sc + 1; s <= pieces; ++s) r[s] = m;
  }
  if (__syncthreads_or(unordered) && threadIdx.x == 0) {
    unord[i] = 1;
    *general = 1;
  }
}

// The entries of ROWS consecutive rows in pieces [s0, s1) as one flat range
// [0, first[ROWS]): each row's first j there (j0) and the flat index of its
// first entry (first), in shared memory; entry e is in row r = the last with
// first[r] ≤ e. blockDim.x ≥ ROWS.
template <int ROWS>
struct RowRanges {
  int first[ROWS + 1];
  int j0[ROWS];
  int warp_sum[ROWS / 32];

  // by every thread of the block
  __device__ void load(const int* __restrict__ rs, long long r0, long long r1, int pieces,
                       int s0, int s1) {
    const int t = threadIdx.x, lane = t & 31;
    int len = 0, incl = 0;
    if (t < ROWS) {
      const long long i = r0 + t;
      const int* r = rs + i * (pieces + 1);
      j0[t] = i < r1 ? r[s0] : 0;
      len = i < r1 ? r[s1] - r[s0] : 0;
      incl = len;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      if (lane == 31) warp_sum[t >> 5] = incl;
    }
    __syncthreads();
    if (t < ROWS) {
      for (int w = 0; w < (t >> 5); ++w) incl += warp_sum[w];
      first[t] = incl - len;
      if (t == ROWS - 1) first[ROWS] = incl;
    }
    __syncthreads();
  }
  __device__ int row_of(int e) const {
    int lo = 0, hi = ROWS;   // first[lo] ≤ e < first[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (first[mid] <= e) lo = mid; else hi = mid;
    }
    return lo;
  }
  // flat position in the rows of entry e, in row r0 + r
  __device__ long long pos(int e, int r, long long r0, int m) const {
    return (r0 + r) * m + j0[r] + e - first[r];
  }
};

// pass 1, fast, block b: tile t = b % tiles's row masks in the kMaskCols
// columns of block s = b / tiles (kMaskCols / kPiece pieces): bit r of
// masks[t, c] says whether row t·64 + r holds column c
__global__ void __launch_bounds__(kFastThreads)
piece_masks(const int* __restrict__ idx, const int* __restrict__ rs,
            const int* __restrict__ general, unsigned long long* __restrict__ masks, int n,
            int m, int p, int tiles, int pieces) {
  __shared__ unsigned rows_of[2][kMaskCols];   // rows 0–31 and 32–63 (native 32-bit atomics)
  __shared__ RowRanges<kTileRows> rr;
  if (*general) return;
  const int t = blockIdx.x % tiles, sb = blockIdx.x / tiles;
  const int lo = sb * kMaskCols;
  const int w = p - lo < kMaskCols ? p - lo : kMaskCols;
  for (int c = threadIdx.x; c < w; c += blockDim.x) rows_of[0][c] = rows_of[1][c] = 0;
  const long long r0 = (long long)t * kTileRows;
  const long long r1 = r0 + kTileRows < n ? r0 + kTileRows : n;
  const int s0 = sb * (kMaskCols / kPiece);
  rr.load(rs, r0, r1, pieces, s0, min(s0 + kMaskCols / kPiece, pieces));
  const int total = rr.first[kTileRows];
  for (int e0 = threadIdx.x; e0 < total; e0 += kPer * kFastThreads) {
    int c[kPer], r[kPer];   // the loads first, all in flight
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = e0 + u * kFastThreads;
      r[u] = e < total ? rr.row_of(e) : 0;
      c[u] = e < total ? idx[rr.pos(e, r[u], r0, m)] - lo : -1;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if ((unsigned)c[u] < (unsigned)w) atomicOr(&rows_of[r[u] >> 5][c[u]], 1u << (r[u] & 31));
  }
  __syncthreads();
  unsigned long long* out = masks + (long long)t * p + lo;
  for (int c = threadIdx.x; c < w; c += blockDim.x)
    out[c] = rows_of[0][c] | (unsigned long long)rows_of[1][c] << 32;
}

// the first j of the m increasing indices ix with ix[j] ≥ key
__device__ int first_at_least(const int* __restrict__ ix, int m, int key) {
  int a = 0, b = m;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (ix[mid] < key) a = mid + 1; else b = mid;
  }
  return a;
}

// The general passes' part of a row in columns [lo, lo + w): its entries
// [x, y), found by binary search where the row's indices increase strictly
// (not unord), else the whole row, whose entries the caller filters by column
__device__ int2 row_span(const int* __restrict__ ix, int m, int unord, int lo, int w) {
  if (unord) return make_int2(0, m);
  return make_int2(first_at_least(ix, m, lo), first_at_least(ix, m, lo + w));
}

// The general passes' rows [r0, r1) of a tile, kPlaceThreads at a time: each
// batch's spans in shared memory (a thread a row, the searches in parallel),
// then body(i, span) for its rows in order, by every thread of the block
template <typename Body>
__device__ void for_rows(const int* __restrict__ idx, const int* __restrict__ unord, int m,
                         long long r0, long long r1, int lo, int w, Body body) {
  __shared__ int2 spans[kPlaceThreads];
  for (long long b = r0; b < r1; b += kPlaceThreads) {
    const int nb = r1 - b < kPlaceThreads ? (int)(r1 - b) : kPlaceThreads;
    if ((int)threadIdx.x < nb) {
      const long long i = b + threadIdx.x;
      spans[threadIdx.x] = row_span(idx + i * m, m, unord[i], lo, w);
    }
    __syncthreads();
    for (int k = 0; k < nb; ++k) body(b + k, spans[k]);
    __syncthreads();   // the next batch rewrites spans
  }
}

// pass 1, general (any rows), block b: the counts of tile t = b % tiles (rows
// [t·rows, (t + 1)·rows)) in the kSlab columns of slab b / tiles
__global__ void __launch_bounds__(kPlaceThreads)
tile_counts(const int* __restrict__ idx, const int* __restrict__ unord,
            const int* __restrict__ general, int* __restrict__ counts, int n, int m, int p,
            int rows, int tiles) {
  if (!*general) return;
  extern __shared__ int cnt_slab[];
  const int t = blockIdx.x % tiles;
  const int lo = (blockIdx.x / tiles) * kSlab;
  const int w = p - lo < kSlab ? p - lo : kSlab;
  for (int c = threadIdx.x; c < w; c += blockDim.x) cnt_slab[c] = 0;
  __syncthreads();
  const long long r0 = (long long)t * rows;
  const long long r1 = r0 + rows < n ? r0 + rows : n;
  for_rows(idx, unord, m, r0, r1, lo, w, [&](long long i, int2 span) {   // in any order
    const int* ix = idx + i * m;
    for (int j = span.x + threadIdx.x; j < span.y; j += blockDim.x) {
      const int c = ix[j] - lo;
      if ((unsigned)c < (unsigned)w) atomicAdd(&cnt_slab[c], 1);
    }
  });
  int* out = counts + (long long)t * p + lo;
  for (int c = threadIdx.x; c < w; c += blockDim.x) out[c] = cnt_slab[c];
}

// pass 2, a thread a column: each tile's count in the column (the popcount of
// its mask, or the general count) becomes the tile's offset within the column,
// in counts; the block's column totals are scanned into starts[c] (exclusive,
// within the block) and the block's total goes to block_sums
__global__ void __launch_bounds__(kScanBlock)
tile_offsets(const unsigned long long* __restrict__ masks, const int* __restrict__ general,
             int* __restrict__ counts, int* __restrict__ starts, int* __restrict__ block_sums,
             int p, int tiles) {
  __shared__ int warp_total[kScanBlock / 32];
  const int tid = threadIdx.x;
  const long long c = (long long)blockIdx.x * kScanBlock + tid;
  const int gen = *general;
  int run = 0;
  if (c < p) {
    for (int t0 = 0; t0 < tiles; t0 += 4 * kPer) {
      int k[4 * kPer];   // the loads first, all in flight
#pragma unroll
      for (int u = 0; u < 4 * kPer; ++u) {
        const long long at = (long long)(t0 + u) * p + c;
        k[u] = t0 + u >= tiles ? 0 : gen ? counts[at] : __popcll(masks[at]);
      }
#pragma unroll
      for (int u = 0; u < 4 * kPer; ++u) {
        if (t0 + u < tiles) counts[(long long)(t0 + u) * p + c] = run;
        run += k[u];
      }
    }
  }
  int incl = run;   // the block's scan: each warp's by shuffles, then the warps' totals
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if ((tid & 31) >= o) incl += x;
  }
  if ((tid & 31) == 31) warp_total[tid >> 5] = incl;
  __syncthreads();
  for (int w = 0; w < (tid >> 5); ++w) incl += warp_total[w];
  if (c < p) starts[c] = incl - run;
  if (tid == kScanBlock - 1) block_sums[blockIdx.x] = incl;
}

// pass 3, one block: the block sums' exclusive prefix, in place (each thread
// sums a run of them, the block scans the runs' totals, each thread writes its
// run's prefixes); starts[p] = the total
__global__ void __launch_bounds__(kPlaceThreads)
scan_blocks(int* __restrict__ starts, int* __restrict__ block_sums, int p, int blocks) {
  __shared__ int part[kPlaceThreads];
  const int tid = threadIdx.x;
  const int per = (blocks + kPlaceThreads - 1) / kPlaceThreads;
  const int b0 = tid * per < blocks ? tid * per : blocks;
  const int b1 = b0 + per < blocks ? b0 + per : blocks;
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += block_sums[b];
  part[tid] = sum;
  __syncthreads();
  for (int off = 1; off < kPlaceThreads; off <<= 1) {
    const int add = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += add;
    __syncthreads();
  }
  int run = part[tid] - sum;
  for (int b = b0; b < b1; ++b) {
    const int x = block_sums[b];
    block_sums[b] = run;
    run += x;
  }
  if (tid == kPlaceThreads - 1) starts[p] = part[tid];
}

// pass 3b, a thread a column: starts[c] += its scan block's prefix
__global__ void __launch_bounds__(kPlaceThreads)
add_block_sums(int* __restrict__ starts, const int* __restrict__ block_sums, int p) {
  const long long c = (long long)blockIdx.x * kPlaceThreads + threadIdx.x;
  if (c < p) starts[c] += block_sums[c / kScanBlock];
}

// pass 4, fast, block b: places the entries of tile group g = b % groups
// (kGroupTiles tiles, kGroupRows rows) in the kPiece columns of piece
// b / groups. Rows increase strictly, so a column holds at most one entry of a
// row, and an entry's rank in its column within the group is the number of
// earlier rows in the column's masks. The group's entries of a column are one
// run of the column's pairs (its tiles are consecutive); they are staged in
// shared memory column by column and written run by run, so consecutive
// threads write consecutive pairs. A block of more than kStage entries writes
// each entry where it goes.
__global__ void __launch_bounds__(kFastThreads)
mask_place(const float* __restrict__ values, const int* __restrict__ idx,
           const int* __restrict__ rs, const int* __restrict__ general,
           const unsigned long long* __restrict__ masks, const int* __restrict__ offsets,
           const int* __restrict__ starts, int2* __restrict__ pairs, int n, int m, int p,
           int tiles, int pieces) {
  static_assert(kFastThreads == kPiece, "one thread a column of the piece");
  extern __shared__ int2 stage[];   // kStage
  __shared__ unsigned long long rows_of[kGroupTiles][kPiece];
  __shared__ int gbase[kPiece];
  __shared__ int col_first[kPiece + 1];
  __shared__ int warp_sum[kPiece / 32];
  __shared__ RowRanges<kGroupRows> rr;
  if (*general) return;
  const int groups = (tiles + kGroupTiles - 1) / kGroupTiles;
  const int t0 = (blockIdx.x % groups) * kGroupTiles;
  const int sp = blockIdx.x / groups;
  const int lo = sp * kPiece;
  const int w = p - lo < kPiece ? p - lo : kPiece;
  const long long r0 = (long long)t0 * kTileRows;
  const long long r1 = r0 + kGroupRows < n ? r0 + kGroupRows : n;
  // each column's masks, the group's first pair in it, and its count in the group
  const int col = threadIdx.x, lane = col & 31;
  int cnt = 0;
#pragma unroll
  for (int g = 0; g < kGroupTiles; ++g) {
    const unsigned long long mk =
        col < w && t0 + g < tiles ? masks[(long long)(t0 + g) * p + lo + col] : 0ull;
    rows_of[g][col] = mk;
    cnt += __popcll(mk);
  }
  if (col < w) gbase[col] = starts[lo + col] + offsets[(long long)t0 * p + lo + col];
  int incl = cnt;   // the counts' exclusive scan over the piece: each column's first slot
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_sum[col >> 5] = incl;
  __syncthreads();
  for (int v = 0; v < (col >> 5); ++v) incl += warp_sum[v];
  col_first[col] = incl - cnt;
  if (col == kPiece - 1) col_first[kPiece] = incl;
  rr.load(rs, r0, r1, pieces, sp, sp + 1);   // ends with __syncthreads
  const int total = rr.first[kGroupRows];
  const bool staged = total <= kStage;
  for (int e0 = threadIdx.x; e0 < total; e0 += kPer * kFastThreads) {
    int c[kPer], r[kPer];
    float v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = e0 + u * kFastThreads;
      r[u] = e < total ? rr.row_of(e) : 0;
      const long long pos = rr.pos(e, r[u], r0, m);
      c[u] = e < total ? idx[pos] - lo : -1;
      v[u] = e < total ? values[pos] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if ((unsigned)c[u] >= (unsigned)w) continue;
      const int g = r[u] / kTileRows, rt = r[u] % kTileRows;
      int rank = __popcll(rows_of[g][c[u]] & ((1ull << rt) - 1ull));
      for (int h = 0; h < g; ++h) rank += __popcll(rows_of[h][c[u]]);
      const int2 pr = make_int2((int)(r0 + r[u]), __float_as_int(v[u]));
      if (staged) stage[col_first[c[u]] + rank] = pr;
      else pairs[gbase[c[u]] + rank] = pr;
    }
  }
  if (!staged) return;
  __syncthreads();
  for (int k = threadIdx.x; k < total; k += kFastThreads) {
    int a = 0, b = kPiece;   // the column of slot k: col_first[a] ≤ k < col_first[b]
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (col_first[mid] <= k) a = mid; else b = mid;
    }
    pairs[gbase[a] + k - col_first[a]] = stage[k];
  }
}

// pass 4, general (any rows), block b: places the entries of tile t = b % tiles
// in the kSlab columns of slab b / tiles at their columns' cursors, its rows
// in order. A row whose indices increase strictly is placed by all threads at
// once; any other row 32 entries at a time by one warp, a column's repeats
// ranked in j order with __match_any_sync.
__global__ void __launch_bounds__(kPlaceThreads)
tile_place(const float* __restrict__ values, const int* __restrict__ idx,
           const int* __restrict__ unord, const int* __restrict__ general,
           const int* __restrict__ offsets, const int* __restrict__ starts,
           int2* __restrict__ pairs, int n, int m, int p, int rows, int tiles) {
  if (!*general) return;
  extern __shared__ int cur[];
  const int t = blockIdx.x % tiles;
  const int lo = (blockIdx.x / tiles) * kSlab;
  const int w = p - lo < kSlab ? p - lo : kSlab;
  const int* off = offsets + (long long)t * p + lo;
  for (int c = threadIdx.x; c < w; c += blockDim.x) cur[c] = starts[lo + c] + off[c];
  const long long r0 = (long long)t * rows;
  const long long r1 = r0 + rows < n ? r0 + rows : n;
  for_rows(idx, unord, m, r0, r1, lo, w, [&](long long i, int2 span) {
    const int* ix = idx + i * m;
    const float* v = values + i * m;
    if (!unord[i]) {   // the span's columns are all in the slab, each once
      for (int j = span.x + threadIdx.x; j < span.y; j += blockDim.x) {
        const int c = ix[j] - lo;
        const int dst = cur[c];
        cur[c] = dst + 1;
        pairs[dst] = make_int2((int)i, __float_as_int(v[j]));
      }
    } else if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int j = j0 + lane;
        const int c = j < m ? ix[j] - lo : -1;
        const bool mine = j < m && (unsigned)c < (unsigned)w;
        const unsigned peers = __match_any_sync(0xffffffffu, mine ? c : -1);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const int dst = mine ? cur[c] + rank : 0;
        __syncwarp();
        if (mine && rank == __popc(peers) - 1) cur[c] = dst + 1;   // the last repeat moves it
        __syncwarp();
        if (mine) pairs[dst] = make_int2((int)i, __float_as_int(v[j]));
      }
    }
    __syncthreads();   // the next row reads the cursors
  });
}

unsigned blocks_for(int rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

}  // namespace

// K5. splits = 0: the row kernel on every row. Otherwise pass 0 flags the
// rows that do not increase strictly, the windowed kernel (splits blocks a
// row tile, span Ω rows each, a multiple of the window) takes the others,
// the splits' partial sums are added in order, and the row kernel takes the
// flagged rows. scratch, int32 words: with splits > 1 splits·n·l floats of
// partial sums, then the flag and n row flags. vec4 = 1 needs l % 4 == 0 and
// 16-byte aligned operands (the wrapper checks).
extern "C" int spmm_f32(const float* values, const int* idx, const float* dense, float* out,
                        int* scratch, int n, int m, int p, int ell, int vec4, int splits, int span,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto rows = [&](const int* unord, const int* general) {
    if (vec4)
      spmm_rows<4><<<blocks_for(n), kThreads, 0, s>>>(values, idx, dense, out, unord, general, n,
                                                      m, ell);
    else
      spmm_rows<1><<<blocks_for(n), kThreads, 0, s>>>(values, idx, dense, out, unord, general, n,
                                                      m, ell);
    return (int)cudaGetLastError();
  };
  if (splits == 0) return rows(nullptr, nullptr);
  if (splits < 0 || span < 1) return (int)cudaErrorInvalidValue;
  float* partial = reinterpret_cast<float*>(scratch);   // first, for its float4 alignment
  int* general = scratch + (splits > 1 ? (long long)splits * n * ell : 0);
  int* unord = general + 1;
  const int smem = window_smem(vec4 ? 4 : 1);
  const long long blocks = (long long)((n + kWinRows - 1) / kWinRows) * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vec4 ? spmm_windows<4> : spmm_windows<1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(general, 0, sizeof(int) * (n + 1LL), s);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (m + kOrderChunk - 1) / kOrderChunk;
  row_order<<<(unsigned)((long long)n * chunks), kOrderThreads, 0, s>>>(idx, nullptr, unord,
                                                                       general, m, 0, chunks);
  float* dst = splits > 1 ? partial : out;
  (vec4 ? spmm_windows<4> : spmm_windows<1>)<<<(unsigned)blocks, kWinWarps * 32, smem, s>>>(
      values, idx, dense, dst, unord, n, m, p, ell, splits, span);
  if (splits > 1) {
    const long long total = (long long)n * ell;
    sum_splits<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(partial, unord,
                                                                                 out, n, ell, splits);
  }
  return rows(unord, general);
}

// The transposition: pairs (n·m) and starts (p + 1) from compact rows, over
// tiles of tile_rows rows. With fast (then tile_rows = kTileRows) the fast
// passes run, and the general ones only if a row's indices do not increase
// strictly; without it the general passes run. scratch, int32 words: with
// fast, 2·tiles·p for the masks (64-bit); always tiles·p counts; with fast,
// n·(pieces + 1) for the rows' pieces; always the flag, n row flags and
// ceil(p / kScanBlock) block sums (tiles = ceil(n / tile_rows), pieces =
// ceil(p / kPiece)). spmm.py's transpose_plan picks tile_rows and fast.
extern "C" int transpose_columns_f32(const float* values, const int* idx, int* scratch,
                                     int* starts, int2* pairs, int n, int m, int p,
                                     int tile_rows, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast && tile_rows != kTileRows) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + (long long)tile_rows - 1) / tile_rows;
  const int pieces = (p + kPiece - 1) / kPiece;
  const int scan_blocks_n = (p + kScanBlock - 1) / kScanBlock;
  int* at = scratch;
  unsigned long long* masks = nullptr;
  int* rs = nullptr;
  if (fast) {
    masks = reinterpret_cast<unsigned long long*>(at);
    at += 2 * tiles * p;
  }
  int* counts = at;
  at += tiles * p;
  if (fast) {
    rs = at;
    at += (long long)n * (pieces + 1);
  }
  int* general = at;   // then a flag a row, zeroed with it
  int* unord = general + 1;
  int* block_sums = unord + n;
  const int smem = 4 * (p < kSlab ? p : kSlab);
  cudaError_t err = cudaFuncSetAttribute(tile_counts, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tile_place, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mask_place, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStage * sizeof(int2));
  if (err == cudaSuccess) err = cudaMemsetAsync(general, 0, sizeof(int) * (n + 1LL), s);
  if (err == cudaSuccess && !fast) err = cudaMemsetAsync(general, 1, 1, s);   // the int 1
  if (err != cudaSuccess) return (int)err;
  // every grid one-dimensional, its tiles varying fastest
  const unsigned by_slab = (unsigned)(tiles * ((p + kSlab - 1) / kSlab));
  const int chunks = (m + kOrderChunk - 1) / kOrderChunk;
  row_order<<<(unsigned)((long long)n * chunks), kOrderThreads, 0, s>>>(idx, rs, unord, general, m,
                                                                       pieces, chunks);
  if (fast)
    piece_masks<<<(unsigned)(tiles * ((p + kMaskCols - 1) / kMaskCols)), kFastThreads, 0, s>>>(
        idx, rs, general, masks, n, m, p, (int)tiles, pieces);
  tile_counts<<<by_slab, kPlaceThreads, smem, s>>>(idx, unord, general, counts, n, m, p, tile_rows,
                                                   (int)tiles);
  tile_offsets<<<scan_blocks_n, kScanBlock, 0, s>>>(masks, general, counts, starts, block_sums,
                                                    p, (int)tiles);
  scan_blocks<<<1, kPlaceThreads, 0, s>>>(starts, block_sums, p, scan_blocks_n);
  add_block_sums<<<(p + kPlaceThreads - 1) / kPlaceThreads, kPlaceThreads, 0, s>>>(starts,
                                                                                 block_sums, p);
  if (fast)
    mask_place<<<(unsigned)((tiles + kGroupTiles - 1) / kGroupTiles * pieces), kFastThreads,
                 kStage * sizeof(int2), s>>>(values, idx, rs, general, masks, counts, starts,
                                             pairs, n, m, p, (int)tiles, pieces);
  tile_place<<<by_slab, kPlaceThreads, smem, s>>>(values, idx, unord, general, counts, starts,
                                                  pairs, n, m, p, tile_rows, (int)tiles);
  return (int)cudaGetLastError();
}

// The walk over the transposition's pairs (or, with pairs null, over the flat
// positions of a stable sort by column: values[order[k]], row order[k] / m).
// sum_v and sum_v2 (p,) may both be null: then only Y is written.
extern "C" int spmm_t_f32(const int* pairs, const float* values, const int* order,
                          const int* starts, const float* t, float* out, float* sum_v,
                          float* sum_v2, int p, int m, int ell, int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* pr = reinterpret_cast<const int2*>(pairs);
  if (pr != nullptr && vec4) {
    spmm_t_cols<4, true><<<blocks_for(p), kThreads, 0, s>>>(pr, values, order, starts, t, out,
                                                            sum_v, sum_v2, p, m, ell);
  } else if (pr != nullptr) {
    spmm_t_cols<1, true><<<blocks_for(p), kThreads, 0, s>>>(pr, values, order, starts, t, out,
                                                            sum_v, sum_v2, p, m, ell);
  } else if (vec4) {
    spmm_t_cols<4, false><<<blocks_for(p), kThreads, 0, s>>>(pr, values, order, starts, t, out,
                                                             sum_v, sum_v2, p, m, ell);
  } else {
    spmm_t_cols<1, false><<<blocks_for(p), kThreads, 0, s>>>(pr, values, order, starts, t, out,
                                                             sum_v, sum_v2, p, m, ell);
  }
  return (int)cudaGetLastError();
}
