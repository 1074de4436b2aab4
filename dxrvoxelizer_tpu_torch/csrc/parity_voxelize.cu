// Parity solid voxelization over binned 32x32-column tiles (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/voxelize_pallas.py::_parity_kernel
// (launched by voxelize_parity_tiles). Same computation: for every column
// of a tile and every triangle binned to that tile, three edge functions
// with the top-left tie rule decide coverage of the column center; the
// crossing depth z = zx*px + zy*py + zo gives the cutoff m = clip(ceil z,
// 0, N); the column's voxels k < m flip once per covered crossing. Occupancy
// is the parity of the flips. The words are bit-identical to the plain
// version (every column of every tile, a counting reduction) and to the
// oracle.
//
// What bounds it on the card: the binning rows of a tile (64 bytes each,
// read once) and the words (written once), once each row is tested only on
// the columns it can cover: at 64^3 a binned triangle's bounding box holds
// at most one column centre, so the function needs about one (column, row)
// pair per row, and the kernel tests at most nine (its box widened by one
// column). Testing every column of the tile against every row, the parent
// kernel's work, is 2,000 times the pairs the function needs there.
//
// Design: in the span layouts (the main path) each row carries its span,
// spans[tile][row] = x_lo x_hi y_lo y_hi (int16, the bounding box the
// binning uses), and the kernel tests it only on the columns the span rule
// of csrc/parity_common.cuh picks (the span widened by one column and
// clipped to the tile, or the whole tile for a sliver: the rule and the pair
// test it shares with the work-queue kernel, csrc/parity_queue.cu). A tile
// walks only its real rows, counts[tile] (its run plus the overflow rows);
// the padding rows after them are never loaded. Each warp stages a slice of
// 32 rows (the slice's 2 KiB copied with neighbouring lanes on neighbouring
// 16 bytes, the next slice's copy in flight). When no row of the slice spans
// more than 32 columns (every row at 64^3 but a sliver's) each lane loops
// over its own row's pairs, the row in registers; otherwise the slice's
// pairs spread over the lanes, each finding its row by a 5-step search of
// the scanned pair counts. A covered crossing XORs ONE bit, at m - 1, into a
// crossing-bit field of 1024 columns x N/32 words in shared memory. The
// suffix parity of that field is the occupancy. Two ways to split a tile's
// rows across blocks:
// - tile (the main path): a cluster of `splits` blocks per tile (1 to 16),
//   each folding a contiguous part of the tile's rows into its own field;
//   after a cluster barrier each block XORs the cluster's fields for its
//   share of the tile's columns through distributed shared memory, takes the
//   suffix parity and stores those columns' words once. One launch, no
//   memset, no device-memory atomics.
// - split: `splits` blocks per tile, each taking the suffix parity of its
//   own field (suffix parity is linear over XOR) and XORing its non-zero
//   words into a zeroed output with atomicXor (a memset before the launch).
// And the parent's layout, kept for callers without spans and for the sweep:
// - column: one thread per column of a tile (1024 per block), a block per
//   128 rows of the tile staged in shared memory and read by every thread
//   (a broadcast), the prefix mask "bits k < m" XORed into the column's
//   words in registers, then atomicXor into a zeroed output. With counts,
//   the blocks past a tile's real rows return before loading.
// chip_smoke.py (phase 5c) times the layouts at the 64^3 frame's bins;
// dxv_parity_voxelize runs the layout and split chosen there. XOR is
// associative and commutative, so every layout is bit-exact in any order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "parity_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dxv_parity;

constexpr int kTile = 32;
constexpr int kCols = kTile * kTile;  // columns per tile
constexpr int kColumnRows = 128;  // rows per block of the column layout
constexpr int kMaxCluster = 16;  // the largest cluster (above 8: non-portable)
constexpr int kRowLoop = 32;  // a slice's largest row that lanes loop over
// the layouts (dxv_parity_voxelize_variant's `layout`)
constexpr int kLayoutTile = 0, kLayoutSplit = 1, kLayoutColumn = 2;
// the main path's layout, blocks per tile and threads per block
// (chip_smoke.py phase 5c)
constexpr int kMainLayout = kLayoutTile;
constexpr int kMainSplits = 16;
constexpr int kMainThreads = 512;
// above this much shared memory per block (N > 512) a 16-block cluster may
// not fit one GPC: the main path takes 8 blocks per tile there
constexpr size_t kWideClusterSmem = 128 * 1024;

// shared memory of one block of the span layouts: per warp 32 staged rows,
// their pair scan and packed columns; then the tile's crossing-bit field
template <int NT>
struct Smem {
  static constexpr size_t rows = 0;  // [NT] rows x 4 float4
  static constexpr size_t pre = rows + NT * kCoef * sizeof(float);
  static constexpr size_t span = pre + NT * sizeof(int);
  static constexpr size_t field = span + NT * sizeof(int);  // [W][1024]
  static size_t bytes(int w_words) {
    return field + static_cast<size_t>(w_words) * kCols * sizeof(unsigned);
  }
};

// the index of the first word of tile column l (x_local = l / 32, y_local =
// l % 32) in the words [N, N, N/32]
__device__ __forceinline__ size_t column_base(int ox, int oy, int l, int n) {
  return (static_cast<size_t>(ox + (l >> 5)) * n + oy + (l & 31)) * (n >> 5);
}

// kCluster (layout tile): block b is part b % splits of tile b / splits, in
// a cluster of the tile's `splits` blocks; else (layout split) the same
// parts, combined in device memory by atomicXor. NT threads per block.
template <bool kCluster, int NT>
__global__ void __launch_bounds__(NT)
parity_kernel_span(const float* __restrict__ coef,
                   const short4* __restrict__ spans,
                   const int* __restrict__ counts,
                   unsigned* __restrict__ words, int k, int n, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_rows = reinterpret_cast<float4*>(smem + Smem<NT>::rows);
  int* s_pre = reinterpret_cast<int*>(smem + Smem<NT>::pre);
  int* s_span = reinterpret_cast<int*>(smem + Smem<NT>::span);
  unsigned* field = reinterpret_cast<unsigned*>(smem + Smem<NT>::field);

  const int tile = blockIdx.x / splits;
  const int part = blockIdx.x - tile * splits;
  const int nty = n / kTile;
  const int ox = (tile / nty) * kTile, oy = (tile % nty) * kTile;
  const int w_words = n >> 5;
  const float fn = static_cast<float>(n);
  const bool has_span = spans != nullptr;
  // this block's part of the tile's real rows
  const int cnt = counts == nullptr ? k : min(max(counts[tile], 0), k);
  const int r0 = static_cast<int>(static_cast<long long>(cnt) * part / splits);
  const int r1 =
      static_cast<int>(static_cast<long long>(cnt) * (part + 1) / splits);
  for (int i = threadIdx.x; i < w_words * kCols; i += NT) field[i] = 0u;
  __syncthreads();

  const int slots = r1 - r0;  // slot f is row r0 + f of the tile
  const float4* rows4 = reinterpret_cast<const float4*>(coef) +
                        (static_cast<size_t>(tile) * k + r0) * 4;
  const short4* rspan =
      has_span ? spans + static_cast<size_t>(tile) * k + r0 : nullptr;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  float4* w_rows = s_rows + wid * 32 * 4;  // [32 rows][4]
  int* w_pre = s_pre + wid * 32;
  int* w_span = s_span + wid * 32;
  float4 q[4];  // this lane's 4 float4 of the slice, as laid out in memory
  short4 next_sp;  // and its row's span
  auto copy = [&](int f0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = lane + 32 * j;
      q[j] = f0 + e / 4 < slots ? rows4[static_cast<size_t>(f0) * 4 + e]
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    next_sp = has_span && f0 + lane < slots ? rspan[f0 + lane]
                                            : make_short4(0, 0, 0, 0);
  };
  copy(wid * 32);
  for (int f0 = wid * 32; f0 < slots; f0 += NT) {
    const bool live = f0 + lane < slots;
    const short4 sp = next_sp;
#pragma unroll
    for (int j = 0; j < 4; ++j) w_rows[lane + 32 * j] = q[j];
    __syncwarp();
    float4 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = w_rows[lane * 4 + i];
    int span = 0;
    const int pairs =
        live ? row_pairs<kTile, kTile>(r, sp, has_span, ox, oy, n, span) : 0;
    copy(f0 + NT);  // the warp's next slice, in flight during the pairs
    if (__reduce_max_sync(0xffffffffu, pairs) <= kRowLoop) {
      // every row of the slice is small (a span's box): each lane loops
      // over its own row's pairs, the row in its registers
      for (int i = 0; i < pairs; ++i)
        test_pair<kTile, kTile>(r[0], r[1], r[2], r[3], span, i, ox, oy, fn,
                                field);
    } else {
      // a sliver's whole tile, or no spans: the slice's pairs spread over
      // the lanes, each pair's row found by a 5-step search of the scan
      w_span[lane] = span;
      const int x = warp_inclusive_scan(pairs);
      w_pre[lane] = x - pairs;
      const int total = __shfl_sync(0xffffffffu, x, 31);
      __syncwarp();
#pragma unroll 2
      for (int p = lane; p < total; p += 32) {
        int kk = 0;  // the last row whose first pair is <= p
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (w_pre[kk + step] <= p) kk += step;
        const float4* rq = w_rows + kk * 4;
        test_pair<kTile, kTile>(rq[0], rq[1], rq[2], rq[3], w_span[kk],
                                p - w_pre[kk], ox, oy, fn, field);
      }
    }
    __syncwarp();  // the next slice overwrites the warp's rows
  }
  __syncthreads();

  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every part's field is complete and visible
    // this block's share of the tile's columns: the XOR of the parts'
    // fields (all loads issued together), its suffix parity, the words
    // stored once (neighbouring threads on neighbouring columns)
    const int c0 = part * kCols / splits, c1 = (part + 1) * kCols / splits;
    for (int l = c0 + threadIdx.x; l < c1; l += NT) {
      const size_t base = column_base(ox, oy, l, n);
      unsigned carry = 0u;
      for (int w = w_words - 1; w >= 0; --w) {
        unsigned s = 0u;
#pragma unroll
        for (int b = 0; b < kMaxCluster; ++b)
          if (b < splits) s ^= cluster.map_shared_rank(field, b)[w * kCols + l];
        const unsigned p = suffix_parity(s);
        words[base + w] = p ^ (0u - carry);
        carry ^= p & 1u;
      }
    }
    cluster.sync();  // no block leaves while another reads its field
  } else {
    for (int l = threadIdx.x; l < kCols; l += NT) {
      const size_t base = column_base(ox, oy, l, n);
      unsigned carry = 0u;
      for (int w = w_words - 1; w >= 0; --w) {
        const unsigned p = suffix_parity(field[w * kCols + l]);
        const unsigned v = p ^ (0u - carry);
        carry ^= p & 1u;
        if (v != 0u) atomicXor(words + base + w, v);
      }
    }
  }
}

// The column layout (the parent kernel). MAXW: compile-time bound on the
// words per column (N/32 <= MAXW), so the accumulator stays in registers.
template <int MAXW>
__global__ void __launch_bounds__(kCols)
parity_kernel_column(const float* __restrict__ coef,
                     const int* __restrict__ counts,
                     unsigned int* __restrict__ words, int k, int n) {
  extern __shared__ float rows[];  // [kColumnRows, kCoef]
  const int tile = blockIdx.x;
  const int k0 = blockIdx.y * kColumnRows;
  const int cnt = counts == nullptr ? k : min(max(counts[tile], 0), k);
  if (k0 >= cnt) return;  // past the tile's real rows: nothing to load
  const int nty = n / kTile;
  const int tx = tile / nty;
  const int ty = tile - tx * nty;
  const int l = threadIdx.x;  // column l: x_local = l / 32, y_local = l % 32
  const int x = tx * kTile + (l >> 5);
  const int y = ty * kTile + (l & 31);
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const int w_words = n >> 5;

  const int kc = min(kColumnRows, cnt - k0);
  const float* src = coef + (static_cast<size_t>(tile) * k + k0) * kCoef;
  for (int i = l; i < kc * kCoef; i += blockDim.x) rows[i] = src[i];
  __syncthreads();

  unsigned int acc[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) acc[w] = 0u;

  const float fn = static_cast<float>(n);
  for (int t = 0; t < kc; ++t) {
    const float* c = rows + t * kCoef;
    if (!(c[VALID] > 0.0f)) continue;  // padding / degenerate triangle
    const float e0 = affine(c[EX0], c[EY0], c[EO0], px, py);
    const float e1 = affine(c[EX1], c[EY1], c[EO1], px, py);
    const float e2 = affine(c[EX2], c[EY2], c[EO2], px, py);
    if (!(inside_edge(e0, c[TL0]) && inside_edge(e1, c[TL1]) &&
          inside_edge(e2, c[TL2])))
      continue;
    const float z = affine(c[ZX], c[ZY], c[ZO], px, py);
    const int m = static_cast<int>(fminf(fmaxf(ceilf(z), 0.0f), fn));
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (w < w_words) {
        const int cb = min(max(m - 32 * w, 0), 32);
        acc[w] ^= (cb >= 32) ? 0xffffffffu : ((1u << cb) - 1u);
      }
    }
  }

  unsigned int* out = words + (static_cast<size_t>(x) * n + y) * w_words;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    if (w < w_words && acc[w] != 0u) atomicXor(out + w, acc[w]);
  }
}

template <int MAXW>
void launch_column(const float* coef, const int* counts, unsigned* words,
                   int n_tiles, int k, int n, cudaStream_t stream) {
  const dim3 grid(n_tiles, (k + kColumnRows - 1) / kColumnRows);
  const size_t smem = static_cast<size_t>(kColumnRows) * kCoef * sizeof(float);
  parity_kernel_column<MAXW><<<grid, kCols, smem, stream>>>(coef, counts,
                                                            words, k, n);
}

template <bool kCluster, int NT>
int launch_span(const float* coef, const short4* spans, const int* counts,
                unsigned* words, int n_tiles, int k, int n, int splits,
                cudaStream_t stream) {
  const size_t smem = Smem<NT>::bytes(n / 32);
  auto kernel = parity_kernel_span<kCluster, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if constexpr (!kCluster) {
    cudaMemsetAsync(words, 0,
                    static_cast<size_t>(n) * n * (n / 32) * sizeof(unsigned),
                    stream);
    kernel<<<n_tiles * splits, NT, smem, stream>>>(coef, spans, counts, words,
                                                   k, n, splits);
    return static_cast<int>(cudaGetLastError());
  }
  if (splits > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * splits);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, coef, spans, counts, words, k, n,
                         splits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* coef, const short* spans, const int* counts,
           int* words_i, int n_tiles, int k, int n, int layout, int splits,
           int threads, cudaStream_t stream) {
  const int w_words = n / 32;
  if (n % kTile != 0 || n_tiles != (n / kTile) * (n / kTile) || k < 1 ||
      w_words > 32 || splits < 1 ||
      (layout == kLayoutTile && splits > kMaxCluster) ||
      (layout != kLayoutColumn && spans == nullptr) || layout < 0 ||
      layout > kLayoutColumn)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned* words = reinterpret_cast<unsigned*>(words_i);
  if (layout == kLayoutColumn) {
    cudaMemsetAsync(words, 0,
                    static_cast<size_t>(n) * n * w_words * sizeof(unsigned),
                    stream);
    if (w_words <= 2)
      launch_column<2>(coef, counts, words, n_tiles, k, n, stream);
    else if (w_words <= 4)
      launch_column<4>(coef, counts, words, n_tiles, k, n, stream);
    else if (w_words <= 8)
      launch_column<8>(coef, counts, words, n_tiles, k, n, stream);
    else if (w_words <= 16)
      launch_column<16>(coef, counts, words, n_tiles, k, n, stream);
    else
      launch_column<32>(coef, counts, words, n_tiles, k, n, stream);
    return static_cast<int>(cudaGetLastError());
  }
  const short4* sp = reinterpret_cast<const short4*>(spans);
  const bool tile = layout == kLayoutTile;
  if (tile && threads == 256)
    return launch_span<true, 256>(coef, sp, counts, words, n_tiles, k, n,
                                  splits, stream);
  if (tile && threads == 512)
    return launch_span<true, 512>(coef, sp, counts, words, n_tiles, k, n,
                                  splits, stream);
  if (!tile && threads == 256)
    return launch_span<false, 256>(coef, sp, counts, words, n_tiles, k, n,
                                   splits, stream);
  if (!tile && threads == 512)
    return launch_span<false, 512>(coef, sp, counts, words, n_tiles, k, n,
                                   splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// coef: [n_tiles, k, 16] f32 (rows of each tile's binned triangles, zero rows
// as padding); spans: [n_tiles, k, 4] int16 (x_lo, x_hi, y_lo, y_hi: each
// row's bounding box in grid columns, clipped to [-1, n]) or null (every row
// against every column of its tile: the column layout); counts: [n_tiles]
// int32, the real rows at the head of each tile, or null (all k rows);
// words: [n, n, n/32] int32, written whole.
extern "C" int dxv_parity_voxelize(const float* coef, const short* spans,
                                   const int* counts, int* words, int n_tiles,
                                   int k, int n, void* stream) {
  const int splits =
      Smem<kMainThreads>::bytes(n / 32) > kWideClusterSmem ? 8 : kMainSplits;
  return launch(coef, spans, counts, words, n_tiles, k, n,
                spans == nullptr ? kLayoutColumn : kMainLayout, splits,
                kMainThreads, static_cast<cudaStream_t>(stream));
}

// The same with the layout (0: tile, a cluster of `splits` blocks per tile,
// at most 16; 1: split, `splits` blocks per tile with device-memory atomics;
// 2: column, the parent kernel, splits and threads ignored) and the threads
// per block of the span layouts (256, 512) chosen by the caller: the timing
// sweep.
extern "C" int dxv_parity_voxelize_variant(const float* coef,
                                           const short* spans,
                                           const int* counts, int* words,
                                           int n_tiles, int k, int n,
                                           int layout, int splits, int threads,
                                           void* stream) {
  return launch(coef, spans, counts, words, n_tiles, k, n, layout, splits,
                threads, static_cast<cudaStream_t>(stream));
}
