// Parity solid voxelization from a flat chunk queue of 16x8-column tiles
// (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/voxelize_queue.py::_queue_kernel and
// _queue_chunk (launched by _queue_run_group). Same computation: queue chunk
// c holds up to k_chunk packed coefficient rows of the triangles binned to
// tile chunk_tile[c] (chunk_nsub[c] sub-blocks of 8 live rows). For every
// column of the tile and every live row, three edge functions with the
// top-left tie rule decide coverage of the column centre; the crossing depth
// z = zx*px + zy*py + zo gives the cutoff m = clip(ceil z, 0, N). A covered
// crossing sets ONE bit, at m-1 (none when m = 0), of the column's N/32-word
// crossing-bit field by XOR. Occupancy is that field's suffix parity: voxel
// k is inside iff an odd number of bits >= k are set. The words are
// bit-identical to kernel 2.1 (csrc/parity_voxelize.cu) and to the oracle.
//
// What bounds it on the card: arithmetic per tested (column, row) pair -- four
// affine forms (16 FP32 operations) and a handful of compares -- and, once
// the pairs are few, the queue's coefficient rows (64 bytes each, read once)
// and the words (written once).
//
// Design: the queue carries each row's column span (spans[row] = x_lo x_hi
// y_lo y_hi, int16); the kernel tests a row only on the columns the span
// rule of csrc/parity_common.cuh picks (the span widened by one column and
// clipped to the chunk's tile, or the whole tile for a sliver), the rule and
// the pair test it shares with kernel 2.1. With no span array every row tests
// its whole tile.
// Threads take (row, column) pairs, not the tile's 128 columns: a group of
// rows is staged in shared memory with its pair counts scanned, each thread
// takes pairs p, p + stride, ..., finds p's row by binary search in the
// scan, and XORs the crossing bit into the tile's field in shared memory (128
// columns x N/32 words, by atomicXor on shared memory). Two layouts:
// - run (the main path): one block per tile. It finds its tile's run of
//   chunks (the queue lays a tile's chunks out back to back, chunk_tile
//   non-decreasing, a tile's padding chunks after its real ones) by a search
//   in which every thread tests one sample, walks the run's chunks with live
//   rows in warp slices of 32 rows (see queue_kernel), turns the
//   field into occupancy by suffix parity in shared memory and stores the
//   tile's words once, neighbouring threads on neighbouring words; a tile
//   with no chunk stores zeros. One launch, no memset, no device-memory
//   atomics.
// - chunk: one block per chunk; the field's non-zero words go to a zeroed
//   output by atomicXor (XOR is order-free: bit-exact in any order), then a
//   second kernel, launched from the same entry point, turns every column's
//   field into occupancy.
// chip_smoke.py (phase 11b) times both and the block size NT at 256^3 and
// 512^3; dxv_parity_queue runs the layout and NT chosen there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "parity_common.cuh"

namespace {

using namespace dxv_parity;

constexpr int kTileX = 16;
constexpr int kTileY = 8;
constexpr int kLanes = kTileX * kTileY;
constexpr int kSub = 8;
// the main path's layout and block size (chip_smoke.py phase 11b)
constexpr bool kMainRun = true;
constexpr int kMainThreads = 256;

// shared memory of one block: rows, pair scan, spans, field, warp sums
template <int NT>
struct Smem {
  static constexpr size_t rows = 0;  // [NT] float4 x 4
  static constexpr size_t pre = rows + NT * kCoef * sizeof(float);  // [NT] int
  static constexpr size_t span = pre + NT * sizeof(int);  // [NT] int
  static constexpr size_t warp = span + NT * sizeof(int);  // [32] int
  static constexpr size_t field = warp + 32 * sizeof(int);  // [W][128] uint
  static size_t bytes(int w_words) {
    return field + static_cast<size_t>(w_words) * kLanes * sizeof(unsigned);
  }
};

// exclusive block scan of one int per thread -> (exclusive prefix, total)
template <int NT>
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < NT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NT / 32) warp_sums[lane] = w;  // inclusive warp prefix
  }
  __syncthreads();
  total = warp_sums[NT / 32 - 1];
  return x - v + (wid > 0 ? warp_sums[wid - 1] : 0);
}

// the first chunk whose tile is >= t (chunk_tile non-decreasing), by a
// search that narrows the range NT-fold per step, every thread testing one
// sample
template <int NT>
__device__ int first_chunk(const int* __restrict__ chunk_tile, int num_chunks,
                           int t) {
  int lo = 0, hi = num_chunks;  // the chunk lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + NT - 1) / NT;
    const int j = lo + static_cast<int>(threadIdx.x) * step;
    const int below = __syncthreads_count(j < hi && chunk_tile[j] < t);
    const int next_hi = min(lo + below * step, hi);
    lo = below > 0 ? lo + (below - 1) * step + 1 : lo;
    hi = next_hi;
  }
  return lo;
}

// zero the packed words of tile t, neighbouring threads on neighbouring words
template <int NT>
__device__ void zero_tile(unsigned* __restrict__ words, int t, int n) {
  const int w_words = n >> 5, nty = n / kTileY;
  const int ox = (t / nty) * kTileX, oy = (t % nty) * kTileY;
  const int per_x = kTileY * w_words;  // contiguous words per x of the tile
  for (int i = threadIdx.x; i < kTileX * per_x; i += NT) {
    const int xl = i / per_x;
    words[(static_cast<size_t>(ox + xl) * n + oy) * w_words + i - xl * per_x] =
        0u;
  }
}

// whether slot f of chunks [c, ...) holds a live row (f < slots)
__device__ __forceinline__ bool live_slot(const int* __restrict__ chunk_nsub,
                                          int c, int f, int k_chunk) {
  const int k = f % k_chunk;
  return k < min(max(chunk_nsub[c + f / k_chunk], 0) * kSub, k_chunk);
}

// crossing bits -> occupancy (suffix parity) in shared memory, one thread per
// column; then the tile's words stored once, neighbouring threads on
// neighbouring words: into the grid as its 16 runs (one per x) of 8 * N/32
// contiguous words, or, for a tile group (`tile_out` not null), as the tile's
// [N/32, 128] block of the group's output, the field's own layout
template <int NT>
__device__ void store_tile(unsigned* field, unsigned* __restrict__ words,
                           unsigned* __restrict__ tile_out, int ox, int oy,
                           int n) {
  const int w_words = n >> 5;
  for (int l = threadIdx.x; l < kLanes; l += NT) {
    unsigned carry = 0u;
    for (int w = w_words - 1; w >= 0; --w) {
      const unsigned p = suffix_parity(field[w * kLanes + l]);
      field[w * kLanes + l] = p ^ (0u - carry);
      carry ^= p & 1u;
    }
  }
  __syncthreads();
  if (tile_out) {
    for (int i = threadIdx.x; i < w_words * kLanes; i += NT)
      tile_out[i] = field[i];
    return;
  }
  const int per_x = kTileY * w_words;
  for (int i = threadIdx.x; i < kTileX * per_x; i += NT) {
    const int xl = i / per_x, rem = i - xl * per_x;
    const int yl = rem / w_words, w = rem - yl * w_words;
    words[(static_cast<size_t>(ox + xl) * n + oy) * w_words + rem] =
        field[w * kLanes + xl * kTileY + yl];
  }
}

// kRun (the main path): block b folds tile tile_lo + b's run of chunks, in warp
// slices: each warp stages its own slices of 32 rows (the slice's
// 2 KiB copied by the warp with neighbouring lanes on neighbouring 16 bytes,
// the next slice's copy in flight while this one's pairs run), scans their
// pair counts by shuffles, and folds the pairs with a 5-step search, with no
// block-wide barrier between slices; then it stores the tile's words. A tile
// with no chunk stores zeros. With `group` not null the launch covers the
// tile group [tile_lo, tile_lo + gridDim.x) and block b writes its tile's
// [N/32, 128] words to group[b] (a rank's share of the grid); else tile_lo
// is 0 and the words go to the grid.
// !kRun (no group): block c folds chunk c alone, NT rows per round (one per thread, a
// block scan of the pair counts), and XORs the field's non-zero words into
// the zeroed output.
template <bool kRun, int NT>
__global__ void __launch_bounds__(NT)
queue_kernel(const float* __restrict__ coefs, const short4* __restrict__ spans,
             const int* __restrict__ chunk_tile,
             const int* __restrict__ chunk_nsub, unsigned* __restrict__ words,
             unsigned* __restrict__ group, int tile_lo, int num_chunks, int n,
             int k_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_rows = reinterpret_cast<float4*>(smem + Smem<NT>::rows);
  int* s_pre = reinterpret_cast<int*>(smem + Smem<NT>::pre);
  int* s_span = reinterpret_cast<int*>(smem + Smem<NT>::span);
  int* s_warp = reinterpret_cast<int*>(smem + Smem<NT>::warp);
  unsigned* field = reinterpret_cast<unsigned*>(smem + Smem<NT>::field);

  const int nty = n / kTileY;
  const int n_tiles = (n / kTileX) * nty;
  const int w_words = n >> 5;
  // kRun: block b folds tile tile_lo + b's run of chunks [c, c_end), or
  // zeroes the tile if it has none; else block b folds chunk b
  int c = blockIdx.x, c_end = c + 1;
  const int tile = kRun ? tile_lo + c : chunk_tile[c];
  unsigned* const tile_out =
      group ? group + static_cast<size_t>(blockIdx.x) * w_words * kLanes
            : nullptr;
  if (kRun) {
    // the tile's chunks with live rows: chunk_tile is non-decreasing, and a
    // tile's padding chunks (no live row; a queue built at a fixed capacity
    // has many, on its last tile) follow its real ones
    c = first_chunk<NT>(chunk_tile, num_chunks, tile);
    for (c_end = c;;) {
      const int i = c_end + static_cast<int>(threadIdx.x);
      const int live = __syncthreads_count(
          i < num_chunks && chunk_tile[i] == tile && chunk_nsub[i] > 0);
      c_end += live;
      if (live < NT) break;
    }
    if (c_end == c) {  // no live row: the tile is empty
      if (tile_out) {
        for (int i = threadIdx.x; i < w_words * kLanes; i += NT)
          tile_out[i] = 0u;
      } else {
        zero_tile<NT>(words, tile, n);
      }
      return;
    }
  }
  if (tile < 0 || tile >= n_tiles) return;  // padding chunk
  const int ox = (tile / nty) * kTileX, oy = (tile % nty) * kTileY;
  const float fn = static_cast<float>(n);
  const bool has_span = spans != nullptr;
  for (int i = threadIdx.x; i < w_words * kLanes; i += NT) field[i] = 0u;
  __syncthreads();
  const int slots = (c_end - c) * k_chunk;  // slot f is row c * k_chunk + f
  const float4* rows4 =
      reinterpret_cast<const float4*>(coefs) + static_cast<size_t>(c) * k_chunk * 4;
  const short4* rspan = spans + static_cast<size_t>(c) * k_chunk;

  if (kRun) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    float4* w_rows = s_rows + wid * 32 * 4;  // [32 rows][4]
    int* w_pre = s_pre + wid * 32;
    int* w_span = s_span + wid * 32;
    float4 q[4];  // this lane's 4 float4 of the slice, as laid out in memory
    auto copy = [&](int f0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = lane + 32 * j;
        q[j] = f0 + e / 4 < slots ? rows4[static_cast<size_t>(f0) * 4 + e]
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    };
    copy(wid * 32);
    for (int f0 = wid * 32; f0 < slots; f0 += NT) {
      const int f = f0 + lane;
      const bool live = f < slots && live_slot(chunk_nsub, c, f, k_chunk);
      const short4 sp = live && has_span ? rspan[f] : make_short4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) w_rows[lane + 32 * j] = q[j];
      __syncwarp();
      float4 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = w_rows[lane * 4 + i];
      int span = 0;
      const int pairs =
          live ? row_pairs<kTileX, kTileY>(r, sp, has_span, ox, oy, n, span)
               : 0;
      w_span[lane] = span;
      const int x = warp_inclusive_scan(pairs);
      w_pre[lane] = x - pairs;
      const int total = __shfl_sync(0xffffffffu, x, 31);
      __syncwarp();
      copy(f0 + NT);  // the warp's next slice, in flight during the pairs
#pragma unroll 2
      for (int p = lane; p < total; p += 32) {
        int k = 0;  // the last row whose first pair is <= p
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (w_pre[k + step] <= p) k += step;
        const float4* q = w_rows + k * 4;
        test_pair<kTileX, kTileY>(q[0], q[1], q[2], q[3], w_span[k],
                                  p - w_pre[k], ox, oy, fn, field);
      }
      __syncwarp();  // the next slice overwrites the warp's rows
    }
    __syncthreads();
    store_tile<NT>(field, words, tile_out, ox, oy, n);
    return;
  }

  for (int f0 = 0; f0 < slots; f0 += NT) {
    const int f = f0 + static_cast<int>(threadIdx.x);
    int pairs = 0, span = 0;
    if (f < slots && live_slot(chunk_nsub, c, f, k_chunk)) {
      float4 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = rows4[static_cast<size_t>(f) * 4 + i];
      const short4 sp = has_span ? rspan[f] : make_short4(0, 0, 0, 0);
      pairs = row_pairs<kTileX, kTileY>(r, sp, has_span, ox, oy, n, span);
      if (pairs > 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s_rows[threadIdx.x * 4 + i] = r[i];
      }
    }
    s_span[threadIdx.x] = span;
    int total;
    s_pre[threadIdx.x] = block_scan<NT>(pairs, s_warp, total);
    __syncthreads();
    for (int p = threadIdx.x; p < total; p += NT) {
      int k = 0;  // the last row whose first pair is <= p
#pragma unroll
      for (int step = NT / 2; step > 0; step >>= 1)
        if (s_pre[k + step] <= p) k += step;
      const float4* q = s_rows + k * 4;
      test_pair<kTileX, kTileY>(q[0], q[1], q[2], q[3], s_span[k],
                                p - s_pre[k], ox, oy, fn, field);
    }
    __syncthreads();  // the next round overwrites rows, spans and scan
  }
  for (int i = threadIdx.x; i < w_words * kLanes; i += NT) {
    const unsigned v = field[i];
    if (v == 0u) continue;
    const int w = i / kLanes, l = i - w * kLanes;
    atomicXor(words + (static_cast<size_t>(ox + l / kTileY) * n + oy +
                       l % kTileY) * w_words + w, v);
  }
}

// crossing-bit field -> occupancy, one thread per column: bit k := parity of
// the field's bits >= k (within the word by a shift-XOR ladder, across words
// by a carry from the higher words). Named after queue_kernel so that a
// profiler's per-name sums count both passes of the launch as the kernel's.
__global__ void queue_kernel_suffix_parity(unsigned int* __restrict__ words,
                                           int columns, int w_words) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= columns) return;
  unsigned int* w = words + static_cast<size_t>(col) * w_words;
  unsigned int carry = 0u;
  for (int i = w_words - 1; i >= 0; --i) {
    const unsigned int p = suffix_parity(w[i]);
    w[i] = p ^ (0u - carry);
    carry ^= p & 1u;
  }
}

// group null: the whole grid into `words`; else the `tiles` tiles from
// tile_lo into `group` (kRun only)
template <bool kRun, int NT>
int launch(const float* coefs, const short4* spans, const int* chunk_tile,
           const int* chunk_nsub, unsigned* words, unsigned* group,
           int tile_lo, int tiles, int num_chunks, int n, int k_chunk,
           cudaStream_t stream) {
  const int w_words = n / 32;
  const size_t smem = Smem<NT>::bytes(w_words);
  const size_t bytes = static_cast<size_t>(n) * n * w_words * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        queue_kernel<kRun, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!kRun) cudaMemsetAsync(words, 0, bytes, stream);  // a zeroed field
  // kRun: a block per tile (of the group); else a block per chunk
  const int blocks =
      kRun ? (group ? tiles : (n / kTileX) * (n / kTileY)) : num_chunks;
  if (blocks > 0)
    queue_kernel<kRun, NT><<<blocks, NT, smem, stream>>>(
        coefs, spans, chunk_tile, chunk_nsub, words, group, tile_lo,
        num_chunks, n, k_chunk);
  if (!kRun) {
    const int columns = n * n;
    constexpr int kBlock = 256;
    queue_kernel_suffix_parity<<<(columns + kBlock - 1) / kBlock, kBlock, 0,
                                 stream>>>(words, columns, w_words);
  }
  return static_cast<int>(cudaGetLastError());
}

int check_args(int num_chunks, int n, int k_chunk) {
  if (n % 32 != 0 || n < 32 || n > 1024 || num_chunks < 0 || k_chunk < kSub ||
      k_chunk % kSub != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// coefs: [num_chunks * k_chunk, 16] f32; spans: [num_chunks * k_chunk, 4]
// int16 (x_lo, x_hi, y_lo, y_hi: the bounding box's grid columns, clipped to
// [-1, n]) or null (every row tests its whole tile); chunk_tile
// (non-decreasing), chunk_nsub: [num_chunks] int32; words: [n, n, n/32]
// int32, written whole.
extern "C" int dxv_parity_queue(const float* coefs, const short* spans,
                                const int* chunk_tile, const int* chunk_nsub,
                                int* words, int num_chunks, int n, int k_chunk,
                                void* stream) {
  if (const int e = check_args(num_chunks, n, k_chunk)) return e;
  return launch<kMainRun, kMainThreads>(
      coefs, reinterpret_cast<const short4*>(spans), chunk_tile, chunk_nsub,
      reinterpret_cast<unsigned*>(words), nullptr, 0, 0, num_chunks, n,
      k_chunk, static_cast<cudaStream_t>(stream));
}

// The same on the tile group [tile_lo, tile_lo + tiles) (a rank's share of
// a sharded voxelize): group: [tiles, n/32, 128] int32, tile tile_lo + b's
// words at group[b], lane l = x_local * 8 + y_local, written whole.
extern "C" int dxv_parity_queue_group(const float* coefs, const short* spans,
                                      const int* chunk_tile,
                                      const int* chunk_nsub, int* group,
                                      int tile_lo, int tiles, int num_chunks,
                                      int n, int k_chunk, void* stream) {
  if (const int e = check_args(num_chunks, n, k_chunk)) return e;
  const int n_tiles = (n / kTileX) * (n / kTileY);
  if (tile_lo < 0 || tiles < 0 || tile_lo + tiles > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kMainRun, kMainThreads>(
      coefs, reinterpret_cast<const short4*>(spans), chunk_tile, chunk_nsub,
      nullptr, reinterpret_cast<unsigned*>(group), tile_lo, tiles, num_chunks,
      n, k_chunk, static_cast<cudaStream_t>(stream));
}

// The same with the layout (run = 1: a block per tile run; 0: a block per
// chunk, device-memory atomics and a second pass) and the block size (128,
// 256, 512) chosen by the caller: the timing sweep.
extern "C" int dxv_parity_queue_variant(const float* coefs, const short* spans,
                                        const int* chunk_tile,
                                        const int* chunk_nsub, int* words,
                                        int num_chunks, int n, int k_chunk,
                                        int run, int threads, void* stream) {
  if (const int e = check_args(num_chunks, n, k_chunk)) return e;
  const short4* sp = reinterpret_cast<const short4*>(spans);
  unsigned* w = reinterpret_cast<unsigned*>(words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DXV_QUEUE_CASE(R, T)                                                 \
  if ((run != 0) == R && threads == T)                                       \
    return launch<R, T>(coefs, sp, chunk_tile, chunk_nsub, w, nullptr, 0, 0, \
                        num_chunks, n, k_chunk, s);
  DXV_QUEUE_CASE(true, 128)
  DXV_QUEUE_CASE(true, 256)
  DXV_QUEUE_CASE(true, 512)
  DXV_QUEUE_CASE(false, 128)
  DXV_QUEUE_CASE(false, 256)
#undef DXV_QUEUE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
