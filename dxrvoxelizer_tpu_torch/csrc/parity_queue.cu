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
// What bounds it on the card: arithmetic per (column, live row) pair — four
// affine forms (16 FP32 operations) and a handful of compares — plus the
// queue's coefficient rows, each read from device memory once (64 bytes per
// row) and then broadcast from shared memory to the tile's 128 columns. The
// words are written once by atomics and once more by the conversion pass.
//
// Design: one block per queue chunk, 128 threads (one per column of the
// chunk's tile), the chunk's live rows staged in shared memory and read as
// broadcasts, the N/32 field words in registers. A crossing's bit goes to
// its word through an unrolled `if (pw == w)` select, not a dynamic index,
// so the array stays in registers. The TPU kernel keeps the whole output
// resident in VMEM over a sequential grid and converts a tile on its last
// chunk; blocks on the card run in no order and share nothing, so each
// block XORs its words into a zeroed field in device memory with atomicXor
// (XOR is order-free: the result is bit-exact whatever the order), and a
// second kernel launched from the same entry point turns every column's
// field into occupancy by suffix parity. The second pass was chosen over a
// per-tile completion counter with __threadfence: it needs no counter
// array, no fence protocol and no reading of chunk_last, and at 512^3 it
// touches 16 MiB once. The edge and depth expressions use __fmul_rn /
// __fadd_rn in the JAX order, ((a*px) + (b*py)) + c, so no FMA contraction
// moves a boundary decision (the box with faces on voxel centres pins it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 8;
constexpr int kLanes = kTileX * kTileY;
constexpr int kSub = 8;
constexpr int kCoef = 16;
// coefficient columns of a packed row (voxelize_pallas.pack_coeffs order)
constexpr int EX0 = 0, EY0 = 1, EO0 = 2, TL0 = 3;
constexpr int EX1 = 4, EY1 = 5, EO1 = 6, TL1 = 7;
constexpr int EX2 = 8, EY2 = 9, EO2 = 10, TL2 = 11;
constexpr int ZX = 12, ZY = 13, ZO = 14, VALID = 15;

__device__ __forceinline__ float affine(float a, float b, float c, float px,
                                        float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ bool inside_edge(float e, float tl) {
  return (e > 0.0f) || ((e == 0.0f) && (tl > 0.0f));
}

// MAXW: compile-time bound on the words per column (N/32 <= MAXW), so the
// field stays in registers
template <int MAXW>
__global__ void __launch_bounds__(kLanes)
queue_kernel(const float* __restrict__ coefs,
             const int* __restrict__ chunk_tile,
             const int* __restrict__ chunk_nsub,
             unsigned int* __restrict__ words, int n, int k_chunk) {
  extern __shared__ float rows[];  // [k_chunk, kCoef]
  const int c = blockIdx.x;
  const int n_rows = min(max(chunk_nsub[c], 0) * kSub, k_chunk);
  const int tile = chunk_tile[c];
  const int nty = n / kTileY;
  const int n_tiles = (n / kTileX) * nty;
  if (n_rows == 0 || tile < 0 || tile >= n_tiles) return;  // padding chunk
  const int tx = tile / nty;
  const int ty = tile - tx * nty;
  const int l = threadIdx.x;  // column l: x_local = l / 8, y_local = l % 8
  const int x = tx * kTileX + l / kTileY;
  const int y = ty * kTileY + l % kTileY;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const int w_words = n >> 5;

  const float* src = coefs + static_cast<size_t>(c) * k_chunk * kCoef;
  for (int i = l; i < n_rows * kCoef; i += kLanes) rows[i] = src[i];
  __syncthreads();

  unsigned int acc[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) acc[w] = 0u;

  const float fn = static_cast<float>(n);
  for (int t = 0; t < n_rows; ++t) {
    const float* r = rows + t * kCoef;
    if (!(r[VALID] > 0.0f)) continue;  // zero row / degenerate triangle
    const float e0 = affine(r[EX0], r[EY0], r[EO0], px, py);
    const float e1 = affine(r[EX1], r[EY1], r[EO1], px, py);
    const float e2 = affine(r[EX2], r[EY2], r[EO2], px, py);
    if (!(inside_edge(e0, r[TL0]) && inside_edge(e1, r[TL1]) &&
          inside_edge(e2, r[TL2])))
      continue;
    const float z = affine(r[ZX], r[ZY], r[ZO], px, py);
    const int ci = static_cast<int>(fminf(fmaxf(ceilf(z), 0.0f), fn)) - 1;
    if (ci < 0) continue;  // cutoff 0: the crossing flips no voxel
    const int pw = ci >> 5;
    const unsigned int bit = 1u << (ci & 31);
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (pw == w) acc[w] ^= bit;
    }
  }

  unsigned int* out = words + (static_cast<size_t>(x) * n + y) * w_words;
#pragma unroll
  for (int w = 0; w < MAXW; ++w) {
    if (w < w_words && acc[w] != 0u) atomicXor(out + w, acc[w]);
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
    unsigned int s = w[i];
    s ^= s >> 1;
    s ^= s >> 2;
    s ^= s >> 4;
    s ^= s >> 8;
    s ^= s >> 16;
    w[i] = s ^ (0u - carry);
    carry ^= s & 1u;
  }
}

template <int MAXW>
void launch(const float* coefs, const int* chunk_tile, const int* chunk_nsub,
            unsigned int* words, int num_chunks, int n, int k_chunk,
            cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k_chunk) * kCoef * sizeof(float);
  queue_kernel<MAXW><<<num_chunks, kLanes, smem, stream>>>(
      coefs, chunk_tile, chunk_nsub, words, n, k_chunk);
}

}  // namespace

// coefs: [num_chunks * k_chunk, 16] f32; chunk_tile, chunk_nsub:
// [num_chunks] int32; words: [n, n, n/32] int32, zeroed here, XOR-filled
// with crossing bits, then converted to occupancy in place.
extern "C" int dxv_parity_queue(const float* coefs, const int* chunk_tile,
                                const int* chunk_nsub, int* words,
                                int num_chunks, int n, int k_chunk,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w_words = n / 32;
  if (n % 32 != 0 || n < 32 || num_chunks < 0 || k_chunk < kSub ||
      k_chunk % kSub != 0 || k_chunk * kCoef * sizeof(float) > 48 * 1024 ||
      w_words > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaMemsetAsync(words, 0,
                  static_cast<size_t>(n) * n * w_words * sizeof(int), s);
  unsigned int* w = reinterpret_cast<unsigned int*>(words);
  if (num_chunks > 0) {
    if (w_words <= 2)
      launch<2>(coefs, chunk_tile, chunk_nsub, w, num_chunks, n, k_chunk, s);
    else if (w_words <= 4)
      launch<4>(coefs, chunk_tile, chunk_nsub, w, num_chunks, n, k_chunk, s);
    else if (w_words <= 8)
      launch<8>(coefs, chunk_tile, chunk_nsub, w, num_chunks, n, k_chunk, s);
    else if (w_words <= 16)
      launch<16>(coefs, chunk_tile, chunk_nsub, w, num_chunks, n, k_chunk, s);
    else
      launch<32>(coefs, chunk_tile, chunk_nsub, w, num_chunks, n, k_chunk, s);
  }
  const int columns = n * n;
  constexpr int kBlock = 256;
  const int blocks = (columns + kBlock - 1) / kBlock;
  queue_kernel_suffix_parity<<<blocks, kBlock, 0, s>>>(w, columns, w_words);
  return static_cast<int>(cudaGetLastError());
}
