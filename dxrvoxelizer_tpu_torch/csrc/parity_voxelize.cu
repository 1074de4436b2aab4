// Parity solid voxelization over binned 32x32-column tiles (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/voxelize_pallas.py::_parity_kernel
// (launched by voxelize_parity_tiles). Same computation: for every column
// of a tile and every triangle binned to that tile, three edge functions
// with the top-left tie rule decide coverage of the column center; the
// crossing depth z = zx*px + zy*py + zo gives the cutoff m = clip(ceil z,
// 0, N); a covered crossing XORs the prefix mask "bits k < m" into the
// column's N/32 packed words. The XOR of all masks is the crossing parity.
//
// What bounds it on the card: arithmetic per (column, triangle) pair — a
// dozen FP32 operations and compares — plus the coefficient reads. Each
// tile's triangle list is read by all 1024 of its columns, so the bytes
// that matter are shared-memory broadcasts, not device memory; the words
// are written once. At 64^3 the whole grid is only 4 tiles, too few blocks
// for 132 SMs.
//
// Design: one thread per column, one 32x32 tile per block (1024 threads),
// the N/32 words in registers. A block stages a chunk of its tile's
// coefficient rows in shared memory, where every thread reads the same row
// at once (a broadcast). To fill the card at small N, each tile's triangle
// list is also split across blocks (gridDim.y chunks); blocks combine their
// words with atomicXor into zeroed output. XOR is associative and
// commutative, so the result is bit-exact whatever the order. The edge and
// depth expressions use __fmul_rn/__fadd_rn in the JAX package's order,
// ((a*px) + (b*py)) + c, so no FMA contraction moves a boundary decision.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
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
// accumulator array stays in registers
template <int MAXW>
__global__ void __launch_bounds__(1024)
parity_kernel(const float* __restrict__ coef, unsigned int* __restrict__ words,
              int k, int n, int k_chunk) {
  extern __shared__ float rows[];  // [k_chunk, kCoef]
  const int tile = blockIdx.x;
  const int nty = n / kTile;
  const int tx = tile / nty;
  const int ty = tile - tx * nty;
  const int l = threadIdx.x;  // column l: x_local = l / 32, y_local = l % 32
  const int x = tx * kTile + (l >> 5);
  const int y = ty * kTile + (l & 31);
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const int w_words = n >> 5;

  const int k0 = blockIdx.y * k_chunk;
  const int kc = min(k_chunk, k - k0);
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
void launch(const float* coef, unsigned int* words, int n_tiles, int k, int n,
            int k_chunk, cudaStream_t stream) {
  const dim3 grid(n_tiles, (k + k_chunk - 1) / k_chunk);
  const size_t smem = static_cast<size_t>(k_chunk) * kCoef * sizeof(float);
  parity_kernel<MAXW><<<grid, kTile * kTile, smem, stream>>>(coef, words, k, n,
                                                            k_chunk);
}

}  // namespace

// coef: [n_tiles, k, 16] f32 (rows of each tile's binned triangles, zero rows
// as padding); words: [n, n, n/32] int32, zeroed here and then XOR-filled.
extern "C" int dxv_parity_voxelize(const float* coef, int* words, int n_tiles,
                                   int k, int n, int k_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w_words = n / 32;
  if (n % kTile != 0 || n_tiles != (n / kTile) * (n / kTile) || k < 1 ||
      k_chunk < 1 || k_chunk * kCoef * sizeof(float) > 48 * 1024 ||
      w_words > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaMemsetAsync(words, 0,
                  static_cast<size_t>(n) * n * w_words * sizeof(int), s);
  unsigned int* w = reinterpret_cast<unsigned int*>(words);
  if (w_words <= 2)
    launch<2>(coef, w, n_tiles, k, n, k_chunk, s);
  else if (w_words <= 4)
    launch<4>(coef, w, n_tiles, k, n, k_chunk, s);
  else if (w_words <= 8)
    launch<8>(coef, w, n_tiles, k, n, k_chunk, s);
  else if (w_words <= 16)
    launch<16>(coef, w, n_tiles, k, n, k_chunk, s);
  else
    launch<32>(coef, w, n_tiles, k, n, k_chunk, s);
  return static_cast<int>(cudaGetLastError());
}
