// The frame's grid glue between the kernels (Hopper): the ray-stab grid's
// untiling, R10G10B10A2 rounding and packing (X.6), the occupancy words'
// unpacking to density (X.7) and the march's slab stack (X.8).
//
// Replaces XLA code, not Pallas kernels; the JAX package fuses each under
// jit, and the port ran each as a chain of eager torch ops, every one a
// full-grid intermediate in device memory:
// - X.6 grid_untile_kernel: dxrvoxelizer_tpu/ops/raystab_tiled.py
//   ::_raystab_query7's untiling (the live tiles' channels scattered into a
//   zeroed tile buffer, reshaped and transposed to grid order) and
//   ops/packing.py::quantize_r10g10b10a2 and ::pack_bits_z on its output
//   (core/pipeline.py::voxelize). Voxel (i, j, k) is lane
//   (i & 7) * 16 + (j & 3) * 4 + (k & 3) of tile
//   ((i >> 3) * (n / 4) + (j >> 2)) * (n / 4) + (k >> 2) (TILE = (8, 4, 4),
//   x-major); `slots` maps a tile to its row of the live tiles' channels
//   (-1: a dead tile, which reads as zeros). Two more forms of the same
//   body: the input already in grid order ([n^3, 4]: gen-6's merged
//   streams), and a words-gated form for -normals (core/pipeline.py
//   ::_parity_rgba): rgb times the occupancy bit of the given words, alpha
//   the bit, and no words written.
// - X.7 grid_unpack_kernel: core/pipeline.py::VoxelGrid.density of a parity
//   grid (ops/packing.py::unpack_bits_z, then a float cast).
// - X.8 grid_slabs_kernel: ops/raymarch_warp.py::_shearwarp_core's slab
//   stack: density and light as [2, K, X, Y], the marching axis first
//   (flipped when the view looks down it) and the other two in grid order.
//
// Arithmetic (each output equals the plain torch chain on the card, which
// chip_smoke.py checks with ==):
// - The rounding is the plain version's as PyTorch runs it on the card:
//   clamp (a NaN stays NaN, as torch.clamp propagates it: fminf/fmaxf alone
//   would drop it), the product by 1023 (rgb) or 3 (alpha), rintf (half to
//   even, torch.round's rule), then the product by the float32 reciprocal
//   1/1023 or 1/3: PyTorch's CUDA true division by a Python scalar is that
//   product, not an IEEE division (and so is jitted XLA's by a constant).
//   An IEEE quotient differs from it at 24 of the 1,024 levels of a
//   10-bit channel (by an ulp) and at none of alpha's 4. Every operation is
//   an explicitly rounded intrinsic, so nothing contracts.
// - The occupancy bit is the unrounded alpha != 0 (a NaN alpha is set, as
//   in `rgba[..., 3] != 0.0`); a word's bit 31 is the int32 sign. The
//   density written beside the rgba is its alpha after the rounding, as
//   `rgba[..., 3]` of the rounded grid.
// - The gated form multiplies rgb by 0.0f or 1.0f: a negative normal
//   times 0 is -0.0, a NaN or an infinity times 0 is NaN, as in the plain
//   product; a -0.0 then rounds to a zero whose sign is fmaxf's, as the
//   card's torch.clamp gives it.
//
// What bounds it on the card: bytes, all three (a few integer operations a
// voxel). X.6 reads the live tiles' channels and the 0.5 MiB slot map and
// writes the rgba, the words and the density: 16 + 0.125 + 4 bytes a voxel
// written, 0.18 ms at 256^3 with every tile live at 3.35 TB/s. X.7 reads
// n^3 / 8 bytes and writes 4 a voxel (0.021 ms at 256^3). X.8 reads 8 bytes
// a voxel and writes 8 (0.080 ms at 256^3).
//
// Design:
// - X.6: a thread a voxel in grid order, 256 a block. A warp's 32 voxels
//   are one word's (n % 32 == 0), so the word is the warp's __ballot_sync of
//   its lanes' bits, stored by lane 0: no atomics, no second pass. Each
//   thread loads its voxel's 16 bytes; four neighbours along z are one
//   tile's 64 contiguous bytes, so every sector a warp loads is used, and
//   its stores (16, 4 bytes a lane) are contiguous. Forms and the rounding
//   are template arguments.
// - X.7: a thread writes four voxels as one 16-byte store; eight threads
//   share a word.
// - X.8: the stack is a transpose when the marching axis is z (the layout's
//   minor axis becomes the slab index): 32x32 (k, y) tiles staged through
//   shared memory (a padded row: no bank conflicts), loaded along whichever
//   of k and y is the input's minor axis and stored along y, the output's
//   minor axis, so both sides are coalesced for every axis. A block takes
//   the tiles of two slabs x and issues all its loads (8 a thread, into
//   registers, predicated) before its first store, so that each SM keeps
//   enough bytes in flight: a block's life is one round trip to memory and
//   a barrier. The inputs come with their strides: a strided density
//   (rgba[..., 3] of a grid no kernel wrote) is read in place, without a
//   copy. Edges of grids that are not a multiple of 32 (mip levels) are
//   masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // X.8's (k, y) tile
constexpr int kRows = 8;   // X.8's threads along the tile's rows
constexpr int kSlabX = 2;  // X.8's slabs x a block

// The reciprocals PyTorch's CUDA division by a Python scalar multiplies by.
constexpr float kInv1023 = 1.0f / 1023.0f;
constexpr float kInv3 = 1.0f / 3.0f;

__device__ __forceinline__ float clamp01(float v) {
  // torch.clamp(v, 0, 1) on the card: NaN propagates
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float unorm(float v, float levels, float inv) {
  return __fmul_rn(rintf(__fmul_rn(clamp01(v), levels)), inv);
}

template <bool kTiled, bool kGated, bool kQuant>
__global__ void __launch_bounds__(kThreads)
grid_untile_kernel(const float4* __restrict__ src,
                   const int* __restrict__ slots,
                   const unsigned* __restrict__ gate,
                   float4* __restrict__ rgba, float* __restrict__ density,
                   unsigned* __restrict__ words, int n, long long voxels) {
  const long long v = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool live = v < voxels;
  const int k = static_cast<int>(v % n);
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    if (kTiled) {
      const long long row = v / n;
      const int j = static_cast<int>(row % n);
      const int i = static_cast<int>(row / n);
      const int q = n >> 2;  // tiles along y and z
      const long long tile =
          (static_cast<long long>(i >> 3) * q + (j >> 2)) * q + (k >> 2);
      const int lane = (i & 7) * 16 + (j & 3) * 4 + (k & 3);
      const int s = __ldg(slots + tile);
      if (s >= 0) c = __ldg(src + static_cast<long long>(s) * 128 + lane);
    } else {
      c = __ldg(src + v);
    }
  }
  if (kGated) {
    if (live) {
      const float b =
          static_cast<float>((__ldg(gate + (v >> 5)) >> (k & 31)) & 1u);
      c.x = __fmul_rn(c.x, b);
      c.y = __fmul_rn(c.y, b);
      c.z = __fmul_rn(c.z, b);
      c.w = b;
    }
  } else if (words != nullptr) {
    // n % 32 == 0: the warp's 32 voxels are word v >> 5, lane = bit k & 31
    const unsigned m = __ballot_sync(0xffffffffu, live && c.w != 0.0f);
    if (live && (threadIdx.x & 31) == 0) words[v >> 5] = m;
  }
  if (!live) return;
  if (kQuant) {
    c.x = unorm(c.x, 1023.0f, kInv1023);
    c.y = unorm(c.y, 1023.0f, kInv1023);
    c.z = unorm(c.z, 1023.0f, kInv1023);
    c.w = unorm(c.w, 3.0f, kInv3);
  }
  rgba[v] = c;
  if (density != nullptr) density[v] = c.w;
}

__global__ void __launch_bounds__(kThreads)
grid_unpack_kernel(const unsigned* __restrict__ words,
                   float4* __restrict__ density, long long quads) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (q >= quads) return;
  const unsigned w = __ldg(words + (q >> 3)) >> ((q & 7) * 4);
  density[q] = make_float4(static_cast<float>(w & 1u),
                           static_cast<float>((w >> 1) & 1u),
                           static_cast<float>((w >> 2) & 1u),
                           static_cast<float>((w >> 3) & 1u));
}

// One input volume of the stack: its element strides along the slab's x,
// its y and the marching axis.
struct SlabSrc {
  const float* p;
  long long sx, sy, sk;
};

// Block (kTile, kRows); grid (y tiles, k tiles, 2 ceil(n / kSlabX)):
// blockIdx.z = the x group * 2 + the channel (0 density, 1 light), a block
// kSlabX slabs x0.. of one channel. out[c][k][x][y] = vol_c at slab x, y
// and marching index k (n - 1 - k when flipped).
__global__ void __launch_bounds__(kTile * kRows)
grid_slabs_kernel(const SlabSrc dens, const SlabSrc light,
                  float* __restrict__ out, int n, int flip) {
  __shared__ float tile[kSlabX][kTile][kTile + 1];  // [x][k][y]
  constexpr int kR = kTile / kRows;  // a thread's rows of a tile
  const int ch = blockIdx.z & 1;
  const long long x0 = static_cast<long long>(blockIdx.z >> 1) * kSlabX;
  const SlabSrc s = ch ? light : dens;
  const int y0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const bool along_k = s.sk < s.sy;  // load along the input's minor axis
  // every load of the block's tiles in flight before the first store
  float v[kSlabX][kR];
#pragma unroll
  for (int xi = 0; xi < kSlabX; ++xi) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int yl = along_k ? threadIdx.y + r * kRows : threadIdx.x;
      const int kl = along_k ? threadIdx.x : threadIdx.y + r * kRows;
      const int y = y0 + yl, k = k0 + kl;
      const long long x = x0 + xi;
      const long long kk = flip ? n - 1 - k : k;
      v[xi][r] = (x < n && y < n && k < n)
                     ? __ldg(s.p + x * s.sx + y * s.sy + kk * s.sk)
                     : 0.0f;
    }
  }
#pragma unroll
  for (int xi = 0; xi < kSlabX; ++xi) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int yl = along_k ? threadIdx.y + r * kRows : threadIdx.x;
      const int kl = along_k ? threadIdx.x : threadIdx.y + r * kRows;
      tile[xi][kl][yl] = v[xi][r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int xi = 0; xi < kSlabX; ++xi) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int kl = threadIdx.y + r * kRows, yl = threadIdx.x;
      const int y = y0 + yl, k = k0 + kl;
      const long long x = x0 + xi;
      if (x < n && y < n && k < n) {
        out[((static_cast<long long>(ch) * n + k) * n + x) * n + y] =
            tile[xi][kl][yl];
      }
    }
  }
}

template <bool kTiled, bool kGated>
cudaError_t launch_untile(bool quant, const float4* src, const int* slots,
                          const unsigned* gate, float4* rgba, float* density,
                          unsigned* words, int n, long long voxels,
                          cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((voxels + kThreads - 1) / kThreads);
  if (quant) {
    grid_untile_kernel<kTiled, kGated, true><<<blocks, kThreads, 0, stream>>>(
        src, slots, gate, rgba, density, words, n, voxels);
  } else {
    grid_untile_kernel<kTiled, kGated, false><<<blocks, kThreads, 0, stream>>>(
        src, slots, gate, rgba, density, words, n, voxels);
  }
  return cudaGetLastError();
}

}  // namespace

// X.6. `slots` null: `src` is [n^3, 4] in grid order, else the live tiles'
// channels [L, 128, 4] (may be null when no tile is live). `gate` non-null:
// the words-gated form (`words` must be null). `density` and `words` may be
// null (not written).
extern "C" int dxv_grid_untile(const void* src, const void* slots,
                               const void* gate, void* rgba, void* density,
                               void* words, int n, int quant, void* stream) {
  if (n <= 0) return 0;
  const long long voxels = static_cast<long long>(n) * n * n;
  if ((slots != nullptr && n % 8 != 0) ||
      ((gate != nullptr || words != nullptr) && n % 32 != 0) ||
      (gate != nullptr && words != nullptr) ||
      (slots == nullptr && src == nullptr) ||
      (voxels + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<const float4*>(src);
  auto* sl = static_cast<const int*>(slots);
  auto* g = static_cast<const unsigned*>(gate);
  auto* out = static_cast<float4*>(rgba);
  auto* d = static_cast<float*>(density);
  auto* w = static_cast<unsigned*>(words);
  auto st = static_cast<cudaStream_t>(stream);
  const bool q = quant != 0;
  cudaError_t err;
  if (sl != nullptr) {
    err = g != nullptr
              ? launch_untile<true, true>(q, s, sl, g, out, d, w, n, voxels, st)
              : launch_untile<true, false>(q, s, sl, g, out, d, w, n, voxels, st);
  } else {
    err = g != nullptr
              ? launch_untile<false, true>(q, s, sl, g, out, d, w, n, voxels, st)
              : launch_untile<false, false>(q, s, sl, g, out, d, w, n, voxels,
                                            st);
  }
  return static_cast<int>(err);
}

// X.7: words [n, n, n / 32] -> density [n, n, n].
extern "C" int dxv_grid_unpack(const void* words, void* density, int n,
                               void* stream) {
  if (n <= 0) return 0;
  if (n % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = static_cast<long long>(n) * n * n / 4;
  const long long blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  grid_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), static_cast<float4*>(density),
      quads);
  return static_cast<int>(cudaGetLastError());
}

// X.8: the two volumes (pointers and element strides along the slab's x,
// y and the marching axis) -> out [2, n, n, n].
extern "C" int dxv_grid_slabs(const void* dens, long long d_sx, long long d_sy,
                              long long d_sk, const void* light,
                              long long l_sx, long long l_sy, long long l_sk,
                              void* out, int n, int flip, void* stream) {
  if (n <= 0) return 0;
  const long long groups = 2LL * ((n + kSlabX - 1) / kSlabX);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const SlabSrc d{static_cast<const float*>(dens), d_sx, d_sy, d_sk};
  const SlabSrc l{static_cast<const float*>(light), l_sx, l_sy, l_sk};
  const unsigned t = static_cast<unsigned>((n + kTile - 1) / kTile);
  grid_slabs_kernel<<<dim3(t, t, static_cast<unsigned>(groups)),
                      dim3(kTile, kRows), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      d, l, static_cast<float*>(out), n, flip);
  return static_cast<int>(cudaGetLastError());
}
