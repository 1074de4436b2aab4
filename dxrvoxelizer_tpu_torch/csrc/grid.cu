// The frame's grid glue between the kernels (Hopper): the ray-stab grid's
// untiling, R10G10B10A2 rounding and packing (X.6), the occupancy words'
// unpacking to density (X.7), the march's slab stack (X.8) and gen-6's
// stream merge fused with X.6's rounding and packing (X.10).
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
//   (-1: a dead tile, which reads as zeros). A second form of the same
//   body, words-gated, for -normals (core/pipeline.py::_parity_rgba): rgb
//   times the occupancy bit of the given words, alpha the bit, and no
//   words written. The input already in grid order (gen-6's merged
//   streams) has no form here: X.10 reads gen-6's streams themselves.
// - X.7 grid_unpack_kernel: core/pipeline.py::VoxelGrid.density of a parity
//   grid (ops/packing.py::unpack_bits_z, then a float cast).
// - X.8 grid_slabs_kernel: ops/raymarch_warp.py::_shearwarp_core's slab
//   stack: density and light as [2, K, X, Y], the marching axis first
//   (flipped when the view looks down it) and the other two in grid order.
// - X.10 grid_merge_kernel: ops/raystab_fast.py::_merge_winners2 (the
//   port's _merge_streams2: the gen-6 main stream's slot outputs scattered
//   to ray order through a zeroed [V+1, 4] buffer, and the near-origin
//   stream merged by (t, lowest id) through two more filled buffers and a
//   where), then X.6's tail in grid order. Ray v reads its slot through the
//   accel's ray -> slot map (-1: no strip covers it, zeros), then the
//   near-origin stream's lane v, which wins when its t is smaller, or equal
//   with a lower id (the plain version's comparisons); then X.6's rounding,
//   packing and gated form.
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
// What bounds it on the card: bytes, all four (a few integer operations a
// voxel). X.6 reads the live tiles' channels and the 0.5 MiB slot map and
// writes the rgba, the words and the density: 16 + 0.125 + 4 bytes a voxel
// written, 0.18 ms at 256^3 with every tile live at 3.35 TB/s. X.7 reads
// n^3 / 8 bytes and writes 4 a voxel (0.021 ms at 256^3). X.8 reads 8 bytes
// a voxel and writes 8 (0.080 ms at 256^3). X.10 reads the ray -> slot map
// (4 bytes a voxel) and each stream's outputs once (16 bytes a slot without
// the near-origin stream; t, id and the channels, 24, with it) and writes
// what X.6 writes.
//
// Design:
// - X.6: a thread a voxel in grid order, 256 a block. A warp's 32 voxels
//   are one word's (n % 32 == 0), so the word is the warp's __ballot_sync of
//   its lanes' bits, stored by lane 0: no atomics, no second pass. Each
//   thread loads its voxel's 16 bytes; four neighbours along z are one
//   tile's 64 contiguous bytes, so every sector a warp loads is used, and
//   its stores (16, 4 bytes a lane) are contiguous. The gated form and the
//   rounding are template arguments.
// - X.10: X.6's body with another input: a thread a voxel in grid order
//   (ray v is voxel v), its slot's 16 bytes (one load when the channels
//   are contiguous float4s; four when they are a strided view of the
//   sharded frames' gathered pieces, read in place), then its near-origin
//   lane's; the same ballot, rounding and stores.
// - X.7: a thread writes four voxels as one 16-byte store; eight threads
//   share a word.
// - X.8: with the layout [x, y, z] (z minor) the stack is a
//   true transpose only when the marching axis is z. Along x and y, the
//   slab's y is z, the minor axis of both sides, so the stack copies whole
//   contiguous rows in a permuted (under `flip`, reversed) order. Each
//   channel takes its own path, chosen on the host from its strides and
//   alignment (a block's channel is blockIdx.y, so the choice is uniform in
//   a block):
//   - rows (the input's y stride below its marching stride): no shared
//     memory and no barrier. A thread takes kSlabItems quads (4 voxels
//     along y) of the output in order, consecutive lanes on consecutive 16
//     bytes, issues all their 16-byte loads, then their 16-byte stores.
//     A strided density (rgba[..., 3], read in place) or a grid whose n is
//     not a multiple of 4 takes single voxels instead, consecutive lanes on
//     consecutive y: the loads then read the rgba's whole sectors, which
//     the strided view needs anyway, and the stores stay coalesced.
//   - transpose (the marching stride below y's): 32x32 (k, y) tiles of
//     kSlabTileX slabs x a block. Each thread loads one 16-byte quad along
//     k a slab, all before the first shared store; the tile rows are
//     padded to 33 floats, so neither the column writes nor the row reads
//     conflict on a bank; after one barrier each thread stores one 16-byte
//     quad along y a slab. A strided density, or n % 4 != 0, moves single
//     voxels both ways, consecutive lanes on consecutive k, then y. A block keeps 16 bytes a thread a slab
//     in flight, and the SM's other blocks load while it stores.
//   The constants are a sweep's (scripts/glue_turns.py against copies of
//   this source): one, four or eight quads a thread, 64x64 tiles (too few
//   blocks at 64^3), one or four slabs a block, a tile in dynamic shared
//   memory asked for only by transposed launches, and a persistent block
//   that loads its next tile into registers before storing this one
//   measured no faster, or slower. So did a transpose pipelined through
//   cp.async: two or three stages of 32x32 tiles of four slabs (or 64 or
//   128 y by 32 k), 16-byte units swizzled by y, a 4x4 quad block a thread
//   transposed in registers, a block walking 2-8 stage tiles along x: 0.3-
//   2 % slower at 256^3, 20 % at 64^3, and its registers, shared by the
//   rows path in this one kernel, slowed the rows by 12-17 %.
//   Edges of grids that are not a multiple of the tile (mip levels) are
//   masked; a quad is wholly in or out (n % 4 == 0 on the 16-byte paths).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSlabItems = 2;   // X.8 rows: quads (or voxels) a thread
constexpr int kSlabTileK = 32;  // X.8 transpose: the tile's k rows
constexpr int kSlabTileY = 32;  // X.8 transpose: the tile's y columns
constexpr int kSlabTileX = 2;   // X.8 transpose: slabs x a block

// The reciprocals PyTorch's CUDA division by a Python scalar multiplies by.
constexpr float kInv1023 = 1.0f / 1023.0f;
constexpr float kInv3 = 1.0f / 3.0f;
constexpr int kBigId = 1 << 30;  // a miss's id (intersect.BIG_ID)

__device__ __forceinline__ float clamp01(float v) {
  // torch.clamp(v, 0, 1) on the card: NaN propagates
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float unorm(float v, float levels, float inv) {
  return __fmul_rn(rintf(__fmul_rn(clamp01(v), levels)), inv);
}

// X.6's tail, shared with X.10: voxel v's channels `c` (zeros past the
// grid) -> the gate, or the warp's word ballot, then the rounding and the
// stores. Every thread of the block calls it (the ballot is the warp's).
template <bool kGated, bool kQuant>
__device__ __forceinline__ void finish_voxel(
    float4 c, long long v, int k, bool live, const unsigned* __restrict__ gate,
    float4* __restrict__ rgba, float* __restrict__ density,
    unsigned* __restrict__ words) {
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

template <bool kGated, bool kQuant>
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
    const long long row = v / n;
    const int j = static_cast<int>(row % n);
    const int i = static_cast<int>(row / n);
    const int q = n >> 2;  // tiles along y and z
    const long long tile =
        (static_cast<long long>(i >> 3) * q + (j >> 2)) * q + (k >> 2);
    const int lane = (i & 7) * 16 + (j & 3) * 4 + (k & 3);
    const int s = __ldg(slots + tile);
    if (s >= 0) c = __ldg(src + static_cast<long long>(s) * 128 + lane);
  }
  finish_voxel<kGated, kQuant>(c, v, k, live, gate, rgba, density, words);
}

// One strip stream's outputs as X.10 reads them: element e's t and id at
// e * ts, its four channels at e * nss (`vec`: contiguous float4s).
struct StreamOut {
  const float* t;
  const int* id;
  const float* ns;
  long long ts, nss;
  bool vec;
};

__device__ __forceinline__ float4 load_channels(const StreamOut& s,
                                                long long e) {
  if (s.vec) return __ldg(reinterpret_cast<const float4*>(s.ns) + e);
  const float* p = s.ns + e * s.nss;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// X.10: ray v (= voxel v) of the gen-6 streams -> its merged channels, then
// X.6's tail. `slot` null: no main stream. kOv: merge the near-origin
// stream (lane v), which wins on a smaller t or an equal t with a lower id.
template <bool kOv, bool kGated, bool kQuant>
__global__ void __launch_bounds__(kThreads)
grid_merge_kernel(const int* __restrict__ slot, const StreamOut m,
                  const StreamOut o, const unsigned* __restrict__ gate,
                  float4* __restrict__ rgba, float* __restrict__ density,
                  unsigned* __restrict__ words, int n, long long voxels) {
  const long long v = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool live = v < voxels;
  const int k = static_cast<int>(v % n);
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    float t = __int_as_float(0x7f800000);  // +inf: no main winner
    int id = kBigId;
    const int s = slot != nullptr ? __ldg(slot + v) : -1;
    if (s >= 0) {
      c = load_channels(m, s);
      if (kOv) {
        t = __ldg(m.t + s * m.ts);
        id = __ldg(m.id + s * m.ts);
      }
    }
    if (kOv) {
      const float to = __ldg(o.t + v * o.ts);
      const int io = __ldg(o.id + v * o.ts);
      if (to < t || (to == t && io < id)) c = load_channels(o, v);
    }
  }
  finish_voxel<kGated, kQuant>(c, v, k, live, gate, rgba, density, words);
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

// A channel's path (slab_path): rows or the transpose, each of 16-byte
// quads or of single voxels.
enum SlabPath : int {
  kRowsQuad = 0,
  kRowsVoxel = 1,
  kTransQuad = 2,
  kTransVoxel = 3,
};

// Rows: the channel's output [n, n, n] (k, x, y) as items in order (a quad
// of 4 y, or one voxel), kSlabItems a thread, consecutive lanes on
// consecutive items; item i is voxel row i / per_row (= k n + x) at y
// (i % per_row) * width. The quotients are (i + 0.5) times the float64
// reciprocal, truncated: exact for i < 2^32 and divisors below 2^11 (the
// error, under 2^-20, stays below the 0.5 / d margin), and a few
// instructions where an integer division by a variable takes some twenty.
__device__ __forceinline__ unsigned slab_quot(unsigned i, double inv) {
  return static_cast<unsigned>((static_cast<double>(i) + 0.5) * inv);
}

template <bool kQuad>
__device__ __forceinline__ void slab_rows(const SlabSrc& s,
                                          float* __restrict__ out, int n,
                                          int flip, unsigned blk,
                                          double inv_n) {
  const unsigned un = n;
  const unsigned per_row = kQuad ? un >> 2 : un;
  const double inv_row = kQuad ? 4.0 * inv_n : inv_n;
  const unsigned items = un * un * per_row;
  const unsigned first = blk * (kThreads * kSlabItems) + threadIdx.x;
  using V = typename std::conditional<kQuad, float4, float>::type;
  V v[kSlabItems];
#pragma unroll
  for (int j = 0; j < kSlabItems; ++j) {
    const unsigned i = first + j * kThreads;
    if (i < items) {
      const unsigned row = slab_quot(i, inv_row);
      const unsigned y = (i - row * per_row) * (kQuad ? 4 : 1);
      const unsigned k = slab_quot(row, inv_n);
      const unsigned x = row - k * un;
      const unsigned kk = flip ? un - 1 - k : k;
      const float* src = s.p + x * s.sx + y * s.sy + kk * s.sk;
      v[j] = __ldg(reinterpret_cast<const V*>(src));
    }
  }
#pragma unroll
  for (int j = 0; j < kSlabItems; ++j) {
    const unsigned i = first + j * kThreads;
    if (i < items) reinterpret_cast<V*>(out)[i] = v[j];
  }
}

// X.8's transpose tile: [x][k][y], rows padded by a float (32 x 32: no
// bank conflict on the column writes or the row reads).
using SlabTile = float[kSlabTileX][kSlabTileK][kSlabTileY + 1];

// Transpose: block blk's (k, y) tile of kSlabTileX slabs x. The tile holds
// input k rows kb.. (kb = k0, or n - k0 - kSlabTileK when flipped: output
// row kl reads tile row kSlabTileK - 1 - kl).
template <bool kQuad>
__device__ __forceinline__ void slab_transpose(const SlabSrc& s,
                                               float* __restrict__ out,
                                               int n, int flip, unsigned blk,
                                               SlabTile& tile) {
  constexpr int TK = kSlabTileK, TY = kSlabTileY, TX = kSlabTileX;
  const unsigned ty = (n + TY - 1) / TY, tk = (n + TK - 1) / TK;
  const int y0 = static_cast<int>(blk % ty) * TY;
  blk /= ty;
  const int k0 = static_cast<int>(blk % tk) * TK;
  const int x0 = static_cast<int>(blk / tk) * TX;
  const int kb = flip ? n - k0 - TK : k0;
  const int t = threadIdx.x;
  if (kQuad) {  // lane: a quad of 4 k of a tile row y
    constexpr int kLanes = TK / 4, kPass = kThreads / kLanes;
    constexpr int kR = TY / kPass;
    const int kl = (t % kLanes) * 4, k = kb + kl;
    float4 v[TX][kR];
#pragma unroll
    for (int xi = 0; xi < TX; ++xi) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int x = x0 + xi, y = y0 + t / kLanes + kPass * r;
        v[xi][r] = (x < n && y < n && k >= 0 && k < n)
                       ? __ldg(reinterpret_cast<const float4*>(
                             s.p + x * s.sx + y * s.sy + k))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int xi = 0; xi < TX; ++xi) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int yl = t / kLanes + kPass * r;
        tile[xi][kl][yl] = v[xi][r].x;
        tile[xi][kl + 1][yl] = v[xi][r].y;
        tile[xi][kl + 2][yl] = v[xi][r].z;
        tile[xi][kl + 3][yl] = v[xi][r].w;
      }
    }
  } else {  // lane: a k of tile rows y
    constexpr int kPass = kThreads / TK, kR = TY / kPass;
    const int kl = t % TK, k = kb + kl;
    float v[TX][kR];
#pragma unroll
    for (int xi = 0; xi < TX; ++xi) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int x = x0 + xi, y = y0 + t / TK + kPass * r;
        v[xi][r] = (x < n && y < n && k >= 0 && k < n)
                       ? __ldg(s.p + x * s.sx + y * s.sy + k * s.sk)
                       : 0.0f;
      }
    }
#pragma unroll
    for (int xi = 0; xi < TX; ++xi) {
#pragma unroll
      for (int r = 0; r < kR; ++r) tile[xi][kl][t / TK + kPass * r] = v[xi][r];
    }
  }
  __syncthreads();
  if (kQuad) {  // lane: a quad of 4 y of an output row k
    constexpr int kLanes = TY / 4, kPass = kThreads / kLanes;
    constexpr int kR = TK / kPass;
    const int yl = (t % kLanes) * 4, y = y0 + yl;
#pragma unroll
    for (int xi = 0; xi < TX; ++xi) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int kl = t / kLanes + kPass * r, k = k0 + kl, x = x0 + xi;
        const int kt = flip ? TK - 1 - kl : kl;
        if (x < n && y < n && k < n) {
          const float* q = tile[xi][kt] + yl;
          *reinterpret_cast<float4*>(
              out + (static_cast<long long>(k) * n + x) * n + y) =
              make_float4(q[0], q[1], q[2], q[3]);
        }
      }
    }
  } else {  // lane: a y of output rows k
    constexpr int kPass = kThreads / TY, kR = TK / kPass;
    const int yl = t % TY, y = y0 + yl;
#pragma unroll
    for (int xi = 0; xi < TX; ++xi) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int kl = t / TY + kPass * r, k = k0 + kl, x = x0 + xi;
        const int kt = flip ? TK - 1 - kl : kl;
        if (x < n && y < n && k < n) {
          out[(static_cast<long long>(k) * n + x) * n + y] = tile[xi][kt][yl];
        }
      }
    }
  }
}

// Grid (blocks of the channel that needs most, 2): blockIdx.y the channel
// (0 density, 1 light), each on its own path over its own blocks.
// out[c][k][x][y] = vol_c at slab x, y and marching index k (n - 1 - k
// when flipped).
__global__ void __launch_bounds__(kThreads)
grid_slabs_kernel(const SlabSrc dens, const SlabSrc light,
                  float* __restrict__ out, int n, int flip, int path_d,
                  int path_l, unsigned blocks_d, unsigned blocks_l,
                  double inv_n) {
  __shared__ SlabTile tile;  // the transpose paths'
  const int ch = blockIdx.y;
  const SlabSrc s = ch ? light : dens;
  if (blockIdx.x >= (ch ? blocks_l : blocks_d)) return;
  float* o = out + static_cast<long long>(ch) * n * n * n;
  switch (ch ? path_l : path_d) {
    case kRowsQuad:
      slab_rows<true>(s, o, n, flip, blockIdx.x, inv_n);
      break;
    case kRowsVoxel:
      slab_rows<false>(s, o, n, flip, blockIdx.x, inv_n);
      break;
    case kTransQuad:
      slab_transpose<true>(s, o, n, flip, blockIdx.x, tile);
      break;
    default:
      slab_transpose<false>(s, o, n, flip, blockIdx.x, tile);
      break;
  }
}

// A channel's path: rows when its y stride is below its marching stride,
// else the transpose; 16-byte quads where n % 4 == 0 and the loaded quads
// are contiguous (unit stride along the quad's axis) and 16-byte aligned.
int slab_path(const SlabSrc& s, int n) {
  const bool aligned = n % 4 == 0 && s.sx % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(s.p) % sizeof(float4) == 0;
  if (!(s.sk < s.sy)) {
    return aligned && s.sy == 1 && s.sk % 4 == 0 ? kRowsQuad : kRowsVoxel;
  }
  return aligned && s.sk == 1 && s.sy % 4 == 0 ? kTransQuad : kTransVoxel;
}

long long slab_blocks(int path, int n) {
  switch (path) {
    case kRowsQuad:
    case kRowsVoxel: {
      const long long items =
          static_cast<long long>(n) * n * (path == kRowsQuad ? n / 4 : n);
      return (items + kThreads * kSlabItems - 1) / (kThreads * kSlabItems);
    }
    default:
      return ((n + kSlabTileY - 1) / kSlabTileY) *
             static_cast<long long>((n + kSlabTileK - 1) / kSlabTileK) *
             ((n + kSlabTileX - 1) / kSlabTileX);
  }
}

template <bool kGated>
cudaError_t launch_untile(bool quant, const float4* src, const int* slots,
                          const unsigned* gate, float4* rgba, float* density,
                          unsigned* words, int n, long long voxels,
                          cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((voxels + kThreads - 1) / kThreads);
  if (quant) {
    grid_untile_kernel<kGated, true><<<blocks, kThreads, 0, stream>>>(
        src, slots, gate, rgba, density, words, n, voxels);
  } else {
    grid_untile_kernel<kGated, false><<<blocks, kThreads, 0, stream>>>(
        src, slots, gate, rgba, density, words, n, voxels);
  }
  return cudaGetLastError();
}

template <bool kOv, bool kGated>
cudaError_t launch_merge(bool quant, const int* slot, const StreamOut& m,
                         const StreamOut& o, const unsigned* gate,
                         float4* rgba, float* density, unsigned* words, int n,
                         long long voxels, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((voxels + kThreads - 1) / kThreads);
  if (quant) {
    grid_merge_kernel<kOv, kGated, true><<<blocks, kThreads, 0, stream>>>(
        slot, m, o, gate, rgba, density, words, n, voxels);
  } else {
    grid_merge_kernel<kOv, kGated, false><<<blocks, kThreads, 0, stream>>>(
        slot, m, o, gate, rgba, density, words, n, voxels);
  }
  return cudaGetLastError();
}

StreamOut stream_out(const void* t, const void* id, const void* ns,
                     long long ts, long long nss) {
  const bool vec = nss == 4 &&
                   reinterpret_cast<uintptr_t>(ns) % sizeof(float4) == 0;
  return {static_cast<const float*>(t), static_cast<const int*>(id),
          static_cast<const float*>(ns), ts, nss, vec};
}

}  // namespace

// X.6. `slots` the tile -> row map [n^3 / 128], `src` the live tiles'
// channels [L, 128, 4] (may be null when no tile is live). `gate` non-null:
// the words-gated form (`words` must be null). `density` and `words` may be
// null (not written).
extern "C" int dxv_grid_untile(const void* src, const void* slots,
                               const void* gate, void* rgba, void* density,
                               void* words, int n, int quant, void* stream) {
  if (n <= 0) return 0;
  const long long voxels = static_cast<long long>(n) * n * n;
  if (slots == nullptr || n % 8 != 0 ||
      ((gate != nullptr || words != nullptr) && n % 32 != 0) ||
      (gate != nullptr && words != nullptr) ||
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
  const cudaError_t err =
      g != nullptr
          ? launch_untile<true>(q, s, sl, g, out, d, w, n, voxels, st)
          : launch_untile<false>(q, s, sl, g, out, d, w, n, voxels, st);
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
  // 32-bit item and tile arithmetic, quotients through float64
  // reciprocals of n and n / 4 (exact below 2^11)
  if (n >= (1 << 11) || static_cast<long long>(n) * n * n >= (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SlabSrc d{static_cast<const float*>(dens), d_sx, d_sy, d_sk};
  const SlabSrc l{static_cast<const float*>(light), l_sx, l_sy, l_sk};
  const int path_d = slab_path(d, n), path_l = slab_path(l, n);
  const long long blocks_d = slab_blocks(path_d, n);
  const long long blocks_l = slab_blocks(path_l, n);
  const long long blocks = blocks_d > blocks_l ? blocks_d : blocks_l;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  grid_slabs_kernel<<<dim3(static_cast<unsigned>(blocks), 2), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      d, l, static_cast<float*>(out), n, flip, path_d, path_l,
      static_cast<unsigned>(blocks_d), static_cast<unsigned>(blocks_l),
      1.0 / n);
  return static_cast<int>(cudaGetLastError());
}

// X.10: gen-6's streams -> the grid. `slot` [n^3] int32 (the ray -> slot
// map; null: no main stream) and the main stream's outputs (slot e's t and
// id at e * m_ts, its channels at e * m_nss); the near-origin stream's
// (lane v's; `o_ns` null: no such stream). `gate`, `density` and `words`
// as for X.6.
extern "C" int dxv_grid_merge(const void* slot, const void* m_t,
                              const void* m_id, const void* m_ns,
                              long long m_ts, long long m_nss,
                              const void* o_t, const void* o_id,
                              const void* o_ns, long long o_ts,
                              long long o_nss, const void* gate, void* rgba,
                              void* density, void* words, int n, int quant,
                              void* stream) {
  if (n <= 0) return 0;
  const long long voxels = static_cast<long long>(n) * n * n;
  const bool ov = o_ns != nullptr;
  if (((gate != nullptr || words != nullptr) && n % 32 != 0) ||
      (gate != nullptr && words != nullptr) ||
      (slot != nullptr && m_ns == nullptr) ||
      (ov && (o_t == nullptr || o_id == nullptr)) ||
      (ov && slot != nullptr && (m_t == nullptr || m_id == nullptr)) ||
      (voxels + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StreamOut m = stream_out(m_t, m_id, m_ns, m_ts, m_nss);
  const StreamOut o = stream_out(o_t, o_id, o_ns, o_ts, o_nss);
  auto* sl = static_cast<const int*>(slot);
  auto* g = static_cast<const unsigned*>(gate);
  auto* out = static_cast<float4*>(rgba);
  auto* d = static_cast<float*>(density);
  auto* w = static_cast<unsigned*>(words);
  auto st = static_cast<cudaStream_t>(stream);
  const bool q = quant != 0;
  cudaError_t err;
  if (ov) {
    err = g != nullptr
              ? launch_merge<true, true>(q, sl, m, o, g, out, d, w, n, voxels, st)
              : launch_merge<true, false>(q, sl, m, o, g, out, d, w, n, voxels,
                                          st);
  } else {
    err = g != nullptr
              ? launch_merge<false, true>(q, sl, m, o, g, out, d, w, n, voxels,
                                          st)
              : launch_merge<false, false>(q, sl, m, o, g, out, d, w, n,
                                           voxels, st);
  }
  return static_cast<int>(err);
}
