// Shared by the two parity kernels, csrc/parity_voxelize.cu (32x32-column
// binned tiles) and csrc/parity_queue.cu (16x8-column queue tiles): the
// packed coefficient row, the edge and depth forms, the span rule that picks
// a row's columns, the test of one (row, column) pair and the suffix parity.
//
// A row's columns: its span, the bounding box the binning uses
// ([ceil xmin, floor xmax] x [ceil ymin, floor ymax], int16 grid columns
// clipped to [-1, N]), widened by one column each side and clipped to the
// tile. float32 rounding of the edge functions cannot cover a column outside
// that, except for a sliver: a row whose sin(smallest angle) is below
// 2^-17 R (R bounds the vertices' coordinates), or whose span the clip may
// have cut, tests its whole tile. The bound is derived in
// ops/voxelize_cuda.py::sliver_rows, which computes the same test in the same
// order. The edge and depth expressions use __fmul_rn / __fadd_rn in the JAX
// order, ((a*px) + (b*py)) + c, so no FMA contraction moves a boundary
// decision (the box with faces on voxel centres pins it).

#pragma once

#include <cuda_runtime.h>

namespace dxv_parity {

constexpr int kCoef = 16;
// coefficient columns of a packed row (voxelize_pallas.pack_coeffs order)
constexpr int EX0 = 0, EY0 = 1, EO0 = 2, TL0 = 3;
constexpr int EX1 = 4, EY1 = 5, EO1 = 6, TL1 = 7;
constexpr int EX2 = 8, EY2 = 9, EO2 = 10, TL2 = 11;
constexpr int ZX = 12, ZY = 13, ZO = 14, VALID = 15;
constexpr double kSliverK = 1.0 / 131072.0;  // 2^-17

__device__ __forceinline__ float affine(float a, float b, float c, float px,
                                        float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ bool inside_edge(float e, float tl) {
  return (e > 0.0f) || ((e == 0.0f) && (tl > 0.0f));
}

// voxelize_cuda.sliver_rows, operation for operation in float64: the row
// (r0, r1, r2: its first three float4, span b) tests its whole tile
__device__ __forceinline__ bool sliver(float4 r0, float4 r1, float4 r2,
                                       short4 b, int n) {
  if (b.x <= -1 || b.y >= n || b.z <= -1 || b.w >= n) return true;  // cut
  const double ex[3] = {r0.x, r1.x, r2.x}, ey[3] = {r0.y, r1.y, r2.y};
  double sq[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    sq[i] = __dadd_rn(__dmul_rn(ex[i], ex[i]), __dmul_rn(ey[i], ey[i]));
  const double longest2 = fmax(fmax(__dmul_rn(sq[0], sq[2]),
                                    __dmul_rn(sq[1], sq[0])),
                               __dmul_rn(sq[2], sq[1]));
  const double area =
      __dsub_rn(__dmul_rn(ex[0], ey[1]), __dmul_rn(ey[0], ex[1]));
  const int r = max(max(abs(b.x - 1), abs(b.y + 1)),
                    max(abs(b.z - 1), abs(b.w + 1))) + 1;
  const double bound = static_cast<double>(r) * kSliverK;
  return !(__dmul_rn(area, area) >=
           __dmul_rn(__dmul_rn(bound, bound), longest2));
}

// One row of a TX x TY tile at (ox, oy): its pair count and its packed
// columns (span: (hmul - 1) | h << 16 | x0 << 22 | y0 << 27, the columns
// picked as above, or the whole tile with no span array) -- 0 for a
// degenerate triangle or an empty span. TX, TY <= 32.
template <int TX, int TY>
__device__ __forceinline__ int row_pairs(const float4 (&r)[4], short4 sp,
                                         bool has_span, int ox, int oy, int n,
                                         int& span) {
  span = 0;
  if (!(r[3].w > 0.0f)) return 0;  // zero row / degenerate triangle
  int x0 = 0, x1 = TX - 1, y0 = 0, y1 = TY - 1;
  if (has_span && !sliver(r[0], r[1], r[2], sp, n)) {  // widened, in the tile
    x0 = max(sp.x - 1 - ox, 0);
    x1 = min(sp.y + 1 - ox, TX - 1);
    y0 = max(sp.z - 1 - oy, 0);
    y1 = min(sp.w + 1 - oy, TY - 1);
  }
  const int w = x1 - x0 + 1, h = y1 - y0 + 1;
  if (w <= 0 || h <= 0) return 0;
  // exact i / h for i < TX * TY <= 1024 and h <= 32 as (i * hmul) >> 16
  span = ((65536 + h - 1) / h - 1) | (h << 16) | (x0 << 22) | (y0 << 27);
  return w * h;
}

// pair i of a row (coefficients a b d z, packed columns sp) in the TX x TY
// tile at (ox, oy): a covered crossing XORs ONE bit, at cutoff m - 1 (none
// when m = 0), into the tile's crossing-bit field ([N/32][TX * TY] words,
// column l = xl * TY + yl), by an atomic on shared memory
template <int TX, int TY>
__device__ __forceinline__ void test_pair(float4 a, float4 b, float4 d,
                                          float4 z, int sp, int i, int ox,
                                          int oy, float fn, unsigned* field) {
  const int h = (sp >> 16) & 63;
  const int dxl = (i * ((sp & 0xffff) + 1)) >> 16;
  const int xl = ((sp >> 22) & 31) + dxl;
  const int yl = ((sp >> 27) & 31) + (i - dxl * h);
  const float px = static_cast<float>(ox + xl);
  const float py = static_cast<float>(oy + yl);
  const float e0 = affine(a.x, a.y, a.z, px, py);
  const float e1 = affine(b.x, b.y, b.z, px, py);
  const float e2 = affine(d.x, d.y, d.z, px, py);
  if (!(inside_edge(e0, a.w) && inside_edge(e1, b.w) && inside_edge(e2, d.w)))
    return;
  const float zz = affine(z.x, z.y, z.z, px, py);
  const int ci = static_cast<int>(fminf(fmaxf(ceilf(zz), 0.0f), fn)) - 1;
  if (ci < 0) return;  // cutoff 0: the crossing flips no voxel
  atomicXor(field + (ci >> 5) * (TX * TY) + xl * TY + yl, 1u << (ci & 31));
}

// the suffix parity of one word: bit k := parity of bits >= k. Across a
// column's words, highest first, the caller carries the parity of the words
// above: p = suffix_parity(s); word = p ^ (0u - carry); carry ^= p & 1u.
__device__ __forceinline__ unsigned suffix_parity(unsigned s) {
  s ^= s >> 1;
  s ^= s >> 2;
  s ^= s >> 4;
  s ^= s >> 8;
  s ^= s >> 16;
  return s;
}

// inclusive scan of one int per lane over a warp
__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

}  // namespace dxv_parity
