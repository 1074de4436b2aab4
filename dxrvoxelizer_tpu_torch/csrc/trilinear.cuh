// Trilinear LINEAR_CLAMP read of an [n, n, n] float volume at tex coords in
// [0,1]^3, in the plain torch version's order of operations
// (ops/raymarch_fast.py _flat_trilinear): c = tex*n - 0.5, floor, clamped
// integer taps, then three lerp levels a + (b - a) * f. Every step is an
// explicitly rounded intrinsic, so nvcc contracts nothing into an FMA and
// the kernels that include it match the plain version bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace dxv {

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

struct Axis {
  int i0, i1;  // clamped taps
  float f;     // fraction
};

__device__ __forceinline__ Axis axis_taps(float tex, int n) {
  const float c = __fsub_rn(__fmul_rn(tex, static_cast<float>(n)), 0.5f);
  const float c0 = floorf(c);
  const int i = static_cast<int>(c0);
  Axis a;
  a.f = __fsub_rn(c, c0);
  a.i0 = min(max(i, 0), n - 1);
  a.i1 = min(max(i + 1, 0), n - 1);
  return a;
}

__device__ __forceinline__ float trilinear(const float* __restrict__ vol,
                                           int n, const Axis& x,
                                           const Axis& y, const Axis& z) {
  const size_t nn = static_cast<size_t>(n);
  const size_t r00 = (x.i0 * nn + y.i0) * nn, r10 = (x.i1 * nn + y.i0) * nn;
  const size_t r01 = (x.i0 * nn + y.i1) * nn, r11 = (x.i1 * nn + y.i1) * nn;
  const float v000 = __ldg(vol + r00 + z.i0), v100 = __ldg(vol + r10 + z.i0);
  const float v010 = __ldg(vol + r01 + z.i0), v110 = __ldg(vol + r11 + z.i0);
  const float v001 = __ldg(vol + r00 + z.i1), v101 = __ldg(vol + r10 + z.i1);
  const float v011 = __ldg(vol + r01 + z.i1), v111 = __ldg(vol + r11 + z.i1);
  const float c00 = lerp_rn(v000, v100, x.f);
  const float c10 = lerp_rn(v010, v110, x.f);
  const float c01 = lerp_rn(v001, v101, x.f);
  const float c11 = lerp_rn(v011, v111, x.f);
  const float c0 = lerp_rn(c00, c10, y.f);
  const float c1 = lerp_rn(c01, c11, y.f);
  return lerp_rn(c0, c1, z.f);
}

// GetSample (PSRayCast.hlsl:103-112): min(trilinear * 8, 16)
__device__ __forceinline__ float get_sample(const float* __restrict__ vol,
                                            int n, const Axis& x,
                                            const Axis& y, const Axis& z) {
  return fminf(__fmul_rn(trilinear(vol, n, x, y, z), 8.0f), 16.0f);
}

// tex = TEX_SCALE * pos + 0.5, TEX_SCALE = (0.5, -0.5, 0.5)
__device__ __forceinline__ float to_tex(float scale, float p) {
  return __fadd_rn(__fmul_rn(scale, p), 0.5f);
}

__device__ __forceinline__ bool in_box(float x, float y, float z) {
  return fabsf(x) <= 1.0f && fabsf(y) <= 1.0f && fabsf(z) <= 1.0f;
}

}  // namespace dxv
