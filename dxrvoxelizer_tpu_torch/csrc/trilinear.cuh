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

// The eight taps of one read, loaded apart from their combination so that
// a kernel can issue the loads of several steps before it needs any value.
struct Taps {
  float v000, v100, v010, v110, v001, v101, v011, v111;
};

// 32-bit offsets: the wrappers take n <= 1024 (ops/raymarch_fast.py MAX_N)
__device__ __forceinline__ Taps load_taps(const float* __restrict__ vol,
                                          int n, const Axis& x,
                                          const Axis& y, const Axis& z) {
  const unsigned nn = static_cast<unsigned>(n);
  const unsigned r00 = (x.i0 * nn + y.i0) * nn, r10 = (x.i1 * nn + y.i0) * nn;
  const unsigned r01 = (x.i0 * nn + y.i1) * nn, r11 = (x.i1 * nn + y.i1) * nn;
  Taps t;
  t.v000 = __ldg(vol + r00 + z.i0);
  t.v100 = __ldg(vol + r10 + z.i0);
  t.v010 = __ldg(vol + r01 + z.i0);
  t.v110 = __ldg(vol + r11 + z.i0);
  t.v001 = __ldg(vol + r00 + z.i1);
  t.v101 = __ldg(vol + r10 + z.i1);
  t.v011 = __ldg(vol + r01 + z.i1);
  t.v111 = __ldg(vol + r11 + z.i1);
  return t;
}

__device__ __forceinline__ float combine(const Taps& t, float fx, float fy,
                                         float fz) {
  const float c00 = lerp_rn(t.v000, t.v100, fx);
  const float c10 = lerp_rn(t.v010, t.v110, fx);
  const float c01 = lerp_rn(t.v001, t.v101, fx);
  const float c11 = lerp_rn(t.v011, t.v111, fx);
  const float c0 = lerp_rn(c00, c10, fy);
  const float c1 = lerp_rn(c01, c11, fy);
  return lerp_rn(c0, c1, fz);
}

__device__ __forceinline__ float trilinear(const float* __restrict__ vol,
                                           int n, const Axis& x,
                                           const Axis& y, const Axis& z) {
  return combine(load_taps(vol, n, x, y, z), x.f, y.f, z.f);
}

// GetSample (PSRayCast.hlsl:103-112): min(trilinear * 8, 16)
__device__ __forceinline__ float scale_sample(float v) {
  return fminf(__fmul_rn(v, 8.0f), 16.0f);
}

__device__ __forceinline__ float get_sample(const float* __restrict__ vol,
                                            int n, const Axis& x,
                                            const Axis& y, const Axis& z) {
  return scale_sample(trilinear(vol, n, x, y, z));
}

// tex = TEX_SCALE * pos + 0.5, TEX_SCALE = (0.5, -0.5, 0.5)
__device__ __forceinline__ float to_tex(float scale, float p) {
  return __fadd_rn(__fmul_rn(scale, p), 0.5f);
}

__device__ __forceinline__ bool in_box(float x, float y, float z) {
  return fabsf(x) <= 1.0f && fabsf(y) <= 1.0f && fabsf(z) <= 1.0f;
}

}  // namespace dxv
