// Screen resolve + final composite of the shear-warp renderer (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/screen_warp_pallas.py::_resolve_kernel
// (launched by bilinear_resolve). Same computation: each screen pixel
// bilinearly samples the composited scatter and transmit intermediates
// ([M, M] f32) at (gi_x, gi_y), clamp-to-edge at M-1 like
// raymarch_warp._bilinear_take. Fused here: the final composite of
// raymarch_warp._shearwarp_core (base = 0.8*scatter + 0.2, lerp to the
// squared clear colour by clip(transmit, 0, 1), sqrt, clear colour where the
// pixel misses the volume), written as [H, W, 3].
//
// What bounds it on the card: device-memory bytes. Per pixel it reads two
// coordinates and a mask byte (9 bytes) and writes 12; the two [M, M]
// intermediates (64 KB each at M = 128) stay in L1/L2, and neighbouring
// pixels read neighbouring texels.
//
// Design: one thread per pixel, plain FP32 loads of the four taps (not the
// texture unit, whose fixed-point filter weights would move pixels). The
// TPU kernel's row windows, lane gathers and 32x32 block layout existed to
// build a gather out of vector lane shuffles; none of that is needed here.
// The weights and the composite use __fmul_rn/__fadd_rn in the order of
// the plain torch expressions, so the two agree to the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Bilinear {
  int a00, a10, a01, a11;
  float fx, fy;
};

__device__ __forceinline__ Bilinear setup(float x, float y, int m) {
  const float hi = static_cast<float>(m - 1);
  const int x0 = static_cast<int>(fminf(fmaxf(floorf(x), 0.0f), hi));
  const int y0 = static_cast<int>(fminf(fmaxf(floorf(y), 0.0f), hi));
  const int x1 = min(x0 + 1, m - 1);
  const int y1 = min(y0 + 1, m - 1);
  Bilinear b;
  // fractions from the *clamped* base texel (edge-clamp semantics)
  b.fx = fminf(fmaxf(sub(x, static_cast<float>(x0)), 0.0f), 1.0f);
  b.fy = fminf(fmaxf(sub(y, static_cast<float>(y0)), 0.0f), 1.0f);
  b.a00 = x0 * m + y0;
  b.a10 = x1 * m + y0;
  b.a01 = x0 * m + y1;
  b.a11 = x1 * m + y1;
  return b;
}

// v00*(1-fx)*(1-fy) + v10*fx*(1-fy) + v01*(1-fx)*fy + v11*fx*fy, left to right
__device__ __forceinline__ float sample(const float* __restrict__ img,
                                        const Bilinear& b) {
  const float gx = sub(1.0f, b.fx);
  const float gy = sub(1.0f, b.fy);
  float v = mul(mul(img[b.a00], gx), gy);
  v = add(v, mul(mul(img[b.a10], b.fx), gy));
  v = add(v, mul(mul(img[b.a01], gx), b.fy));
  v = add(v, mul(mul(img[b.a11], b.fx), b.fy));
  return v;
}

__global__ void __launch_bounds__(kBlock)
resolve_kernel(const float* __restrict__ scatter,
               const float* __restrict__ transmit, const float* __restrict__ gx,
               const float* __restrict__ gy, const uint8_t* __restrict__ ok,
               float* __restrict__ out, int p, int m, float c0, float c1,
               float c2) {
  const int idx = blockIdx.x * kBlock + threadIdx.x;
  if (idx >= p) return;
  float* o = out + static_cast<size_t>(idx) * 3;
  if (!ok[idx]) {  // miss: the clear colour (PSRayCast.hlsl:121)
    o[0] = c0;
    o[1] = c1;
    o[2] = c2;
    return;
  }
  const Bilinear b = setup(gx[idx], gy[idx], m);
  const float sc = sample(scatter, b);
  const float tr = sample(transmit, b);
  const float base = add(mul(sc, 0.8f), 0.2f);
  const float trc = fminf(fmaxf(tr, 0.0f), 1.0f);
  const float cc[3] = {mul(c0, c0), mul(c1, c1), mul(c2, c2)};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float res = add(base, mul(sub(cc[c], base), trc));
    o[c] = __fsqrt_rn(fmaxf(res, 0.0f));
  }
}

}  // namespace

// scatter, transmit [m, m]; gx, gy [p] f32; ok [p] uint8 (bool);
// out [p, 3] f32; (c0, c1, c2) the clear colour.
extern "C" int dxv_resolve(const float* scatter, const float* transmit,
                           const float* gx, const float* gy, const void* ok,
                           float* out, int p, int m, float c0, float c1,
                           float c2, void* stream) {
  if (p < 0 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return static_cast<int>(cudaGetLastError());
  resolve_kernel<<<(p + kBlock - 1) / kBlock, kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      scatter, transmit, gx, gy, static_cast<const uint8_t*>(ok), out, p, m,
      c0, c1, c2);
  return static_cast<int>(cudaGetLastError());
}
