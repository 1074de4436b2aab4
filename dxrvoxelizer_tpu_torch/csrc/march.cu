// Fused shear-warp march: z-mix, bilinear warp and front-to-back
// compositing of every sub-slab, per intermediate pixel (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/march_pallas.py::_march_kernel (launched
// by march_pallas). Same computation: sub-slab s of KS = K*ss z-mixes the
// (density, light) slabs i0(s), i1(s) with weight wts[s], warps them to the
// M x M intermediate, and updates transmit/scatter with the shader's
// absorption (g = min(8d, 16), sigma = g*delta, early-out at 0.01, near-clip
// mask front[s]).
//
// What bounds it on the card: the TPU kernel warps with two dense
// [M,N]x[N,N] matmuls per sub-slab because its matrix unit is the fast path;
// the matrices are 2-tap interpolation rows (ops/warp.py interp_matrix), so
// all but two terms of every dot product are zero. Here the warp is a
// 4-tap bilinear read per pixel: 16 scalar loads per pixel per sub-slab
// (2 channels x 2 z-slabs x 4 taps), served mostly from L1/L2 because
// neighbouring pixels read neighbouring texels. The per-slab work is small
// and sequential along the ray, so latency, not bandwidth, bounds it.
//
// Design: one thread per intermediate pixel, looping over the KS sub-slabs
// with transmit and scatter in registers — no [KS, M, M] warped volume is
// ever written. Instead of the dense [KS, M, N] matrices the kernel takes
// each sub-slab's scale/offset (raymarch_warp._shearwarp_core) and rebuilds
// the two weights exactly as interp_matrix does (coordinate
// scale*(i+0.5)+offset, floor, zero weight for a tap outside [0, N-1]).
// The loop stops once transmit has died (< 0.01): from then on the shader
// rules change neither transmit nor scatter. Everything stays FP32.

#include <cuda_runtime.h>

namespace {

constexpr float kAbsorption = 1.0f;     // PSRayCast.hlsl:9
constexpr float kZeroThreshold = 0.01f;  // PSRayCast.hlsl:10
constexpr int kBlock = 16;

struct Taps {
  int i0, i1;    // clamped read indices
  float w0, w1;  // interpolation weights (0 outside the volume)
};

// interp_matrix row for output texel `o` under coord = scale*(o+0.5)+offset
__device__ __forceinline__ Taps taps(float scale, float offset, int o, int n) {
  const float c = __fadd_rn(__fmul_rn(scale, static_cast<float>(o) + 0.5f),
                            offset);
  const float c0 = floorf(c);
  const float f = __fsub_rn(c, c0);
  const int i0 = static_cast<int>(c0);
  const int i1 = i0 + 1;
  Taps t;
  t.w0 = (i0 >= 0 && i0 <= n - 1) ? __fsub_rn(1.0f, f) : 0.0f;
  t.w1 = (i1 >= 0 && i1 <= n - 1) ? f : 0.0f;
  t.i0 = min(max(i0, 0), n - 1);
  t.i1 = min(max(i1, 0), n - 1);
  return t;
}

// floor((2s + 1 - ss) / (2ss)) clipped to [0, kn-1] (march_pallas.py:129-139)
__device__ __forceinline__ int first_slab(int s, int ss, int kn) {
  const int num = 2 * s + 1 - ss;
  const int den = 2 * ss;
  const int q = num >= 0 ? num / den : -((-num + den - 1) / den);
  return min(max(q, 0), kn - 1);
}

__global__ void __launch_bounds__(kBlock * kBlock)
march_kernel(const float* __restrict__ slabs, const float* __restrict__ wts,
             const float* __restrict__ front,
             const float* __restrict__ scale_x, const float* __restrict__ off_x,
             const float* __restrict__ scale_y, const float* __restrict__ off_y,
             const float* __restrict__ delta, float* __restrict__ transmit_out,
             float* __restrict__ scatter_out, int kn, int n, int m, int ss) {
  const int i = blockIdx.y * kBlock + threadIdx.y;  // intermediate row (x)
  const int j = blockIdx.x * kBlock + threadIdx.x;  // intermediate col (y)
  if (i >= m || j >= m) return;
  const size_t plane = static_cast<size_t>(n) * n;
  const float* dens = slabs;
  const float* light = slabs + static_cast<size_t>(kn) * plane;
  const float dl = delta[i * m + j];
  const int ks = kn * ss;

  float transmit = 1.0f;
  float scatter = 0.0f;
  for (int s = 0; s < ks && transmit >= kZeroThreshold; ++s) {
    const Taps tx = taps(scale_x[s], off_x[s], i, n);
    const Taps ty = taps(scale_y[s], off_y[s], j, n);
    if ((tx.w0 == 0.0f && tx.w1 == 0.0f) || (ty.w0 == 0.0f && ty.w1 == 0.0f))
      continue;  // pixel outside this slab's footprint: nothing to absorb
    const size_t a00 = static_cast<size_t>(tx.i0) * n + ty.i0;
    const size_t a01 = static_cast<size_t>(tx.i0) * n + ty.i1;
    const size_t a10 = static_cast<size_t>(tx.i1) * n + ty.i0;
    const size_t a11 = static_cast<size_t>(tx.i1) * n + ty.i1;
    float d00, d01, d10, d11, l00, l01, l10, l11;
    if (ss == 1) {
      const size_t o = static_cast<size_t>(s) * plane;
      d00 = dens[o + a00]; d01 = dens[o + a01];
      d10 = dens[o + a10]; d11 = dens[o + a11];
      l00 = light[o + a00]; l01 = light[o + a01];
      l10 = light[o + a10]; l11 = light[o + a11];
    } else {
      // z-LERP of the two source slabs, then the warp (the XLA order)
      const int z0 = first_slab(s, ss, kn);
      const int z1 = min(z0 + 1, kn - 1);
      const float w = wts[s];
      const float u = 1.0f - w;
      const size_t o0 = static_cast<size_t>(z0) * plane;
      const size_t o1 = static_cast<size_t>(z1) * plane;
      d00 = dens[o0 + a00] * u + dens[o1 + a00] * w;
      d01 = dens[o0 + a01] * u + dens[o1 + a01] * w;
      d10 = dens[o0 + a10] * u + dens[o1 + a10] * w;
      d11 = dens[o0 + a11] * u + dens[o1 + a11] * w;
      l00 = light[o0 + a00] * u + light[o1 + a00] * w;
      l01 = light[o0 + a01] * u + light[o1 + a01] * w;
      l10 = light[o0 + a10] * u + light[o1 + a10] * w;
      l11 = light[o0 + a11] * u + light[o1 + a11] * w;
    }
    // (wx @ slab) then (@ wy^T): x taps first, then y taps
    const float dy0 = tx.w0 * d00 + tx.w1 * d10;
    const float dy1 = tx.w0 * d01 + tx.w1 * d11;
    const float d_w = dy0 * ty.w0 + dy1 * ty.w1;
    const float ly0 = tx.w0 * l00 + tx.w1 * l10;
    const float ly1 = tx.w0 * l01 + tx.w1 * l11;
    const float l_w = ly0 * ty.w0 + ly1 * ty.w1;

    // compositing update (raymarch_warp._shearwarp_core's step)
    const float g_s = fminf(d_w * 8.0f, 16.0f);
    const bool occupied = (g_s > kZeroThreshold) && (front[s] > 0.0f);
    const float sigma = g_s * dl;
    const float att =
        occupied ? fminf(fmaxf(1.0f - sigma * kAbsorption, 0.0f), 1.0f) : 1.0f;
    const float new_transmit = transmit * att;
    if (occupied && new_transmit >= kZeroThreshold)
      scatter += l_w * new_transmit * sigma;
    transmit = new_transmit;  // the loop condition holds transmit >= 0.01
  }
  transmit_out[i * m + j] = transmit;
  scatter_out[i * m + j] = scatter;
}

}  // namespace

// slabs [2, kn, n, n] (density, light; far axis first); wts, front, scale_x,
// off_x, scale_y, off_y [kn*ss]; delta [m, m]; transmit, scatter [m, m].
extern "C" int dxv_march(const float* slabs, const float* wts,
                         const float* front, const float* scale_x,
                         const float* off_x, const float* scale_y,
                         const float* off_y, const float* delta,
                         float* transmit, float* scatter, int kn, int n, int m,
                         int ss, void* stream) {
  if (kn < 1 || n < 1 || m < 1 || ss < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlock, kBlock);
  const dim3 grid((m + kBlock - 1) / kBlock, (m + kBlock - 1) / kBlock);
  march_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      slabs, wts, front, scale_x, off_x, scale_y, off_y, delta, transmit,
      scatter, kn, n, m, ss);
  return static_cast<int>(cudaGetLastError());
}
