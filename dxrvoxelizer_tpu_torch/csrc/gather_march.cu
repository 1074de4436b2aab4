// Gather ray-march: the reference's primary march per screen pixel, with
// the light transmittance read from a precomputed light volume (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/raymarch_fast.py::raymarch_fast, the march
// of its chunk_fn (an XLA function, not a Pallas kernel): 128 samples per
// pixel at pos_s = entry + dir * (s * step), each an 8-tap trilinear read of
// the density (GetSample, PSRayCast.hlsl:103-112) and, where it contributes,
// one of the light volume; transmittance as a cumprod and the shader's
// breaks as monotone masks, over chunks of 2^17 pixels. On a TPU that form
// avoids a sequential loop; here each pixel is one thread that runs the
// loop and breaks, as the shader does (PSRayCast.hlsl:134-179): the first
// step outside the box ends the march, and so does the first occupied step
// whose transmittance falls below 0.01, whose value is then the final one.
// The composite follows: scatter * 0.8 + 0.2 lerped to clear^2 by the
// transmittance, its square root, and the clear colour for misses.
//
// What bounds it on the card: its least time is set by bytes, the rays
// in and the colours out (37 bytes per pixel, 34 MB at 1280x720, beside
// the two volumes: 1 MiB each at 64^3, 64 MiB at 256^3), against 46 FP32
// operations per density sample and 27 per contributing step
// (chip_smoke.py GATHER_OPS_*). In practice one ray is a dependent chain:
// each step's eight taps depend on the position, and whether the next step
// runs depends on this step's transmittance, so a thread issues one step's
// loads only after the previous step is done.
//
// Design: one thread per pixel in blocks of 256 consecutive pixels of the
// row-major screen, so a warp's 32 rays are neighbours in a row whose taps
// fall in the same cache lines; the volumes are read through the read-only
// path (__ldg). Entry, direction and hit come from the plain ray set-up
// (ops/raymarch_fast.py gather_rays: compute_start_point and the
// screen-to-local transform), which both versions share, as does the table
// of step offsets s * step (soff). A warp runs until its last ray stops.
// Every operation is an explicitly rounded intrinsic in the plain
// version's order (trilinear.cuh), so the kernel is the plain version bit
// for bit. A simple kernel that is right: making it fast is later work.

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr float kZeroThreshold = 0.01f;  // PSRayCast.hlsl:10
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_march_kernel(const float* __restrict__ density,
                    const float* __restrict__ light,
                    const float* __restrict__ entry,
                    const float* __restrict__ dir,
                    const unsigned char* __restrict__ hit,
                    const float* __restrict__ soff, float* __restrict__ rgb,
                    int n, int n_px, int n_samples, float step_scale,
                    float clear_r, float clear_g, float clear_b) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_px) return;
  float* out = rgb + 3 * static_cast<size_t>(p);
  if (!hit[p]) {  // misses return the clear color (PSRayCast.hlsl:121)
    out[0] = clear_r;
    out[1] = clear_g;
    out[2] = clear_b;
    return;
  }
  const float ex = entry[3 * p], ey = entry[3 * p + 1], ez = entry[3 * p + 2];
  const float dx = dir[3 * p], dy = dir[3 * p + 1], dz = dir[3 * p + 2];
  float transmit = 1.0f;
  float scatter = 0.0f;
  for (int s = 0; s < n_samples; ++s) {
    const float o = __ldg(soff + s);
    const float px = __fadd_rn(ex, __fmul_rn(dx, o));
    const float py = __fadd_rn(ey, __fmul_rn(dy, o));
    const float pz = __fadd_rn(ez, __fmul_rn(dz, o));
    if (!dxv::in_box(px, py, pz)) break;
    const dxv::Axis ax = dxv::axis_taps(dxv::to_tex(0.5f, px), n);
    const dxv::Axis ay = dxv::axis_taps(dxv::to_tex(-0.5f, py), n);
    const dxv::Axis az = dxv::axis_taps(dxv::to_tex(0.5f, pz), n);
    const float dens = dxv::get_sample(density, n, ax, ay, az);
    if (!(dens > kZeroThreshold)) continue;
    const float sigma = __fmul_rn(dens, step_scale);
    const float att = fminf(fmaxf(__fsub_rn(1.0f, sigma), 0.0f), 1.0f);
    transmit = __fmul_rn(transmit, att);
    // the shader breaks BEFORE accumulating scatter (PSRayCast.hlsl:147-148)
    if (transmit < kZeroThreshold) break;
    const float lt = dxv::trilinear(light, n, ax, ay, az);
    scatter = __fadd_rn(scatter, __fmul_rn(__fmul_rn(lt, transmit), sigma));
  }
  const float r = __fadd_rn(__fmul_rn(scatter, 0.8f), 0.2f);
  const float cc[3] = {clear_r, clear_g, clear_b};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float cc2 = __fmul_rn(cc[c], cc[c]);
    out[c] = __fsqrt_rn(__fadd_rn(r, __fmul_rn(__fsub_rn(cc2, r), transmit)));
  }
}

}  // namespace

extern "C" int dxv_gather_march(const void* density, const void* light,
                                const void* entry, const void* dir,
                                const void* hit, const void* soff, void* rgb,
                                int n, int n_px, int n_samples,
                                float step_scale, float clear_r, float clear_g,
                                float clear_b, void* stream) {
  if (n_px <= 0) return 0;
  const int blocks = (n_px + kThreads - 1) / kThreads;
  gather_march_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(density), static_cast<const float*>(light),
      static_cast<const float*>(entry), static_cast<const float*>(dir),
      static_cast<const unsigned char*>(hit), static_cast<const float*>(soff),
      static_cast<float*>(rgb), n, n_px, n_samples, step_scale, clear_r,
      clear_g, clear_b);
  return static_cast<int>(cudaGetLastError());
}
