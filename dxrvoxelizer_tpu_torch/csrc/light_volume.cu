// Light volume: the reference's light march from every voxel centre,
// directional or point light (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/raymarch_fast.py::precompute_light_volume
// (an XLA function, not a Pallas kernel): per voxel centre pos0 (built as
// meshgrid(t, -t, t)), 32 steps pos0 + step * (j + 1) toward the light,
// each a trilinear density read (GetSample), transmittance as a cumprod and
// the loop's breaks as monotone masks (PSRayCast.hlsl:156-173), over chunks
// of 2^19 voxels. Here each voxel is one thread that runs the loop with its
// breaks: the first step outside the box ends it, and so does the first
// step whose transmittance falls below 0.01, whose value is the result.
// The step is shared for the directional light (light_dir * MAX_DIST /
// n_light, computed on the host) and normalize(light - pos0) * MAX_DIST /
// n_light per voxel for the point light (the _POINT_LIGHT_ branch,
// PSRayCast.hlsl:151-154).
//
// What bounds it on the card: operations, at 49 FP32 operations per live
// step (chip_smoke.py LIGHT_OPS_*), against bytes of one density read and
// one write per voxel (8 bytes); a step's loads depend on the previous
// step's break, so each thread is a latency chain, and neighbouring voxels'
// rays are parallel (directional) or nearly so (point), so their taps share
// cache lines.
//
// Design: one thread per voxel in blocks of 256 consecutive voxels of the
// row-major [x, y, z] grid (z fastest), so a warp's 32 rays start at 32
// neighbouring voxel centres of one z-row. The voxel-centre coordinates t
// come from the plain version's table (the same tensor), so pos0 is the
// same bits on both; every operation is an explicitly rounded intrinsic in
// the plain version's order (trilinear.cuh), so the kernel matches it bit
// for bit. A simple kernel that is right: making it fast is later work.

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr float kZeroThreshold = 0.01f;  // PSRayCast.hlsl:10
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
light_volume_kernel(const float* __restrict__ density,
                    const float* __restrict__ t, float* __restrict__ out,
                    int n, int n_light, float lss, float vx, float vy,
                    float vz, int point) {
  const size_t v = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t nn = static_cast<size_t>(n);
  if (v >= nn * nn * nn) return;
  const int iz = static_cast<int>(v % nn);
  const int iy = static_cast<int>((v / nn) % nn);
  const int ix = static_cast<int>(v / (nn * nn));
  const float p0x = t[ix], p0y = -t[iy], p0z = t[iz];
  float sx = vx, sy = vy, sz = vz;  // the directional step
  if (point) {  // v = the light point: normalize(light - pos0) * lss
    const float lx = __fsub_rn(vx, p0x);
    const float ly = __fsub_rn(vy, p0y);
    const float lz = __fsub_rn(vz, p0z);
    const float nrm = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(lx, lx), __fmul_rn(ly, ly)), __fmul_rn(lz, lz)));
    sx = __fmul_rn(__fdiv_rn(lx, nrm), lss);
    sy = __fmul_rn(__fdiv_rn(ly, nrm), lss);
    sz = __fmul_rn(__fdiv_rn(lz, nrm), lss);
  }
  float trans = 1.0f;
  for (int j = 0; j < n_light; ++j) {
    // the first sample is one step off (PSRayCast.hlsl:157)
    const float k = static_cast<float>(j + 1);
    const float px = __fadd_rn(p0x, __fmul_rn(sx, k));
    const float py = __fadd_rn(p0y, __fmul_rn(sy, k));
    const float pz = __fadd_rn(p0z, __fmul_rn(sz, k));
    if (!dxv::in_box(px, py, pz)) break;
    const float dens = dxv::get_sample(
        density, n, dxv::axis_taps(dxv::to_tex(0.5f, px), n),
        dxv::axis_taps(dxv::to_tex(-0.5f, py), n),
        dxv::axis_taps(dxv::to_tex(0.5f, pz), n));
    const float att =
        fminf(fmaxf(__fsub_rn(1.0f, __fmul_rn(lss, dens)), 0.0f), 1.0f);
    trans = __fmul_rn(trans, att);
    if (trans < kZeroThreshold) break;
  }
  out[v] = trans;
}

}  // namespace

extern "C" int dxv_light_volume(const void* density, const void* t, void* out,
                                int n, int n_light, float lss, float vx,
                                float vy, float vz, int point, void* stream) {
  const size_t voxels = static_cast<size_t>(n) * n * n;
  if (voxels == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((voxels + kThreads - 1) / kThreads);
  light_volume_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(density), static_cast<const float*>(t),
      static_cast<float*>(out), n, n_light, lss, vx, vy, vz, point);
  return static_cast<int>(cudaGetLastError());
}
