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
// n_light, computed on the host and passed by value) and
// normalize(light - pos0) * MAX_DIST / n_light per voxel for the point
// light (the _POINT_LIGHT_ branch, PSRayCast.hlsl:151-154).
//
// What bounds it on the card: by the count of chip_smoke.py (LIGHT_OPS_*),
// operations, at 49 FP32 operations per live step, against bytes of one
// density read and one write per voxel (8 bytes). In practice its integer
// and address work and its taps: a ray takes few live steps (3.4 on
// average on the 256^3 icosphere frame: it leaves the box or dies within a
// few), each step 14 voxels from the last at 256^3, so a step's taps come
// from L2 or device memory, and at 256^3 the density (64 MiB) and the
// output (64 MiB) exceed the 50 MB L2.
//
// Design:
// - No host-to-card copy: each thread computes its voxel-centre coordinate
//   (i + 0.5) / n * 2 - 1 with the rounded intrinsics in that order, the
//   bits of the plain version's host table (torch's CPU division is
//   correctly rounded); the step is passed by value.
// - The loads may run ahead of the breaks: the steps go in batches of K; a
//   batch first computes every position and issues all its taps (a
//   clamped tap is always a valid address; a step outside the box, which
//   ends the march, loads none), then applies the two break rules step by
//   step in order, with the same rounded operations. Values read past a
//   break are discarded. A sweep of K = 1, 2, 4, 8 (PERF.md §6) measured
//   K = 1 fastest, so kK = 1: no load is issued ahead of a break test. The
//   batch is kept so that kK can be raised.
// - Blocks are 4 x 8 x 8 voxel bricks (x, y, z; z fastest, so a warp is 4
//   y-rows of 8 z): neighbouring rays are parallel (directional) or nearly
//   so (point), so a brick's taps share cache lines step after step. The
//   same sweep measured them faster than rows of 256 voxels and than
//   2 x 4 x 32 and 1 x 8 x 32 bricks.
// - Taps index with 32-bit offsets (n <= 1024): fewer integer operations.
// Every operation is an explicitly rounded intrinsic in the plain version's
// order (trilinear.cuh), so the kernel matches it bit for bit.

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr float kZeroThreshold = 0.01f;  // PSRayCast.hlsl:10
constexpr int kThreads = 256;
constexpr int kK = 1;  // steps per batch
// a block's brick of voxels (x, y, z; z fastest): a warp is 4 y-rows of 8 z
constexpr int kBrickX = 4, kBrickY = 8, kBrickZ = 8;
static_assert(kBrickX * kBrickY * kBrickZ == kThreads, "brick");

// (i + 0.5) / n * 2 - 1, rounded as the plain version's host table
__device__ __forceinline__ float centre(int i, float n) {
  return __fsub_rn(
      __fmul_rn(__fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f), n), 2.0f),
      1.0f);
}

// this thread's voxel; false past the grid's edge
__device__ __forceinline__ bool voxel_of(int n, int& ix, int& iy, int& iz) {
  const int bz = (n + kBrickZ - 1) / kBrickZ;
  const int by = (n + kBrickY - 1) / kBrickY;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  iz = (b % bz) * kBrickZ + (t % kBrickZ);
  iy = ((b / bz) % by) * kBrickY + (t / kBrickZ) % kBrickY;
  ix = (b / (bz * by)) * kBrickX + t / (kBrickZ * kBrickY);
  return ix < n && iy < n && iz < n;
}

__global__ void __launch_bounds__(kThreads)
light_volume_kernel(const float* __restrict__ density, float* __restrict__ out,
                    int n, int n_light, float lss, float vx, float vy,
                    float vz, int point) {
  int ix, iy, iz;
  if (!voxel_of(n, ix, iy, iz)) return;
  const float nf = static_cast<float>(n);
  const float p0x = centre(ix, nf), p0y = -centre(iy, nf),
              p0z = centre(iz, nf);
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
  for (int j0 = 0; j0 < n_light; j0 += kK) {
    // issue: every position and tap of the batch, before any break test
    dxv::Taps taps[kK];
    float fx[kK], fy[kK], fz[kK];
    bool inside[kK];
#pragma unroll
    for (int b = 0; b < kK; ++b) {
      // the first sample is one step off (PSRayCast.hlsl:157)
      const float k = static_cast<float>(j0 + b + 1);
      const float px = __fadd_rn(p0x, __fmul_rn(sx, k));
      const float py = __fadd_rn(p0y, __fmul_rn(sy, k));
      const float pz = __fadd_rn(p0z, __fmul_rn(sz, k));
      inside[b] = dxv::in_box(px, py, pz);
      const dxv::Axis ax = dxv::axis_taps(dxv::to_tex(0.5f, px), n);
      const dxv::Axis ay = dxv::axis_taps(dxv::to_tex(-0.5f, py), n);
      const dxv::Axis az = dxv::axis_taps(dxv::to_tex(0.5f, pz), n);
      // a step outside the box ends the march: its taps are not loaded
      taps[b] = inside[b] ? dxv::load_taps(density, n, ax, ay, az) : dxv::Taps{};
      fx[b] = ax.f;
      fy[b] = ay.f;
      fz[b] = az.f;
    }
    // apply: the breaks in step order; values past a break are discarded
    bool done = false;
#pragma unroll
    for (int b = 0; b < kK; ++b) {
      if (j0 + b >= n_light || !inside[b]) {
        done = true;
        break;
      }
      const float dens =
          dxv::scale_sample(dxv::combine(taps[b], fx[b], fy[b], fz[b]));
      const float att =
          fminf(fmaxf(__fsub_rn(1.0f, __fmul_rn(lss, dens)), 0.0f), 1.0f);
      trans = __fmul_rn(trans, att);
      if (trans < kZeroThreshold) {
        done = true;
        break;
      }
    }
    if (done) break;
  }
  out[(static_cast<size_t>(ix) * n + iy) * n + iz] = trans;
}

}  // namespace

extern "C" int dxv_light_volume(const void* density, void* out, int n,
                                int n_light, float lss, float vx, float vy,
                                float vz, int point, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>(((n + kBrickX - 1) / kBrickX) *
                            ((n + kBrickY - 1) / kBrickY) *
                            ((n + kBrickZ - 1) / kBrickZ));
  light_volume_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(density), static_cast<float*>(out), n,
      n_light, lss, vx, vy, vz, point);
  return static_cast<int>(cudaGetLastError());
}
