// Ray-stab Moller-Trumbore closest hit of voxel rays against per-cell
// candidate lists (Hopper): the gen-1 accel's query kernel.
//
// Replaces: dxrvoxelizer_tpu/ops/raystab_pallas.py::_stab_kernel (launched by
// stab_closest_hit, for a gen-1 accel from raystab_fast._raystab_query_pallas).
// Same computation: every voxel ray (origin = voxel centre, direction =
// normalized centre) is tested against its direction cell's candidate rows
// with the no-culling Moller-Trumbore test (ops/intersect.py mt_hit); per ray
// the lexicographic (t, lowest triangle id) minimum over its hits, written as
// t (+inf on a miss) and the id (2^30 on a miss). The overflow stream tests
// every ray against the same rows: the overflow triangles, whose direction
// cones span too many cells to bin.
//
// Inputs: pos, dirs [V, 3] f32, the rays in voxel order; slice s holds
// ray_cnt[s] <= 128 rays, ray_ids[ray_off[s] + l], and tests them against
// rows[cand_off[s] .. cand_off[s] + cand_cnt[s]), each 12 floats
// v0(3) e1(3) e2(3) id-as-f32 pad(2). The slices of one launch cover every
// ray once, so t and id are written straight into ray order: the TPU's
// scatter of per-cell slots (.at[scatter].set) is a permutation here.
//
// What bounds it on the card: FP32 arithmetic per (ray, candidate) pair --
// two cross products, four 3-term dot products, the reciprocal of the
// determinant, three scalings and the compares (55 operations for a hit,
// fewer for a pair that fails a test early; none fuse into an FMA). Each
// candidate row (48 bytes) is read from device memory once per slice and
// broadcast from shared memory to the slice's rays, so bytes are well under
// one per pair.
//
// Design: one block of 128 threads per slice, one thread per ray (a direction
// cell with more rays than 128 is several slices over the same rows, so no
// block loops over rays); the slice's candidate rows are staged through shared
// memory 256 rows (12 KiB) at a time as float4 loads; each thread keeps its
// running (t, id) in registers and folds its hits in candidate order with the
// strict lexicographic rule, which is total on distinct ids, so it picks the
// TPU kernel's tree fold's winner, and its t keeps the winner's own bits. A
// pair leaves the test as soon as one of the hit conditions fails; every
// value it computes is the JAX expression's. The chains use
// __fmul_rn/__fadd_rn/__fsub_rn in mt_hit's order, and the reciprocal is
// __fdiv_rn(1, det), JAX's 1.0 / det, so nothing contracts into an FMA and
// (t, id) are bit-identical to the plain version. Slices come ordered widest
// candidate list first, so the launch's tail is short slices. The overflow
// stream is a second launch of the same kernel; it takes any number of rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 256;
constexpr int kRow4 = 3;  // float4s per 12-float row
constexpr float kBigId = 1073741824.0f;  // 2^30
constexpr float kEpsDet = 1e-10f;
constexpr float kTMax = 1e4f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// a * b - c * d, one rounding per operation (a cross-product component)
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

__global__ void __launch_bounds__(kLanes)
mt_kernel(const float* __restrict__ pos, const float* __restrict__ dirs,
          const int* __restrict__ ray_ids, const int* __restrict__ ray_off,
          const int* __restrict__ ray_cnt, const int* __restrict__ cand_off,
          const int* __restrict__ cand_cnt, const float4* __restrict__ rows,
          float* __restrict__ t_out, int* __restrict__ i_out) {
  __shared__ float4 cand[kChunk * kRow4];
  const int s = blockIdx.x;
  const int l = threadIdx.x;
  const bool live = l < ray_cnt[s];
  int ray = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    const int j = ray_off[s] + l;
    ray = ray_ids[j];
    const float* o = pos + static_cast<size_t>(ray) * 3;
    const float* d = dirs + static_cast<size_t>(ray) * 3;
    ox = o[0]; oy = o[1]; oz = o[2];
    dx = d[0]; dy = d[1]; dz = d[2];
  }
  float bt = INFINITY;
  float bi = kBigId;

  const int cnt = cand_cnt[s];
  const float4* src = rows + static_cast<size_t>(cand_off[s]) * kRow4;
  for (int c0 = 0; c0 < cnt; c0 += kChunk) {
    const int m = min(kChunk, cnt - c0);
    const float4* chunk = src + static_cast<size_t>(c0) * kRow4;
    for (int i = l; i < m * kRow4; i += kLanes) cand[i] = chunk[i];
    __syncthreads();
    if (live) {
      for (int k = 0; k < m; ++k) {
        // a = v0x v0y v0z e1x, b = e1y e1z e2x e2y, c = e2z id pad pad
        const float4 a = cand[k * kRow4];
        const float4 b = cand[k * kRow4 + 1];
        const float4 c = cand[k * kRow4 + 2];
        const float px = cross1(dy, c.x, dz, b.w);
        const float py = cross1(dz, b.z, dx, c.x);
        const float pz = cross1(dx, b.w, dy, b.z);
        const float det = dot3(a.w, b.x, b.y, px, py, pz);
        if (!(fabsf(det) > kEpsDet)) continue;
        const float inv = __fdiv_rn(1.0f, det);
        const float tvx = __fsub_rn(ox, a.x);
        const float tvy = __fsub_rn(oy, a.y);
        const float tvz = __fsub_rn(oz, a.z);
        const float u = __fmul_rn(dot3(tvx, tvy, tvz, px, py, pz), inv);
        if (!(u >= 0.0f)) continue;
        const float qx = cross1(tvy, b.y, tvz, b.x);
        const float qy = cross1(tvz, a.w, tvx, b.y);
        const float qz = cross1(tvx, b.x, tvy, a.w);
        const float v = __fmul_rn(dot3(dx, dy, dz, qx, qy, qz), inv);
        if (!(v >= 0.0f) || !(__fadd_rn(u, v) <= 1.0f)) continue;
        const float t = __fmul_rn(dot3(b.z, b.w, c.x, qx, qy, qz), inv);
        if (!(t >= 0.0f) || !(t <= kTMax)) continue;
        if (t < bt || (t == bt && c.y < bi)) {
          bt = t;
          bi = c.y;
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
  if (live) {
    t_out[ray] = bt;
    i_out[ray] = static_cast<int>(bi);
  }
}

}  // namespace

// pos, dirs [V, 3] f32; ray_ids [R] int32; ray_off, ray_cnt,
// cand_off, cand_cnt [slices] int32; rows [P, 12] f32, 16-byte aligned;
// t_out [V] f32; i_out [V] int32.
extern "C" int dxv_raystab_mt(const float* pos, const float* dirs,
                              const int* ray_ids, const int* ray_off,
                              const int* ray_cnt, const int* cand_off,
                              const int* cand_cnt, const float* rows,
                              float* t_out, int* i_out, int slices,
                              void* stream) {
  if (slices < 0 || (reinterpret_cast<uintptr_t>(rows) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slices > 0) {
    mt_kernel<<<slices, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        pos, dirs, ray_ids, ray_off, ray_cnt, cand_off, cand_cnt,
        reinterpret_cast<const float4*>(rows), t_out, i_out);
  }
  return static_cast<int>(cudaGetLastError());
}
