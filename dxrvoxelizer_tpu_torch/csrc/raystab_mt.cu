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
// ray_cnt[s] <= lanes rays, ray_ids[ray_off[s] + l], and tests them against
// rows[cand_off[s] .. cand_off[s] + cand_cnt[s]), each 12 floats
// v0(3) e1(3) e2(3) id-as-f32 pad(2). The slices of one launch cover every
// ray once, so t and id are written straight into ray order: the TPU's
// scatter of per-cell slots (.at[scatter].set) is a permutation here.
//
// What bounds it on the card: FP32 instructions per (ray, candidate) pair.
// A pair that reaches every test costs two cross products, four 3-term dot
// products, the reciprocal of the determinant, three scalings and the
// compares (55 operations, none fused into an FMA); most pairs leave early:
// at 64^3 on a sphere 57 % pass u >= 0, 25 % v >= 0 and 2.8 % u + v <= 1.
// Each candidate row (48 bytes) is read once per slice and shared by the
// slice's rays, so bytes are well under one per pair.
//
// Design:
// - The division is deferred past the three sign tests. A pair computes
//   det, u_num = tv . p and, past u, v_num = d . q, and leaves without
//   dividing where the decision is certain: u = rn(u_num * rn(1/det)) is
//   negative when u_num's sign opposes det's and |u_num| > |det| 2^-64 (the
//   product is then far from the underflow that would round it to -0.0,
//   which passes u >= 0); v alike; and u + v > 1 when u_num + v_num, signs
//   taken relative to det, exceeds |det| (1 + 2^-16), a margin that covers
//   every rounding of u, v and their sum. Every other pair takes
//   inv = __fdiv_rn(1, det), JAX's 1.0 / det, and mt_hit's exact tests in
//   its order, t >= 0 and t <= 1e4 included, so (t, id) stay bit-identical
//   to the plain version (raystab_mt_cuda.mt_rejects replays the rejects).
// - Slices are `lanes` rays wide (32, 64 or 128: the accel's slicing,
//   raystab_mt_cuda.LANES), several to a block of `threads` threads, a lane
//   group per slice, so that no warp idles on a slice's missing rays past
//   the last warp a slice needs. A group reads its rows either straight from
//   device memory, every lane of a warp the same row (a broadcast through
//   the L1), or staged 64 rows at a time into shared memory by cp.async
//   between two barriers of its own (bar.sync on the group's id), the first
//   64 in flight while the group loads its rays.
// - Each thread keeps its running (t, id) in registers and folds its hits in
//   candidate order with the strict lexicographic rule, which is total on
//   distinct ids, so it picks the TPU kernel's tree fold's winner, and its t
//   keeps the winner's own bits. The chains use __fmul_rn/__fadd_rn/
//   __fsub_rn in mt_hit's order, so nothing contracts into an FMA.
// chip_smoke.py (phase 16b) times lanes x threads x deferred x staged;
// dxv_raystab_mt runs the settings chosen there. Slices come ordered widest
// candidate list first, so the launch's tail is short slices. The overflow
// stream is a second launch of the same kernel; it takes any number of rows.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;  // rows a group stages per round
constexpr int kRow4 = 3;  // float4s per 12-float row
constexpr float kBigId = 1073741824.0f;  // 2^30
constexpr float kEpsDet = 1e-10f;
constexpr float kTMax = 1e4f;
constexpr float kTiny = 0x1p-64f;  // |u_num| below |det| 2^-64: divide
constexpr float kSumMargin = 1.0f + 0x1p-16f;
// the main path's settings (chip_smoke.py phase 16b): threads per block,
// rows staged through shared memory (else read from device memory)
constexpr int kMainThreads = 128;
constexpr bool kMainStage = true;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// a * b - c * d, one rounding per operation (a cross-product component)
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// one (ray, candidate) pair: the row a = v0x v0y v0z e1x, b = e1y e1z e2x
// e2y, c = e2z id pad pad; a hit folds into the running (bt, bi)
template <bool DEFER>
__device__ __forceinline__ void mt_pair(const Ray& r, float4 a, float4 b,
                                        float4 c, float& bt, float& bi) {
  const float px = cross1(r.dy, c.x, r.dz, b.w);
  const float py = cross1(r.dz, b.z, r.dx, c.x);
  const float pz = cross1(r.dx, b.w, r.dy, b.z);
  const float det = dot3(a.w, b.x, b.y, px, py, pz);
  if (!(fabsf(det) > kEpsDet)) return;
  const float tvx = __fsub_rn(r.ox, a.x);
  const float tvy = __fsub_rn(r.oy, a.y);
  const float tvz = __fsub_rn(r.oz, a.z);
  const float un = dot3(tvx, tvy, tvz, px, py, pz);
  if constexpr (DEFER) {
    // the certain rejects, with u_num and v_num taken relative to det's sign
    const float ad = fabsf(det);
    const float tiny = __fmul_rn(ad, kTiny);  // exact: a normal power of two
    const float su = det > 0.0f ? un : -un;
    if (su < -tiny) return;  // u < 0
    const float qx = cross1(tvy, b.y, tvz, b.x);
    const float qy = cross1(tvz, a.w, tvx, b.y);
    const float qz = cross1(tvx, b.x, tvy, a.w);
    const float vn = dot3(r.dx, r.dy, r.dz, qx, qy, qz);
    const float sv = det > 0.0f ? vn : -vn;
    if (sv < -tiny || __fadd_rn(su, sv) > __fmul_rn(ad, kSumMargin))
      return;  // v < 0, or u + v > 1
    const float inv = __fdiv_rn(1.0f, det);
    const float u = __fmul_rn(un, inv);
    if (!(u >= 0.0f)) return;
    const float v = __fmul_rn(vn, inv);
    if (!(v >= 0.0f) || !(__fadd_rn(u, v) <= 1.0f)) return;
    const float t = __fmul_rn(dot3(b.z, b.w, c.x, qx, qy, qz), inv);
    if (!(t >= 0.0f) || !(t <= kTMax)) return;
    if (t < bt || (t == bt && c.y < bi)) {
      bt = t;
      bi = c.y;
    }
  } else {
    const float inv = __fdiv_rn(1.0f, det);
    const float u = __fmul_rn(un, inv);
    if (!(u >= 0.0f)) return;
    const float qx = cross1(tvy, b.y, tvz, b.x);
    const float qy = cross1(tvz, a.w, tvx, b.y);
    const float qz = cross1(tvx, b.x, tvy, a.w);
    const float v = __fmul_rn(dot3(r.dx, r.dy, r.dz, qx, qy, qz), inv);
    if (!(v >= 0.0f) || !(__fadd_rn(u, v) <= 1.0f)) return;
    const float t = __fmul_rn(dot3(b.z, b.w, c.x, qx, qy, qz), inv);
    if (!(t >= 0.0f) || !(t <= kTMax)) return;
    if (t < bt || (t == bt && c.y < bi)) {
      bt = t;
      bi = c.y;
    }
  }
}

// a barrier of one lane group (LANES threads, barrier id g + 1; id 0 is
// __syncthreads')
template <int LANES>
__device__ __forceinline__ void group_sync(int g) {
  if constexpr (LANES == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(LANES) : "memory");
  }
}

// SPB slices per block, a group of LANES threads each
template <int LANES, int SPB, bool DEFER, bool STAGE>
__global__ void __launch_bounds__(LANES * SPB)
mt_kernel(const float* __restrict__ pos, const float* __restrict__ dirs,
          const int* __restrict__ ray_ids, const int* __restrict__ ray_off,
          const int* __restrict__ ray_cnt, const int* __restrict__ cand_off,
          const int* __restrict__ cand_cnt, const float4* __restrict__ rows,
          float* __restrict__ t_out, int* __restrict__ i_out, int slices) {
  __shared__ __align__(16) float4 cand[STAGE ? SPB * kChunk * kRow4 : 1];
  const int g = threadIdx.x / LANES;
  const int l = threadIdx.x - g * LANES;
  const int s = blockIdx.x * SPB + g;
  if (s >= slices) return;  // the whole group: no barrier waits for it
  const bool live = l < ray_cnt[s];
  const int cnt = cand_cnt[s];
  const float4* src = rows + static_cast<size_t>(cand_off[s]) * kRow4;
  float4* mine = cand + g * kChunk * kRow4;
  // STAGE: copy the rows [c0, c0 + kChunk) of the slice into the group's
  // shared memory by cp.async (no registers, the warp does not wait)
  auto stage = [&](int c0) {
    const int m = min(kChunk, cnt - c0);
    const float4* chunk = src + static_cast<size_t>(c0) * kRow4;
    for (int i = l; i < m * kRow4; i += LANES)
      __pipeline_memcpy_async(mine + i, chunk + i, sizeof(float4));
    __pipeline_commit();
  };
  if constexpr (STAGE) {
    if (cnt > 0) stage(0);  // in flight while the ray loads
  }
  int ray = 0;
  Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    ray = ray_ids[ray_off[s] + l];
    const float* o = pos + static_cast<size_t>(ray) * 3;
    const float* d = dirs + static_cast<size_t>(ray) * 3;
    r = Ray{o[0], o[1], o[2], d[0], d[1], d[2]};
  }
  float bt = INFINITY;
  float bi = kBigId;

  if constexpr (STAGE) {
    for (int c0 = 0; c0 < cnt; c0 += kChunk) {
      const int m = min(kChunk, cnt - c0);
      __pipeline_wait_prior(0);
      group_sync<LANES>(g);
      if (live) {
        for (int k = 0; k < m; ++k)
          mt_pair<DEFER>(r, mine[k * kRow4], mine[k * kRow4 + 1],
                         mine[k * kRow4 + 2], bt, bi);
      }
      group_sync<LANES>(g);  // the next round overwrites the staged rows
      if (c0 + kChunk < cnt) stage(c0 + kChunk);
    }
  } else if (live) {
    for (int k = 0; k < cnt; ++k) {
      const float4* q = src + static_cast<size_t>(k) * kRow4;
      mt_pair<DEFER>(r, __ldg(q), __ldg(q + 1), __ldg(q + 2), bt, bi);
    }
  }
  if (live) {
    t_out[ray] = bt;
    i_out[ray] = static_cast<int>(bi);
  }
}

struct Args {
  const float *pos, *dirs;
  const int *ray_ids, *ray_off, *ray_cnt, *cand_off, *cand_cnt;
  const float4* rows;
  float* t_out;
  int* i_out;
  int slices;
};

template <int LANES, int THREADS, bool DEFER, bool STAGE>
void launch(const Args& a, cudaStream_t stream) {
  constexpr int kSpb = THREADS / LANES;
  const int blocks = (a.slices + kSpb - 1) / kSpb;
  mt_kernel<LANES, kSpb, DEFER, STAGE><<<blocks, THREADS, 0, stream>>>(
      a.pos, a.dirs, a.ray_ids, a.ray_off, a.ray_cnt, a.cand_off, a.cand_cnt,
      a.rows, a.t_out, a.i_out, a.slices);
}

int run(const Args& a, int lanes, int threads, bool defer, bool stage,
        cudaStream_t s) {
  if (a.slices < 0 || (reinterpret_cast<uintptr_t>(a.rows) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.slices == 0) return static_cast<int>(cudaGetLastError());
#define DXV_MT_CASE(L, T, D, S)                             \
  if (lanes == L && threads == T && defer == D && stage == S) { \
    launch<L, T, D, S>(a, s);                               \
    return static_cast<int>(cudaGetLastError());           \
  }
#define DXV_MT_LANES(L)          \
  DXV_MT_CASE(L, 128, true, false) \
  DXV_MT_CASE(L, 128, true, true)  \
  DXV_MT_CASE(L, 128, false, false) \
  DXV_MT_CASE(L, 128, false, true) \
  DXV_MT_CASE(L, 256, true, false) \
  DXV_MT_CASE(L, 256, true, true)  \
  DXV_MT_CASE(L, 256, false, false) \
  DXV_MT_CASE(L, 256, false, true)
  DXV_MT_LANES(32)
  DXV_MT_LANES(64)
  DXV_MT_LANES(128)
#undef DXV_MT_LANES
#undef DXV_MT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// pos, dirs [V, 3] f32; ray_ids [R] int32; ray_off, ray_cnt,
// cand_off, cand_cnt [slices] int32; rows [P, 12] f32, 16-byte aligned;
// t_out [V] f32; i_out [V] int32; lanes: the most rays a slice holds (32,
// 64 or 128).
extern "C" int dxv_raystab_mt(const float* pos, const float* dirs,
                              const int* ray_ids, const int* ray_off,
                              const int* ray_cnt, const int* cand_off,
                              const int* cand_cnt, const float* rows,
                              float* t_out, int* i_out, int slices, int lanes,
                              void* stream) {
  const Args a = {pos, dirs, ray_ids, ray_off, ray_cnt, cand_off, cand_cnt,
                  reinterpret_cast<const float4*>(rows), t_out, i_out, slices};
  return run(a, lanes, kMainThreads, true, kMainStage,
             static_cast<cudaStream_t>(stream));
}

// The same with threads per block (128, 256), the deferred division (0, 1)
// and row staging (0: read from device memory; 1: through shared memory)
// chosen by the caller: the timing sweep.
extern "C" int dxv_raystab_mt_variant(const float* pos, const float* dirs,
                                      const int* ray_ids, const int* ray_off,
                                      const int* ray_cnt, const int* cand_off,
                                      const int* cand_cnt, const float* rows,
                                      float* t_out, int* i_out, int slices,
                                      int lanes, int threads, int defer,
                                      int stage, void* stream) {
  const Args a = {pos, dirs, ray_ids, ray_off, ray_cnt, cand_off, cand_cnt,
                  reinterpret_cast<const float4*>(rows), t_out, i_out, slices};
  return run(a, lanes, threads, defer != 0, stage != 0,
             static_cast<cudaStream_t>(stream));
}
