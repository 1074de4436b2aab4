// The ray-stab accel's per-triangle rows (Hopper): the [T+1, 24] matrix
// that the fold + extraction kernel (raystab_fold.cu) reads each candidate
// row of, computed anew every deforming frame by the refit (X.9).
//
// Replaces XLA code, not a Pallas kernel: dxrvoxelizer_tpu/ops/
// raystab_fast.py::_fused_coef_matrix (with ::_radial_coef_matrix and
// ::_normal_rows_matrix), which the JAX package runs as one jitted function
// and the port ran as an eager chain of about 50 torch ops (6 index
// gathers, 3 cross products as stacks, the elementwise products and sums,
// 5 concatenations, the id and padding fills).
//
// Row t < T (triangle t = (a, b, c), v0 = verts[a], v1 = verts[b],
// v2 = verts[c]):
//   columns  0- 8  g0 = v1 x v2, g1 = v2 x v0, g2 = v0 x v1
//   column   9     c = (g0x v0x + g0y v0y) + g0z v0z
//   column  10     the id t as a float (exact: T < 2^24)
//   column  11     0
//   columns 12-20  normals[a], normals[b], normals[c]
//   columns 21-23  0
// Row T (the padding row): all zero but column 10 = 2^30 (a miss that
// loses every tie).
//
// Arithmetic: each product, difference and sum is its own explicitly
// rounded intrinsic (__fmul_rn, __fsub_rn, __fadd_rn), in the plain chain's
// order (a cross component is ay * bz - az * by), so nvcc cannot contract a
// multiply and an add into an FMA: the rows equal the plain chain's bit for
// bit (intersect.radial_setup, one op at a time), and so do the hit tests
// that read them.
//
// What bounds it on the card: bytes. Each row writes 96 bytes and reads its
// 3 indices (24 bytes as int64, 12 as int32); the vertices and normals are
// gathered (each read once at best, 12 bytes a vertex each). The cells'
// 100,000-triangle torus (50,000 vertices): 9.6 MB written, 2.4 MB of
// indices (1.2 MB as int32), 1.2 MB of vertices and normals, 3.94 us at
// 3.35 TB/s (3.58 us with int32 indices).
//
// Design: for latency and store shape. At the cells' sizes a
// launch is one wave, so its time is the chain of round trips a thread
// waits on and the shape of its stores, not the bytes. A block of 128 rows:
// 1. loads its rows' index triplets, one contiguous run, as 16-byte loads
//    across the block (a 4-byte tail) into shared memory, then a barrier
//    (`tris` must start 16-byte aligned, so every block's run does: 128
//    triplets are 1.5 or 3 KB; staging 4-byte words throughout measured
//    1.5-7.5 % slower on the H100, scripts/glue_turns.py);
// 2. each thread checks its three indices (an index outside [0, V) traps,
//    a CUDA error, as a torch gather out of range gives, before anything
//    is read through it), then issues all 18 gathers of its vertices and
//    normals before the first arithmetic: one round trip;
// 3. writes its row (six float4s) into the block's 12 KB of rows in shared
//    memory, then a barrier;
// 4. the block writes its rows out as one contiguous run, consecutive lanes
//    on consecutive 16 bytes: every warp store fills four 128-byte lines
//    (a thread's own six stores at a 96-byte stride would leave each warp
//    instruction 32 half-filled sectors over 3 KB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rows a block
constexpr int kRow4 = 6;       // float4s a row (24 floats)
constexpr float kBigId = 1073741824.0f;  // 2^30, intersect.BIG_ID

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, long long i) {
  const float* q = p + 3 * i;
  return {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
}

// a x b, each component ay * bz - az * by with its two products rounded
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
refit_rows_kernel(const float* __restrict__ verts,
                  const Index* __restrict__ tris,
                  const float* __restrict__ normals,
                  float4* __restrict__ out, int t_count, long long n_verts,
                  long long n_normals) {
  __shared__ __align__(16) Index idx[kThreads * 3];
  __shared__ float4 rows[kThreads * kRow4];
  const int t0 = blockIdx.x * kThreads;
  const int real = min(kThreads, t_count - t0);  // triangles of the block
  // 1. the index triplets of the block's triangles, one contiguous run
  if (real > 0) {
    const int words = real * 3 * static_cast<int>(sizeof(Index)) / 4;
    const unsigned* src = reinterpret_cast<const unsigned*>(tris + 3LL * t0);
    unsigned* dst = reinterpret_cast<unsigned*>(idx);
    const int units = words / 4;
    for (int u = threadIdx.x; u < units; u += kThreads) {
      reinterpret_cast<uint4*>(dst)[u] =
          __ldg(reinterpret_cast<const uint4*>(src) + u);
    }
    for (int w = units * 4 + threadIdx.x; w < words; w += kThreads) {
      dst[w] = __ldg(src + w);
    }
  }
  __syncthreads();
  // 2.-3. each thread's row into shared memory
  const int r = threadIdx.x;
  const int t = t0 + r;
  float4* row = rows + r * kRow4;
  if (r < real) {
    const long long a = static_cast<long long>(idx[3 * r]);
    const long long b = static_cast<long long>(idx[3 * r + 1]);
    const long long c = static_cast<long long>(idx[3 * r + 2]);
    const long long lo = min(a, min(b, c)), hi = max(a, max(b, c));
    if (lo < 0 || hi >= n_verts || hi >= n_normals) __trap();
    const V3 v0 = load3(verts, a), v1 = load3(verts, b), v2 = load3(verts, c);
    const V3 n0 = load3(normals, a), n1 = load3(normals, b),
             n2 = load3(normals, c);
    const V3 g0 = cross(v1, v2);
    const V3 g1 = cross(v2, v0);
    const V3 g2 = cross(v0, v1);
    const float cc = __fadd_rn(
        __fadd_rn(__fmul_rn(g0.x, v0.x), __fmul_rn(g0.y, v0.y)),
        __fmul_rn(g0.z, v0.z));
    row[0] = make_float4(g0.x, g0.y, g0.z, g1.x);
    row[1] = make_float4(g1.y, g1.z, g2.x, g2.y);
    row[2] = make_float4(g2.z, cc, static_cast<float>(t), 0.0f);
    row[3] = make_float4(n0.x, n0.y, n0.z, n1.x);
    row[4] = make_float4(n1.y, n1.z, n2.x, n2.y);
    row[5] = make_float4(n2.z, 0.0f, 0.0f, 0.0f);
  } else if (t == t_count) {  // the padding row
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    row[0] = z;
    row[1] = z;
    row[2] = make_float4(0.0f, 0.0f, kBigId, 0.0f);
    row[3] = z;
    row[4] = z;
    row[5] = z;
  }
  __syncthreads();
  // 4. the block's rows out, one contiguous run in 16-byte units
  const int units = min(kThreads, t_count + 1 - t0) * kRow4;
  float4* dst = out + static_cast<long long>(t0) * kRow4;
  for (int u = threadIdx.x; u < units; u += kThreads) dst[u] = rows[u];
}

}  // namespace

// verts [n_verts, 3] f32, tris [t_count, 3] (int64 when tris64, else
// int32; 16-byte aligned), normals [n_normals, 3] f32 -> out [t_count + 1,
// 24] f32.
extern "C" int dxv_refit_rows(const void* verts, const void* tris,
                              const void* normals, void* out, int t_count,
                              long long n_verts, long long n_normals,
                              int tris64, void* stream) {
  if (t_count < 0 || t_count >= (1 << 24) ||
      reinterpret_cast<uintptr_t>(tris) % sizeof(uint4) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks =
      static_cast<unsigned>((t_count + 1 + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const float*>(verts);
  auto* nr = static_cast<const float*>(normals);
  auto* o = static_cast<float4*>(out);
  if (tris64) {
    refit_rows_kernel<<<blocks, kThreads, 0, st>>>(
        v, static_cast<const long long*>(tris), nr, o, t_count, n_verts,
        n_normals);
  } else {
    refit_rows_kernel<<<blocks, kThreads, 0, st>>>(
        v, static_cast<const int*>(tris), nr, o, t_count, n_verts, n_normals);
  }
  return static_cast<int>(cudaGetLastError());
}
