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
// indices, 1.2 MB of vertices and normals, 3.9 us at 3.35 TB/s.
//
// Design: a thread a row, 256 a block. A row is 96 bytes, six 16-byte
// stores (rows start 16-byte aligned); a warp's 32 rows are 3 KB of
// contiguous output, whose sectors the L2 merges before they go to device
// memory. The gathers hit the L2 (the torus' vertices and normals are 1.2
// MB). An index outside [0, V) traps (a CUDA error, as a torch gather out
// of range gives) before it is read through.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBigId = 1073741824.0f;  // 2^30, intersect.BIG_ID

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, long long i,
                                    long long count) {
  if (i < 0 || i >= count) __trap();
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
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t > t_count) return;
  float4* row = out + static_cast<long long>(t) * 6;
  if (t == t_count) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    row[0] = z;
    row[1] = z;
    row[2] = make_float4(0.0f, 0.0f, kBigId, 0.0f);
    row[3] = z;
    row[4] = z;
    row[5] = z;
    return;
  }
  const Index* tri = tris + 3 * static_cast<long long>(t);
  const long long a = static_cast<long long>(__ldg(tri));
  const long long b = static_cast<long long>(__ldg(tri + 1));
  const long long c = static_cast<long long>(__ldg(tri + 2));
  const V3 v0 = load3(verts, a, n_verts);
  const V3 v1 = load3(verts, b, n_verts);
  const V3 v2 = load3(verts, c, n_verts);
  const V3 g0 = cross(v1, v2);
  const V3 g1 = cross(v2, v0);
  const V3 g2 = cross(v0, v1);
  const float cc = __fadd_rn(
      __fadd_rn(__fmul_rn(g0.x, v0.x), __fmul_rn(g0.y, v0.y)),
      __fmul_rn(g0.z, v0.z));
  const V3 n0 = load3(normals, a, n_normals);
  const V3 n1 = load3(normals, b, n_normals);
  const V3 n2 = load3(normals, c, n_normals);
  row[0] = make_float4(g0.x, g0.y, g0.z, g1.x);
  row[1] = make_float4(g1.y, g1.z, g2.x, g2.y);
  row[2] = make_float4(g2.z, cc, static_cast<float>(t), 0.0f);
  row[3] = make_float4(n0.x, n0.y, n0.z, n1.x);
  row[4] = make_float4(n1.y, n1.z, n2.x, n2.y);
  row[5] = make_float4(n2.z, 0.0f, 0.0f, 0.0f);
}

}  // namespace

// verts [n_verts, 3] f32, tris [t_count, 3] (int64 when tris64, else
// int32), normals [n_normals, 3] f32 -> out [t_count + 1, 24] f32.
extern "C" int dxv_refit_rows(const void* verts, const void* tris,
                              const void* normals, void* out, int t_count,
                              long long n_verts, long long n_normals,
                              int tris64, void* stream) {
  if (t_count < 0 || t_count >= (1 << 24)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks =
      static_cast<unsigned>((t_count + 1 + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const float*>(verts);
  auto* nr = static_cast<const float*>(normals);
  auto* o = static_cast<float4*>(out);
  if (tris64) {
    refit_rows_kernel<long long><<<blocks, kThreads, 0, st>>>(
        v, static_cast<const long long*>(tris), nr, o, t_count, n_verts,
        n_normals);
  } else {
    refit_rows_kernel<int><<<blocks, kThreads, 0, st>>>(
        v, static_cast<const int*>(tris), nr, o, t_count, n_verts, n_normals);
  }
  return static_cast<int>(cudaGetLastError());
}
