// Ray-stab closest hit over strips of 128 radial rays, with the winner's
// normal extracted and finished (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/raystab_pallas.py::_fold_extract_kernel6
// (launched by stab_fold_extract3) and ::_fold_extract_kernel2 (launched by
// stab_fold_extract2) -- one computation on the TPU's two table layouts --
// and, as the fold-only instance (kExtract = false), ::_stab_kernel2
// (launched by stab_closest_hit2). Same computation: strip s holds 128 ray
// lanes (dx dy dz s0; an all-zero lane is padding) and candidate rows
// rows[cand_off[s] .. cand_off[s] + cand_cnt[s]), each 24 floats
// g0 g1 g2 c id pad | n0 n1 n2 pad(3). Per lane and candidate the radial
// test (ops/intersect.py radial_hit); the lexicographic (t, lowest id)
// minimum; the winner's 9 coefficient and 9 normal floats; then the finalize:
// the interpolated, normalized normal and inside = hit & n.d > threshold
// (rule "backface") or inside = hit (rule "hit"), written as (nx, ny, nz, a).
// Candidates come in chunks of 256; bounds[s, j] is a strict lower bound on t
// of any hit in chunk j, so a chunk that no lane's best t reaches is skipped.
//
// What bounds it on the card: FP32 arithmetic per (ray, candidate) pair --
// three 3-term dot products, two adds, a division and a subtraction (19
// operations) plus the compares and the fold's selects. Candidate rows (96
// bytes) are read from device memory once per strip and broadcast from
// shared memory to the strip's 128 lanes, so bytes are ~0.75 per pair.
//
// Design: one block per strip, one thread per ray lane; the strip's
// candidates are staged through shared memory 256 rows at a time (24 KiB);
// each thread keeps its running (t, id) and, after each chunk, copies the
// 18 floats of the chunk's winner row (if the winner changed in it) into
// registers -- the TPU kernel's one-hot matmul at Precision.HIGHEST is such a
// copy, and here it is a plain select with no MMA; the finalize runs in the
// thread. The chunk skip is block-wide: __syncthreads_or(best_t >= bound),
// the TPU's `bound <= max over lanes of best t`. Padding lanes start at
// t = -inf so they never hold a strip back from skipping; miss lanes keep id
// 2^30; a hit is isfinite(t) & id < t_count. Every chain uses
// __fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn in the JAX order, so nothing
// contracts into an FMA and results are bit-identical to the plain version and
// the radial oracle. The (t, lowest id) order is total on real candidates, so
// the in-thread sequential fold picks the TPU's tree fold's winner. One
// launch covers every capacity class of the accel (per-strip offset and
// count); blocks run in reverse strip order, so the widest classes (built
// last) start first. The near-origin stream is a second launch of the same
// instance with every strip's offset 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 256;
constexpr int kRow = 24;
constexpr int kCCol = 9, kIdCol = 10, kNCol = 12;
constexpr float kBigId = 1073741824.0f;  // 2^30
constexpr float kEpsDet = 1e-10f;
constexpr float kTMax = 1e4f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// intersect.radial_hit: t on a hit, +inf on a miss
__device__ __forceinline__ float radial_hit(float dx, float dy, float dz,
                                            float s0, const float* q) {
  const float w0 = dot3(dx, dy, dz, q[0], q[1], q[2]);
  const float w1 = dot3(dx, dy, dz, q[3], q[4], q[5]);
  const float w2 = dot3(dx, dy, dz, q[6], q[7], q[8]);
  const float den = __fadd_rn(__fadd_rn(w0, w1), w2);
  const float wmin = fminf(w0, fminf(w1, w2));
  const float wmax = fmaxf(w0, fmaxf(w1, w2));
  const float t = __fsub_rn(__fdiv_rn(q[kCCol], den), s0);
  const bool hit = fabsf(den) > kEpsDet && (wmin >= 0.0f || wmax <= 0.0f) &&
                   t >= 0.0f && t <= kTMax;
  return hit ? t : INFINITY;
}

template <bool kExtract>
__global__ void __launch_bounds__(kLanes)
stab_kernel(const float* __restrict__ rays, const int* __restrict__ cand_off,
            const int* __restrict__ cand_cnt, const float* __restrict__ rows,
            const float* __restrict__ bounds, int n_bounds,
            float* __restrict__ t_out, int* __restrict__ i_out,
            float4* __restrict__ ns_out, int strips, int t_count,
            float threshold, int rule_hit) {
  __shared__ float cand[kChunk * kRow];
  const int s = strips - 1 - static_cast<int>(blockIdx.x);
  const int l = threadIdx.x;
  const float* r = rays + static_cast<size_t>(s) * 4 * kLanes;
  const float dx = r[l], dy = r[kLanes + l], dz = r[2 * kLanes + l];
  const float s0 = r[3 * kLanes + l];
  const bool pad = dx == 0.0f && dy == 0.0f && dz == 0.0f;
  float bt = pad ? -INFINITY : INFINITY;
  float bi = kBigId;
  float win[18];
#pragma unroll
  for (int c = 0; c < 18; ++c) win[c] = 0.0f;

  const int cnt = cand_cnt[s];
  const float* src = rows + static_cast<size_t>(cand_off[s]) * kRow;
  for (int c0 = 0, j = 0; c0 < cnt; c0 += kChunk, ++j) {
    const float bound = (bounds != nullptr && j < n_bounds)
                            ? bounds[static_cast<size_t>(s) * n_bounds + j]
                            : -INFINITY;
    if (!__syncthreads_or(bt >= bound)) continue;  // every lane beats it
    const int m = min(kChunk, cnt - c0);
    const float* chunk = src + static_cast<size_t>(c0) * kRow;
    for (int i = l; i < m * kRow; i += kLanes) cand[i] = chunk[i];
    __syncthreads();
    int wk = -1;  // where this chunk's winner row sits, if it won here
    for (int k = 0; k < m; ++k) {
      const float* q = cand + k * kRow;
      const float tt = radial_hit(dx, dy, dz, s0, q);
      const float ii = tt != INFINITY ? q[kIdCol] : kBigId;
      if (tt < bt || (tt == bt && ii < bi)) {
        bt = tt;
        bi = ii;
        wk = k;
      }
    }
    if (kExtract && wk >= 0) {
      const float* q = cand + wk * kRow;
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        win[c] = q[c];
        win[9 + c] = q[kNCol + c];
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

  const size_t slot = static_cast<size_t>(s) * kLanes + l;
  t_out[slot] = bt;
  i_out[slot] = static_cast<int>(bi);
  if (!kExtract) return;
  // finalize (raystab_pallas.py:705-731 chains, radial oracle's convention)
  const float w0 = dot3(dx, dy, dz, win[0], win[1], win[2]);
  const float w1 = dot3(dx, dy, dz, win[3], win[4], win[5]);
  const float w2 = dot3(dx, dy, dz, win[6], win[7], win[8]);
  const float den = __fadd_rn(__fadd_rn(w0, w1), w2);
  const float nsx = dot3(w0, w1, w2, win[9], win[12], win[15]);
  const float nsy = dot3(w0, w1, w2, win[10], win[13], win[16]);
  const float nsz = dot3(w0, w1, w2, win[11], win[14], win[17]);
  const float dn = den == 0.0f ? 1.0f : den;
  float nx = __fdiv_rn(nsx, dn), ny = __fdiv_rn(nsy, dn), nz = __fdiv_rn(nsz, dn);
  const float ss = dot3(nx, ny, nz, nx, ny, nz);
  float ln = __fsqrt_rn(ss);
  ln = isnan(ln) ? ln : fmaxf(ln, 1e-20f);  // jnp.maximum keeps a NaN
  nx = __fdiv_rn(nx, ln);
  ny = __fdiv_rn(ny, ln);
  nz = __fdiv_rn(nz, ln);
  const bool hit = isfinite(bt) && bi < static_cast<float>(t_count);
  const bool inside =
      hit && (rule_hit != 0 || dot3(nx, ny, nz, dx, dy, dz) > threshold);
  ns_out[slot] = inside ? make_float4(nx, ny, nz, 1.0f)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <bool kExtract>
int launch(const float* rays, const int* cand_off, const int* cand_cnt,
           const float* rows, const float* bounds, int n_bounds, float* t_out,
           int* i_out, float* ns_out, int strips, int t_count, float threshold,
           int rule_hit, void* stream) {
  if (strips < 0 || n_bounds < 0 || t_count < 0 || t_count >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  if (strips > 0) {
    stab_kernel<kExtract><<<strips, kLanes, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rays, cand_off, cand_cnt, rows, bounds, n_bounds, t_out, i_out,
        reinterpret_cast<float4*>(ns_out), strips, t_count, threshold,
        rule_hit);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rays [strips, 4, 128] f32; cand_off, cand_cnt [strips] int32; rows [P, 24]
// f32; bounds [strips, n_bounds] f32 or null; t_out [strips, 128] f32;
// i_out [strips, 128] int32; ns_out [strips, 128, 4] f32.
extern "C" int dxv_raystab_fold_extract(
    const float* rays, const int* cand_off, const int* cand_cnt,
    const float* rows, const float* bounds, int n_bounds, float* t_out,
    int* i_out, float* ns_out, int strips, int t_count, float threshold,
    int rule_hit, void* stream) {
  return launch<true>(rays, cand_off, cand_cnt, rows, bounds, n_bounds, t_out,
                      i_out, ns_out, strips, t_count, threshold, rule_hit,
                      stream);
}

// The fold alone: t_out, i_out as above.
extern "C" int dxv_raystab_fold(const float* rays, const int* cand_off,
                                const int* cand_cnt, const float* rows,
                                const float* bounds, int n_bounds,
                                float* t_out, int* i_out, int strips,
                                void* stream) {
  return launch<false>(rays, cand_off, cand_cnt, rows, bounds, n_bounds,
                       t_out, i_out, nullptr, strips, 0, 0.0f, 0, stream);
}
