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
// What bounds it on the card: issued instructions per (ray, candidate) pair.
// The function's floor is 19 FP32 operations per pair (three 3-term dot
// products, two adds, a division and a subtraction); candidate rows are read
// once per strip and broadcast from shared memory to its 128 lanes, so bytes
// are under one per pair. On the main path's tables (64^3) only about 1.3 %
// of the pairs pass the sign test of the three dot products, and about a fifth
// of the (warp, candidate) steps hold one such pair.
//
// Design: one block per strip, of G groups of 128 threads (one thread per ray
// lane in each group). The strip's candidates are cut into sub-chunks of 64
// rows; in round r, group g folds sub-chunk r * G + g, so a round of G = 4
// covers one 256-row chunk. Only the first 12 floats of each row (g0..g8, c,
// id) are staged, by 16-byte cp.async copies, into an NST-stage ring of
// shared memory, issued NST - 1 rounds ahead of their use. Per pair the three
// dot products and the sign test run first; den, |den| > eps and the
// correctly rounded division run only for the pairs that pass (kDefer), with
// the same __f*_rn chains, so t is bit for bit the one the undeferred chain
// gives. Each thread keeps (t, id) and the winning row's index, not its
// floats. At a chunk start the block takes every lane's best t over all groups
// (a shared-memory minimum) and skips the chunk unless some lane reaches its
// bound -- the plain version's decision exactly. After the last round the
// groups' winners merge by (t, id, row), a total order, so the order of the
// merge does not matter; the first group reads each lane's winning row once
// from device memory and finishes it. Padding lanes start at t = -inf so they
// never hold a strip back from skipping; miss lanes keep id 2^30; a hit is
// isfinite(t) & id < t_count. Every chain uses __fmul_rn/__fadd_rn/
// __fdiv_rn/__fsqrt_rn in the JAX order, so nothing contracts into an FMA and
// results are bit-identical to the plain version and the radial oracle. One
// launch covers every capacity class of the accel (per-strip offset and
// count); blocks run in reverse strip order, so the widest classes (built
// last) start first. The near-origin stream is a second launch with every
// strip's offset 0. dxv_raystab_fold_extract_variant runs the other G, NST
// and kDefer settings (the timing sweep of chip_smoke.py).
//
// Row ids (kIds): a refitted stream holds no rows of its own. rows is then
// the per-triangle table [n_rows = T+1, 24] (9.6 MB at 100,000 triangles, so
// it stays in the 50 MB L2) and candidate p of the stream is the table's row
// row_ids[p]: the staging copies each row from the table through its id, and
// the winner's read goes through its id too. A round's ids are consecutive, so
// their loads coalesce; they are loaded one round ahead into registers (the
// faster of that and loading them as the round is issued on the cells' torus
// and at 64^3, PERF.md). An id outside [0, n_rows) traps the kernel before any
// read through it, as torch's own gathers do; the check sits where the id is
// used, a round after its load (at the load it waits on it: +6 %, PERF.md). Same rows in the same order: the
// results are those of the materialised stream, bit for bit. Without ids the
// staging is the direct instance's strided loop, unchanged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunk = 256;  // rows per chunk-skip bound
constexpr int kSub = 64;     // rows per staged sub-chunk
constexpr int kSubPerChunk = kChunk / kSub;
constexpr int kRow = 24;     // floats per candidate row
constexpr int kStaged = 3;   // float4s staged per row: g0..g8 c id pad
constexpr float kBigId = 1073741824.0f;  // 2^30
constexpr float kEpsDet = 1e-10f;
constexpr float kTMax = 1e4f;
// the main path's settings (chip_smoke.py phase 15b sweeps the others)
constexpr int kGroups = 1;
constexpr int kStages = 3;
// 16-byte pieces a thread copies per round with row ids: G * kSub * kStaged
// = 1.5 threads
constexpr int kPer = 2;
static_assert(kSub * kStaged <= kPer * kLanes, "a round's pieces per thread");

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (t, id, row) lexicographic: is (t2, i2, k2) before (t, i, k)?
__device__ __forceinline__ bool before(float t2, float i2, int k2, float t,
                                       float i, int k) {
  return t2 < t || (t2 == t && (i2 < i || (i2 == i && k2 < k)));
}

template <bool kExtract, int G, int NST, bool kDefer, bool kIds>
__global__ void __launch_bounds__(G * kLanes)
stab_kernel(const float* __restrict__ rays, const int* __restrict__ cand_off,
            const int* __restrict__ cand_cnt, const float* __restrict__ rows,
            const int* __restrict__ row_ids, int n_rows,
            const float* __restrict__ bounds, int n_bounds,
            float* __restrict__ t_out, int* __restrict__ i_out,
            float4* __restrict__ ns_out, int strips, int t_count,
            float threshold, int rule_hit) {
  constexpr int kThreads = G * kLanes;
  constexpr int kStageF4 = G * kSub * kStaged;  // float4s per ring stage
  extern __shared__ float4 smem[];
  float4* ring = smem;  // [NST][G * kSub][kStaged]
  float* sbt = reinterpret_cast<float*>(ring + NST * kStageF4);  // [G][128]
  float* sbi = sbt + kThreads;
  int* sbk = reinterpret_cast<int*>(sbi + kThreads);

  const int s = strips - 1 - static_cast<int>(blockIdx.x);
  const int tid = threadIdx.x;
  const int g = tid / kLanes;
  const int l = tid - g * kLanes;
  const float* r = rays + static_cast<size_t>(s) * 4 * kLanes;
  const float dx = r[l], dy = r[kLanes + l], dz = r[2 * kLanes + l];
  const float s0 = r[3 * kLanes + l];
  const bool pad = dx == 0.0f && dy == 0.0f && dz == 0.0f;
  float bt = pad ? -INFINITY : INFINITY;
  float bi = kBigId;
  int bk = -1;  // the winner's row in the strip

  const int cnt = cand_cnt[s];
  const int off = cand_off[s];
  // candidate k's row: src + k * kRow, or (kIds) the table's row ids[k]
  const float* src = rows + (kIds ? 0 : static_cast<size_t>(off) * kRow);
  const int* ids = kIds ? row_ids + off : nullptr;
  const int rounds = (cnt + G * kSub - 1) / (G * kSub);

  // kIds: the table row of each piece of the next round issue() takes
  int nid[kPer] = {};
  auto load_ids = [&](int q) {
    const int row0 = q * G * kSub;
    const int n4 = q < rounds ? min(G * kSub, cnt - row0) * kStaged : 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < n4) nid[j] = __ldg(ids + row0 + i / kStaged);
    }
  };
  // round q's rows -> ring stage q % NST (an empty commit group past the end
  // keeps the wait counts uniform)
  auto issue = [&](int q) {
    if (q < rounds) {
      const int row0 = q * G * kSub;
      const int n4 = min(G * kSub, cnt - row0) * kStaged;
      float4* dst = ring + (q % NST) * kStageF4;
      if constexpr (kIds) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = tid + j * kThreads;
          if (i < n4) {
            // checked here, a round after its load, so the check does not
            // wait on it
            if (static_cast<unsigned>(nid[j]) >= static_cast<unsigned>(n_rows))
              __trap();  // an id outside the table
            const int row = i / kStaged;
            cp_async16(dst + i, rows + static_cast<size_t>(nid[j]) * kRow +
                                    (i - row * kStaged) * 4);
          }
        }
      } else {
        const float* base = src + static_cast<size_t>(row0) * kRow;
        for (int i = tid; i < n4; i += kThreads) {
          const int row = i / kStaged;
          cp_async16(dst + i, base + row * kRow + (i - row * kStaged) * 4);
        }
      }
    }
    cp_async_commit();
    if constexpr (kIds) load_ids(q + 1);
  };
  if constexpr (kIds) load_ids(0);
#pragma unroll
  for (int q = 0; q < NST - 1; ++q) issue(q);

  bool run = true;
  for (int q = 0; q < rounds; ++q) {
    issue(q + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();  // round q's rows have landed for every thread
    if ((q * G) % kSubPerChunk == 0) {  // a chunk starts: skip it?
      const int j = q * G / kSubPerChunk;
      const float bound = (bounds != nullptr && j < n_bounds)
                              ? bounds[static_cast<size_t>(s) * n_bounds + j]
                              : -INFINITY;
      if (bound == -INFINITY) {  // no bound (best t is never NaN)
        run = true;
      } else {
        float m = bt;  // this lane's best t over every group
        if (G > 1) {
          sbt[tid] = bt;
          __syncthreads();
#pragma unroll
          for (int h = 0; h < G; ++h) m = fminf(m, sbt[h * kLanes + l]);
        }
        run = __syncthreads_or(m >= bound);
      }
    }
    const int k0 = (q * G + g) * kSub;
    const int m = run ? min(kSub, cnt - k0) : 0;
    const float4* qr = ring + (q % NST) * kStageF4 + g * kSub * kStaged;
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const float4 a = qr[k * kStaged];
      const float4 b = qr[k * kStaged + 1];
      const float4 c = qr[k * kStaged + 2];  // g8 c id pad
      const float w0 = dot3(dx, dy, dz, a.x, a.y, a.z);
      const float w1 = dot3(dx, dy, dz, a.w, b.x, b.y);
      const float w2 = dot3(dx, dy, dz, b.z, b.w, c.x);
      const float wmin = fminf(w0, fminf(w1, w2));
      const float wmax = fmaxf(w0, fmaxf(w1, w2));
      if (kDefer) {
        if (wmin >= 0.0f || wmax <= 0.0f) {
          const float den = __fadd_rn(__fadd_rn(w0, w1), w2);
          if (fabsf(den) > kEpsDet) {
            const float t = __fsub_rn(__fdiv_rn(c.y, den), s0);
            if (t >= 0.0f && t <= kTMax &&
                (t < bt || (t == bt && c.z < bi))) {
              bt = t;
              bi = c.z;
              bk = k0 + k;
            }
          }
        }
      } else {
        const float den = __fadd_rn(__fadd_rn(w0, w1), w2);
        const float tt = __fsub_rn(__fdiv_rn(c.y, den), s0);
        const bool hit = fabsf(den) > kEpsDet &&
                         (wmin >= 0.0f || wmax <= 0.0f) && tt >= 0.0f &&
                         tt <= kTMax;
        const float t = hit ? tt : INFINITY;
        const float ii = hit ? c.z : kBigId;
        if (t < bt || (t == bt && ii < bi)) {
          bt = t;
          bi = ii;
          bk = k0 + k;
        }
      }
    }
    __syncthreads();  // round q + NST - 1 overwrites this stage
  }
  cp_async_wait<0>();

  if (G > 1) {  // merge the groups' winners in the first group
    sbt[tid] = bt;
    sbi[tid] = bi;
    sbk[tid] = bk;
    __syncthreads();
    if (g != 0) return;
#pragma unroll
    for (int h = 1; h < G; ++h) {
      const float t2 = sbt[h * kLanes + l], i2 = sbi[h * kLanes + l];
      const int k2 = sbk[h * kLanes + l];
      if (before(t2, i2, k2, bt, bi, bk)) {
        bt = t2;
        bi = i2;
        bk = k2;
      }
    }
  }

  const size_t slot = static_cast<size_t>(s) * kLanes + l;
  t_out[slot] = bt;
  i_out[slot] = static_cast<int>(bi);
  if (!kExtract) return;
  // the winner's 9 coefficient and 9 normal floats, read once
  float win[18];
#pragma unroll
  for (int c = 0; c < 18; ++c) win[c] = 0.0f;
  if (bk >= 0) {
    const float4* w4 = reinterpret_cast<const float4*>(
        kIds ? rows + static_cast<size_t>(__ldg(ids + bk)) * kRow
             : src + static_cast<size_t>(bk) * kRow);
    const float4 a = w4[0], b = w4[1], c = w4[2];
    const float4 na = w4[3], nb = w4[4], nc = w4[5];
    const float gv[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
    const float nv[9] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w, nc.x};
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      win[i] = gv[i];
      win[9 + i] = nv[i];
    }
  }
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

// The kernel's arguments past the settings, as every entry point takes them.
struct Args {
  const float* rays;
  const int* cand_off;
  const int* cand_cnt;
  const float* rows;
  const int* row_ids;
  int n_rows;
  const float* bounds;
  int n_bounds;
  float* t_out;
  int* i_out;
  float* ns_out;
  int strips;
  int t_count;
  float threshold;
  int rule_hit;
  void* stream;
};

template <bool kExtract, int G, int NST, bool kDefer, bool kIds>
int launch(const Args& a) {
  if (a.strips < 0 || a.n_bounds < 0 || a.t_count < 0 ||
      a.t_count >= (1 << 24) || kIds != (a.row_ids != nullptr) ||
      a.n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.strips > 0) {
    const size_t smem = static_cast<size_t>(NST) * G * kSub * kStaged *
                            sizeof(float4) +
                        (G > 1 ? static_cast<size_t>(G) * kLanes * 12 : 0);
    stab_kernel<kExtract, G, NST, kDefer, kIds>
        <<<a.strips, G * kLanes, smem, static_cast<cudaStream_t>(a.stream)>>>(
            a.rays, a.cand_off, a.cand_cnt, a.rows, a.row_ids, a.n_rows,
            a.bounds, a.n_bounds, a.t_out, a.i_out,
            reinterpret_cast<float4*>(a.ns_out), a.strips, a.t_count,
            a.threshold, a.rule_hit);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows read directly (no ids) or through the ids
template <bool kExtract, int G, int NST, bool kDefer>
int run(const Args& a) {
  return a.row_ids != nullptr ? launch<kExtract, G, NST, kDefer, true>(a)
                              : launch<kExtract, G, NST, kDefer, false>(a);
}

template <int G, int NST>
int run_defer(int defer, const Args& a) {
  return defer ? run<true, G, NST, true>(a) : run<true, G, NST, false>(a);
}

template <int G>
int run_stages(int stages, int defer, const Args& a) {
  switch (stages) {
    case 1:
      return run_defer<G, 1>(defer, a);
    case 2:
      return run_defer<G, 2>(defer, a);
    case 3:
      return run_defer<G, 3>(defer, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// rays [strips, 4, 128] f32; cand_off, cand_cnt [strips] int32; rows [P, 24]
// f32 (16-byte aligned), or with row_ids [P] int32 (null: none) the table
// [n_rows, 24] the ids index (n_rows is read only with ids);
// bounds [strips, n_bounds] f32 or null;
// t_out [strips, 128] f32; i_out [strips, 128] int32; ns_out [strips, 128, 4]
// f32.
extern "C" int dxv_raystab_fold_extract(
    const float* rays, const int* cand_off, const int* cand_cnt,
    const float* rows, const int* row_ids, int n_rows, const float* bounds,
    int n_bounds, float* t_out, int* i_out, float* ns_out, int strips,
    int t_count, float threshold, int rule_hit, void* stream) {
  const Args a{rays,   cand_off, cand_cnt, rows,      row_ids,  n_rows,
               bounds, n_bounds, t_out,    i_out,     ns_out,   strips,
               t_count, threshold, rule_hit, stream};
  return run<true, kGroups, kStages, true>(a);
}

// The same with groups per strip (1, 2, 4), ring stages (1, 2, 3) and the
// deferred division (0, 1) chosen by the caller: the timing sweep.
extern "C" int dxv_raystab_fold_extract_variant(
    const float* rays, const int* cand_off, const int* cand_cnt,
    const float* rows, const int* row_ids, int n_rows, const float* bounds,
    int n_bounds, float* t_out, int* i_out, float* ns_out, int strips,
    int t_count, float threshold, int rule_hit, int groups, int stages,
    int defer, void* stream) {
  const Args a{rays,   cand_off, cand_cnt, rows,      row_ids,  n_rows,
               bounds, n_bounds, t_out,    i_out,     ns_out,   strips,
               t_count, threshold, rule_hit, stream};
  switch (groups) {
    case 1:
      return run_stages<1>(stages, defer, a);
    case 2:
      return run_stages<2>(stages, defer, a);
    case 4:
      return run_stages<4>(stages, defer, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fold alone: t_out, i_out as above.
extern "C" int dxv_raystab_fold(const float* rays, const int* cand_off,
                                const int* cand_cnt, const float* rows,
                                const int* row_ids, int n_rows,
                                const float* bounds, int n_bounds,
                                float* t_out, int* i_out, int strips,
                                void* stream) {
  const Args a{rays,  cand_off, cand_cnt, rows,   row_ids, n_rows, bounds,
               n_bounds, t_out, i_out,    nullptr, strips, 0,      0.0f,
               0,     stream};
  return run<false, kGroups, kStages, true>(a);
}
