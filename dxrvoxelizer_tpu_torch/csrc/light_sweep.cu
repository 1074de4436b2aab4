// Light recurrences of the warp render: the -hq reference-step sweep (X.3),
// the -fast per-slab sweep (X.4) and the -pointlight perspective sweep
// (X.5), one launch per field (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/raymarch_warp.py::light_sweep_ref,
// ::light_sweep and ::light_sweep_point (XLA functions, not Pallas kernels:
// each a jax.lax.scan over slabs whose 2-tap bilinear resamples are dense
// [N, N] interpolation matrices multiplied on the matrix unit). All three
// march the light's major tex axis far to near in slab order (the volume
// permuted so that axis comes last, flipped when the light points down
// it):
// - X.3 (light_sweep_ref): in reversed slab order r = n-1-k, slab r reads
//   the output slabs r-d0 (weight 1-w) and r-d0-1 (weight w), 1 below 0;
//   that z-mix is resampled in x then y at the constant shift (sx, sy),
//   taps outside [0, n-1] weighing 0, plus the complement 1 - sum_x * sum_y;
//   times the attenuation at p+s, from the density z-mix of slabs
//   clamp(k+d0) and clamp(k+d0+1) resampled with the coordinate clamped to
//   [0, n-1] (LINEAR_CLAMP), clamp(1 - ABSORPTION*ls*min(8g, 16), 0, 1);
//   L = 1 where p+s leaves the box (the loop's first-step break).
// - X.4 (light_sweep): L[k] = resample(carry) + (1 - sum_x * sum_y) with
//   carry = L[k+1] * att[k+1] (ones past the far slab) and att taken from
//   the density at the voxel itself.
// - X.5 (light_sweep_point): X.4's recurrence toward a light point l (in
//   slab-order tex space, beyond the far slab): slab k's taps lie at
//   a_k (i + 0.5) + (n l_x (1 - a_k) - 0.5), a_k = (z_{k+1} - l_z) /
//   (z_k - l_z), z_k = (k + 0.5) / n (the last slab's z_{k+1} is
//   (n + 0.5) / n), the same in y; each carry tap's attenuation takes its
//   own crossing length ((2/n) sqrt((dx^2 + dy^2) + dz^2)) / |dz| from the
//   tap's texel centre to l. The texel and slab centres (k + 0.5) / n are
//   rounded divisions, as in the plain version and the JAX package: with
//   the light near the far face the map is ill-conditioned, and an ulp of
//   z_k moves a tap by 1e-3 texels at 160^3.
//
// What bounds it on the card: bytes, by the count of chip_smoke.py and
// benchmark/work.py: the density read once and the field written once,
// 8 bytes a voxel (0.63 us at 64^3, 40 us at 256^3 at 3.35 TB/s), against
// 66 FP32 operations per voxel inside the box for X.3, 38 for X.4 and 80
// for X.5 (a square root and a division a tap). In practice the chain of
// dependent steps: ceil(n/d0) steps for X.3 (22 at 64^3 and 256^3 for the
// cells' light), n for X.4 and X.5, each reading slabs an earlier step
// wrote d0+1 texels away at most (X.5: its taps lie within a texel of the
// voxel's light ray), so a step waits for the blocks that wrote them. A step's time is its chain's latency: the wait,
// one round of loads through L2, the resample, the stores and their
// release (about 3 us on the H100 at 64^3), not its bytes.
//
// Design:
// - Each resample is a 2-tap stencil per axis: no interpolation matrix is
//   built or multiplied. Taps outside the volume load nothing and weigh 0,
//   as the matrices' zero columns do. A voxel's 8 carry taps and 8 density
//   taps are loaded together, one round trip a step.
// - The output volume is the carry: the slabs a step reads are ones an
//   earlier step wrote, read back through L2 (__ldcg). There is no carry
//   buffer, no concatenation and no attenuation volume.
// - Natural layout in and out: density is read and L written in their
//   [N, N, N] layout; the slab order's permutation and flip are strides and
//   an index reflection, so no permuted or flipped copy is made. A step's
//   voxels are spread over the threads (a warp along slab y where it is the
//   layout's minor axis, else along the step's d0 slabs, side by side in
//   memory).
// - A cooperative grid of at most what stays resident, without a
//   grid-wide barrier between steps. Each block publishes the steps it has
//   done in a flag (its stores, a fence, the flag) and, before a step,
//   waits only for its producers: the blocks whose voxels its carry taps
//   read, a short range of blocks found once per launch from the taps'
//   geometry (the shift is constant; a block holds one run of each step's
//   voxels, so the range stays short; X.5's tap map changes with the slab,
//   so its range is found every step from the run's end rows, in O(1): the
//   map is monotone). Steps overlap across the grid
//   instead of each ending in a barrier. Blocks of 128 threads up to
//   16,384 voxels a step, else 256 (threads_for below, mirrored by
//   ops/raymarch_warp.py::sweep_threads). The flags live in scratch that
//   the wrapper allocates once per device and stream: each flag holds the
//   launch's epoch (high word) and the steps done (low word), so a flag
//   left by an earlier launch reads as none done and nothing is reset; the
//   last block to finish (a count in the same scratch) advances the epoch,
//   all on the device, so a frame gains no device op. A wait that never
//   ends traps.
// - FP32 throughout; every operation is an explicitly rounded intrinsic in
//   the plain version's order (z-mix products then sum; x taps, then y
//   taps, each as product, product, sum), so nvcc contracts nothing.
// - The statics (w, sx, sy, the attenuation's constant, the box of texels
//   whose p+s lies inside; X.5: the light point alone, the per-slab maps
//   and crossing lengths computed here with the plain version's float32
//   operations) come by value from the host, which computes them with the
//   plain version's float32 operations: no device read, no sync, no
//   per-slab vector copied to the card.

#include <climits>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;
// blocks, at most: scratch (32-bit words) holds the epoch, the count of
// blocks done, then from word 32 a 64-bit flag a block
constexpr int kFlags = 4096;
constexpr long long kPatience = 1LL << 24;  // polls before a wait traps

struct Sweep {
  const float* density;
  float* out;
  unsigned* epoch;  // the launch's epoch; then the count of blocks done
  unsigned long long* flags;  // epoch << 32 | steps done, a flag a block
  int n;
  int per;    // slabs per step: d0 (X.3), 1 (X.4)
  int flip;   // slab k lies at n-1-k along the axis
  long long sk, sx, sy;  // strides of slab, x and y in the natural layout
  float w;               // X.3: weight of the farther slab of each z-mix
  float shift_x, shift_y;  // tap coordinate = texel index + shift
  float absl;  // ABSORPTION times the step length (X.5: ABSORPTION)
  int xlo, xhi, ylo, yhi, kmax;  // X.3: texels whose p+s lies in the box
  float lx, ly, lz;  // X.5: the light point in slab-order tex space
};

// one axis of an interp_matrix row: coordinate c, taps i0 and i0 + 1
struct Axis {
  int i0;
  bool in0, in1;  // the tap lies in [0, n-1]
  float w0, w1;   // 1 - f and f, 0 for a tap outside
};

__device__ __forceinline__ Axis axis_taps(float c, int n) {
  const float c0 = floorf(c);
  const float f = __fsub_rn(c, c0);
  Axis a;
  a.i0 = static_cast<int>(c0);
  a.in0 = a.i0 >= 0 && a.i0 <= n - 1;
  a.in1 = a.i0 + 1 >= 0 && a.i0 + 1 <= n - 1;
  a.w0 = a.in0 ? __fsub_rn(1.0f, f) : 0.0f;
  a.w1 = a.in1 ? f : 0.0f;
  return a;
}

// the row's sum (the matrix's row sum: the two weights, zeros exact)
__device__ __forceinline__ float row_sum(const Axis& a) {
  return __fadd_rn(a.w0, a.w1);
}

// (wx @ V @ wy^T) at one texel: x taps first, then y taps; value(x, y) is
// read only for taps inside the volume (the others weigh 0)
template <class V>
__device__ __forceinline__ float resample(const Axis& ax, const Axis& ay,
                                          V value) {
  float row[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const bool yin = t ? ay.in1 : ay.in0;
    const int y = ay.i0 + t;
    const float a = (yin && ax.in0) ? value(ax.i0, y) : 0.0f;
    const float b = (yin && ax.in1) ? value(ax.i0 + 1, y) : 0.0f;
    row[t] = __fadd_rn(__fmul_rn(ax.w0, a), __fmul_rn(ax.w1, b));
  }
  return __fadd_rn(__fmul_rn(ay.w0, row[0]), __fmul_rn(ay.w1, row[1]));
}

// clamp(1 - absl * min(8 d, 16), 0, 1): the shader's attenuation
__device__ __forceinline__ float attenuation(float d, float absl) {
  const float g = fminf(__fmul_rn(d, 8.0f), 16.0f);
  return fminf(fmaxf(__fsub_rn(1.0f, __fmul_rn(absl, g)), 0.0f), 1.0f);
}

__device__ __forceinline__ long long slab_offset(const Sweep& p, int k) {
  return static_cast<long long>(p.flip ? p.n - 1 - k : k) * p.sk;
}

__device__ __forceinline__ long long texel(const Sweep& p, int x, int y) {
  return x * p.sx + y * p.sy;
}

// X.3: slab k (r = n-1-k), texel (x, y); reads output slabs r-d0, r-d0-1
__device__ __forceinline__ float ref_voxel(const Sweep& p, int k, int x,
                                           int y) {
  const int n = p.n;
  if (x < p.xlo || x > p.xhi || y < p.ylo || y > p.yhi || k > p.kmax) {
    return 1.0f;  // p+s leaves the box: the loop breaks at its first step
  }
  const float omw = __fsub_rn(1.0f, p.w);
  const float cx = __fadd_rn(static_cast<float>(x), p.shift_x);
  const float cy = __fadd_rn(static_cast<float>(y), p.shift_y);
  const float top = static_cast<float>(n - 1);
  // attenuation at p+s: density z-mix of clamp(k+d0), clamp(k+d0+1) at
  // the clamped coordinate (LINEAR_CLAMP)
  const Axis dx = axis_taps(fminf(fmaxf(cx, 0.0f), top), n);
  const Axis dy = axis_taps(fminf(fmaxf(cy, 0.0f), top), n);
  const float* d0s = p.density + slab_offset(p, min(k + p.per, n - 1));
  const float* d1s = p.density + slab_offset(p, min(k + p.per + 1, n - 1));
  const float dres = resample(dx, dy, [&](int i, int j) {
    const long long o = texel(p, i, j);
    return __fadd_rn(__fmul_rn(__ldg(d0s + o), omw),
                     __fmul_rn(__ldg(d1s + o), p.w));
  });
  const float att = attenuation(dres, p.absl);
  // L(p+s): z-mix of the output slabs r-d0 (1-w) and r-d0-1 (w), 1 before
  // the far face, resampled with zero weight outside plus the complement
  const Axis lx = axis_taps(cx, n);
  const Axis ly = axis_taps(cy, n);
  const int r = n - 1 - k;
  const float* la =
      r - p.per >= 0 ? p.out + slab_offset(p, k + p.per) : nullptr;
  const float* lb =
      r - p.per - 1 >= 0 ? p.out + slab_offset(p, k + p.per + 1) : nullptr;
  const float lres = resample(lx, ly, [&](int i, int j) {
    const long long o = texel(p, i, j);
    const float a = la ? __ldcg(la + o) : 1.0f;
    const float b = lb ? __ldcg(lb + o) : 1.0f;
    return __fadd_rn(__fmul_rn(a, omw), __fmul_rn(b, p.w));
  });
  const float corr =
      __fsub_rn(1.0f, __fmul_rn(row_sum(lx), row_sum(ly)));
  return __fmul_rn(att, __fadd_rn(lres, corr));
}

// X.4: slab k, texel (x, y); reads output slab k+1 times its attenuation
__device__ __forceinline__ float dir_voxel(const Sweep& p, int k, int x,
                                           int y) {
  const int n = p.n;
  const Axis ax = axis_taps(__fadd_rn(static_cast<float>(x), p.shift_x), n);
  const Axis ay = axis_taps(__fadd_rn(static_cast<float>(y), p.shift_y), n);
  const bool first = k == n - 1;  // the carry past the far slab is 1
  const long long s1 = first ? 0 : slab_offset(p, k + 1);
  const float res = resample(ax, ay, [&](int i, int j) {
    if (first) return 1.0f;
    const long long o = s1 + texel(p, i, j);
    return __fmul_rn(__ldcg(p.out + o),
                     attenuation(__ldg(p.density + o), p.absl));
  });
  return __fadd_rn(res, __fsub_rn(1.0f, __fmul_rn(row_sum(ax), row_sum(ay))));
}

// a step's voxel v -> (j, x, y): neighbouring threads on neighbouring
// addresses, along slab y where it is the layout's minor axis, else along
// the step's slabs
__device__ __forceinline__ void voxel_at(const Sweep& p, int v, int& j,
                                         int& x, int& y) {
  const int plane = p.n * p.n;
  int xy;
  if (p.sy == 1 || p.per == 1) {
    j = v / plane;
    xy = v - j * plane;
  } else {
    xy = v / p.per;
    j = v - xy * p.per;
  }
  x = xy / p.n;
  y = xy - x * p.n;
}

// voxel_at's inverse
__device__ __forceinline__ int voxel_index(const Sweep& p, int j, int x,
                                           int y) {
  const int xy = x * p.n + y;
  return (p.sy == 1 || p.per == 1) ? j * p.n * p.n + xy : xy * p.per + j;
}

// ---- the producers' flags ---------------------------------------------------

// the blocks that write what this block's carry taps read, as one range
// lo..hi (a superset is safe; none: lo > hi). Block b holds voxels
// b*chunk .. (b+1)*chunk-1 of every step; X.3's slab r-d0 is step s-1's
// slab j, its slab r-d0-1 step s-1's slab j-1 (j = 0: step s-2's slab
// d0-1); X.4's slab r-1 is step s-1's only slab
template <bool kRef>
__device__ void producers(const Sweep& p, int count, int chunk, int* lo,
                          int* hi) {
  __shared__ int s_lo, s_hi;
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }
  __syncthreads();
  int b_lo = INT_MAX, b_hi = -1;
  const int end = min(count, (blockIdx.x + 1) * chunk);
  for (int v = blockIdx.x * chunk + threadIdx.x; v < end;
       v += blockDim.x) {
    int j, x, y;
    voxel_at(p, v, j, x, y);
    const Axis ax =
        axis_taps(__fadd_rn(static_cast<float>(x), p.shift_x), p.n);
    const Axis ay =
        axis_taps(__fadd_rn(static_cast<float>(y), p.shift_y), p.n);
    const int js[2] = {kRef ? j : 0, kRef ? (j > 0 ? j - 1 : p.per - 1) : 0};
#pragma unroll 1
    for (int q = 0; q < 2; ++q) {
#pragma unroll 1
      for (int t = 0; t < 4; ++t) {
        const bool in =
            (t & 1 ? ax.in1 : ax.in0) && (t >> 1 ? ay.in1 : ay.in0);
        if (!in) continue;
        const int w = voxel_index(p, js[q], ax.i0 + (t & 1),
                                  ay.i0 + (t >> 1));
        const int b = w / chunk;
        b_lo = min(b_lo, b);
        b_hi = max(b_hi, b);
      }
    }
  }
  // a warp's range first: one shared atomic a warp
  b_lo = __reduce_min_sync(0xffffffffu, b_lo);
  b_hi = __reduce_max_sync(0xffffffffu, b_hi);
  if ((threadIdx.x & 31) == 0 && b_hi >= 0) {
    atomicMin(&s_lo, b_lo);
    atomicMax(&s_hi, b_hi);
  }
  __syncthreads();
  *lo = s_lo;
  *hi = s_hi;
}

// wait until blocks lo..hi have posted `steps` steps of this launch
// (acquire), a thread a flag; a wait that never ends traps instead of
// hanging
__device__ __forceinline__ void flags_wait(const Sweep& p, int lo, int hi,
                                           unsigned long long steps) {
  if (lo <= hi) {
    for (int b = lo + threadIdx.x; b <= hi; b += blockDim.x) {
      unsigned long long v;
      long long polls = 0;
      do {
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                     : "=l"(v) : "l"(p.flags + b) : "memory");
        if (++polls > kPatience) __trap();
      } while (v < steps);
    }
  }
  __syncthreads();
}

// the block's stores, then its steps done (epoch << 32 | steps)
__device__ __forceinline__ void flags_post(const Sweep& p,
                                           unsigned long long steps) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(p.flags + blockIdx.x), "l"(steps) : "memory");
  }
}

// the last block to finish advances the epoch (every block has read it)
__device__ __forceinline__ void flags_done(const Sweep& p) {
  if (threadIdx.x == 0 && atomicAdd(p.epoch + 1, 1u) == gridDim.x - 1) {
    p.epoch[1] = 0;
    p.epoch[0] += 1;
  }
}

template <bool kRef>
__global__ void __launch_bounds__(256, 6) light_sweep_kernel(const Sweep p) {
  const int per = kRef ? p.per : 1;
  const int steps = (p.n + per - 1) / per;
  const int count = per * p.n * p.n;  // voxels a step
  // the block's voxels of every step: one run, threads side by side
  const int chunk = (count + gridDim.x - 1) / gridDim.x;
  const int end = min(count, (blockIdx.x + 1) * chunk);
  // this launch's epoch << 32
  const unsigned long long tag =
      static_cast<unsigned long long>(__ldcg(p.epoch)) << 32;
  int lo, hi;
  producers<kRef>(p, count, chunk, &lo, &hi);
  for (int s = 0; s < steps; ++s) {
    if (s > 0) flags_wait(p, lo, hi, tag | s);
    for (int v = blockIdx.x * chunk + threadIdx.x; v < end;
         v += blockDim.x) {
      int j, x, y;
      voxel_at(p, v, j, x, y);
      const int r = s * per + j;  // reversed slab order: far slab first
      if (r >= p.n) continue;
      const int k = p.n - 1 - r;
      const float val = kRef ? ref_voxel(p, k, x, y) : dir_voxel(p, k, x, y);
      __stcg(p.out + slab_offset(p, k) + texel(p, x, y), val);
    }
    if (s + 1 < steps) flags_post(p, tag | (s + 1));
  }
  flags_done(p);
}

// ---- X.5: the point light ---------------------------------------------------

// (k + 0.5) / n, texel or slab k's centre, a rounded division (as the
// plain version and the JAX package compute it)
__device__ __forceinline__ float slab_z(int k, int n) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f),
                   static_cast<float>(n));
}

// slab k's tap map, coordinate = a * (i + 0.5) + off, and the carry slab
// k+1's offset from the light along the sweep (dz^2 and |dz|)
struct PointSlab {
  float a, off_x, off_y;
  float dz2, adz;
};

__device__ __forceinline__ PointSlab point_slab(const Sweep& p, int k) {
  const float nf = static_cast<float>(p.n);
  // the plane past the far slab: (n + 0.5) / n, rounded once
  const float z1 = k + 1 < p.n ? slab_z(k + 1, p.n)
                               : __fdiv_rn(__fadd_rn(nf, 0.5f), nf);
  const float dz = __fsub_rn(z1, p.lz);
  PointSlab m;
  m.a = __fdiv_rn(dz, __fsub_rn(slab_z(k, p.n), p.lz));
  const float oma = __fsub_rn(1.0f, m.a);
  m.off_x = __fsub_rn(__fmul_rn(__fmul_rn(nf, p.lx), oma), 0.5f);
  m.off_y = __fsub_rn(__fmul_rn(__fmul_rn(nf, p.ly), oma), 0.5f);
  m.dz2 = __fmul_rn(dz, dz);
  m.adz = fabsf(dz);
  return m;
}

__device__ __forceinline__ float point_coord(float a, float off, int i) {
  return __fadd_rn(__fmul_rn(a, __fadd_rn(static_cast<float>(i), 0.5f)), off);
}

// (texel i's centre - l)^2 along one slab axis
__device__ __forceinline__ float point_d2(int i, float l, int n) {
  const float d = __fsub_rn(slab_z(i, n), l);
  return __fmul_rn(d, d);
}

// X.5: slab k, texel (x, y); reads output slab k+1 times each tap's
// attenuation at the tap's own crossing length. The four carry taps and
// their densities are loaded before any is used (one round trip), then
// resampled as resample() does: x taps, then y taps.
__device__ __forceinline__ float point_voxel(const Sweep& p,
                                             const PointSlab& m, int k,
                                             int x, int y) {
  const int n = p.n;
  const Axis ax = axis_taps(point_coord(m.a, m.off_x, x), n);
  const Axis ay = axis_taps(point_coord(m.a, m.off_y, y), n);
  const float corr =
      __fsub_rn(1.0f, __fmul_rn(row_sum(ax), row_sum(ay)));
  bool in[2][2];  // [y tap][x tap]: the tap lies in the volume
  float val[2][2];
  if (k == n - 1) {  // the carry past the far slab is 1
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      in[t >> 1][t & 1] = (t >> 1 ? ay.in1 : ay.in0) && (t & 1 ? ax.in1
                                                                : ax.in0);
      val[t >> 1][t & 1] = 1.0f;
    }
  } else {
    const long long s1 = slab_offset(p, k + 1);
    float carry[2][2], dens[2][2];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int tx = t & 1, ty = t >> 1;
      in[ty][tx] = (ty ? ay.in1 : ay.in0) && (tx ? ax.in1 : ax.in0);
      const long long o = s1 + texel(p, ax.i0 + tx, ay.i0 + ty);
      carry[ty][tx] = in[ty][tx] ? __ldcg(p.out + o) : 0.0f;
      dens[ty][tx] = in[ty][tx] ? __ldg(p.density + o) : 0.0f;
    }
    const float c2n = __fdiv_rn(2.0f, static_cast<float>(n));
    const float dx2[2] = {point_d2(ax.i0, p.lx, n),
                          point_d2(ax.i0 + 1, p.lx, n)};
    const float dy2[2] = {point_d2(ay.i0, p.ly, n),
                          point_d2(ay.i0 + 1, p.ly, n)};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int tx = t & 1, ty = t >> 1;
      const float r =
          __fsqrt_rn(__fadd_rn(__fadd_rn(dx2[tx], dy2[ty]), m.dz2));
      const float delta = __fdiv_rn(__fmul_rn(c2n, r), m.adz);
      val[ty][tx] = __fmul_rn(
          carry[ty][tx],
          attenuation(dens[ty][tx], __fmul_rn(p.absl, delta)));
    }
  }
  float row[2];
#pragma unroll
  for (int ty = 0; ty < 2; ++ty) {
    const float a = in[ty][0] ? val[ty][0] : 0.0f;
    const float b = in[ty][1] ? val[ty][1] : 0.0f;
    row[ty] = __fadd_rn(__fmul_rn(ax.w0, a), __fmul_rn(ax.w1, b));
  }
  return __fadd_rn(
      __fadd_rn(__fmul_rn(ay.w0, row[0]), __fmul_rn(ay.w1, row[1])), corr);
}

// the taps that coordinates a * (i + 0.5) + off read for i in i0..i1, as
// one range lo..hi inside [0, n-1] (none: lo > hi); the map is monotone, so
// the ends' taps bound it
__device__ __forceinline__ void tap_range(float a, float off, int i0, int i1,
                                          int n, int* lo, int* hi) {
  const int t0 = static_cast<int>(floorf(point_coord(a, off, i0)));
  const int t1 = static_cast<int>(floorf(point_coord(a, off, i1)));
  *lo = max(min(t0, t1), 0);
  *hi = min(max(t0, t1) + 1, n - 1);
}

// the blocks that wrote what voxels v0..v1 of slab k read in slab k+1, as
// one range lo..hi (none: lo > hi): the rows x0..x1 of the run and its
// columns (y0..y1 on one row, else every column) under slab k's map; the
// taps' voxels (tx, ty) lie between (tx_lo, ty_lo) and (tx_hi, ty_hi) in
// the step's order, whose blocks are runs of `chunk`
__device__ __forceinline__ void point_producers(const Sweep& p,
                                                const PointSlab& m, int v0,
                                                int v1, int chunk, int* lo,
                                                int* hi) {
  const int n = p.n;
  *lo = 1;
  *hi = 0;
  if (v0 > v1) return;
  const int x0 = v0 / n, x1 = v1 / n;
  const int y0 = x0 == x1 ? v0 - x0 * n : 0;
  const int y1 = x0 == x1 ? v1 - x1 * n : n - 1;
  int tx0, tx1, ty0, ty1;
  tap_range(m.a, m.off_x, x0, x1, n, &tx0, &tx1);
  tap_range(m.a, m.off_y, y0, y1, n, &ty0, &ty1);
  if (tx0 > tx1 || ty0 > ty1) return;
  *lo = (tx0 * n + ty0) / chunk;
  *hi = (tx1 * n + ty1) / chunk;
}

// 4 blocks of 256 an SM at most: up to 64 registers, where the bound X.3
// and X.4 take (6 blocks, 40 registers) spills the crossing lengths'
// temporaries; every launch of X.5 up to 256^3 (256 blocks) stays resident
__global__ void __launch_bounds__(256, 4)
    light_sweep_point_kernel(const Sweep p) {
  const int n = p.n;
  const int count = n * n;  // voxels a step: one slab
  const int chunk = (count + gridDim.x - 1) / gridDim.x;
  const int v0 = blockIdx.x * chunk;
  const int end = min(count, v0 + chunk);
  const unsigned long long tag =
      static_cast<unsigned long long>(__ldcg(p.epoch)) << 32;
  for (int s = 0; s < n; ++s) {
    const int k = n - 1 - s;  // far slab first
    const PointSlab m = point_slab(p, k);
    if (s > 0) {
      int lo, hi;
      point_producers(p, m, v0, end - 1, chunk, &lo, &hi);
      flags_wait(p, lo, hi, tag | s);
    }
    for (int v = v0 + threadIdx.x; v < end; v += blockDim.x) {
      const int x = v / n;
      const int y = v - x * n;
      __stcg(p.out + slab_offset(p, k) + texel(p, x, y),
             point_voxel(p, m, k, x, y));
    }
    if (s + 1 < n) flags_post(p, tag | (s + 1));
  }
  flags_done(p);
}

// ---- launch ----------------------------------------------------------------

// threads per block (mirrored by ops/raymarch_warp.py::sweep_threads): 128
// up to 16,384 voxels a step (X.3: d0 slabs, X.4 and X.5: one), else 256
int threads_for(long long count) { return count <= 16384 ? 128 : 256; }

// the instances: X.3, X.4, X.5
constexpr int kInstances = 3;
const void* instance(int which) {
  switch (which) {
    case 0: return reinterpret_cast<const void*>(light_sweep_kernel<true>);
    case 1: return reinterpret_cast<const void*>(light_sweep_kernel<false>);
    default: return reinterpret_cast<const void*>(light_sweep_point_kernel);
  }
}

// the most blocks of one instance at `threads` the card keeps resident
// (per device, instance and block size; 0: the query failed)
int resident_blocks(int dev, int which, int threads) {
  static int cache[kMaxDevices][kInstances][2];
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  int& most = cache[dev][which][threads == 256];
  if (most == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, instance(which), threads, 0) == cudaSuccess) {
      most = sms * per_sm;
    }
  }
  return most;
}

// one cooperative launch of instance `which` with `count` voxels a step
int launch(int which, Sweep& p, long long count, cudaStream_t stream) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const int threads = threads_for(count);
  const int most = resident_blocks(dev, which, threads);
  if (most <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = (count + threads - 1) / threads;
  if (blocks > most) blocks = most;
  if (blocks > kFlags) blocks = kFlags;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      instance(which), dim3(static_cast<unsigned>(blocks)), dim3(threads),
      args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the fields every instance reads: volumes, scratch, layout
Sweep sweep_of(const void* density, void* out, void* scratch, int n,
               int axis, int flip) {
  const long long stride[3] = {static_cast<long long>(n) * n, n, 1};
  const int rest0 = axis == 0 ? 1 : 0;
  const int rest1 = axis == 2 ? 1 : 2;
  Sweep p{};
  p.density = static_cast<const float*>(density);
  p.out = static_cast<float*>(out);
  p.epoch = static_cast<unsigned*>(scratch);
  p.flags = reinterpret_cast<unsigned long long*>(p.epoch + 32);
  p.n = n;
  p.per = 1;
  p.flip = flip;
  p.sk = stride[axis];
  p.sx = stride[rest0];
  p.sy = stride[rest1];
  return p;
}

}  // namespace

// density [n, n, n] -> out [n, n, n]; scratch: 32 + 2 * 4,096 zeroed
// 32-bit words per device and stream, 8-byte aligned (the epoch and the
// count of blocks done, then the flags; reused by every launch on the
// stream); axis, flip: the light's major tex axis and sign; ref: X.3 (1) or
// X.4 (0); d0, w, the box (xlo..xhi, ylo..yhi in slab x/y, slabs
// 0..kmax): X.3 only
extern "C" int dxv_light_sweep(const void* density, void* out, void* scratch,
                               int n, int ref, int axis, int flip, int d0,
                               float w, float shift_x, float shift_y,
                               float absl, int xlo, int xhi, int ylo, int yhi,
                               int kmax, void* stream) {
  if (n <= 0) return 0;
  // a step's voxels are indexed with 32-bit ints
  if (axis < 0 || axis > 2 || (ref && d0 < 1) || scratch == nullptr ||
      static_cast<long long>(ref ? d0 : 1) * n * n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sweep p = sweep_of(density, out, scratch, n, axis, flip);
  p.per = ref ? d0 : 1;
  p.w = w;
  p.shift_x = shift_x;
  p.shift_y = shift_y;
  p.absl = absl;
  p.xlo = xlo;
  p.xhi = xhi;
  p.ylo = ylo;
  p.yhi = yhi;
  p.kmax = kmax;
  return launch(ref ? 0 : 1, p, static_cast<long long>(p.per) * n * n,
                static_cast<cudaStream_t>(stream));
}

// X.5: density [n, n, n] -> out [n, n, n]; scratch as above (shared with
// X.3 and X.4 on the stream); axis, flip: the light's major tex axis and
// side; lx, ly, lz: the light point in slab-order tex space (float32, the
// plain version's l_t), beyond the far slab (lz > (n + 0.5) / n);
// absorption: ABSORPTION
extern "C" int dxv_light_sweep_point(const void* density, void* out,
                                     void* scratch, int n, int axis,
                                     int flip, float lx, float ly, float lz,
                                     float absorption, void* stream) {
  if (n <= 0) return 0;
  if (axis < 0 || axis > 2 || scratch == nullptr ||
      static_cast<long long>(n) * n > INT_MAX ||
      !(lz > (static_cast<float>(n) + 0.5f) / static_cast<float>(n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sweep p = sweep_of(density, out, scratch, n, axis, flip);
  p.absl = absorption;
  p.lx = lx;
  p.ly = ly;
  p.lz = lz;
  return launch(2, p, static_cast<long long>(n) * n,
                static_cast<cudaStream_t>(stream));
}
