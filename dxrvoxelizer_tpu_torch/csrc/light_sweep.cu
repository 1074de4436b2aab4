// Light recurrences of the warp render: the -hq reference-step sweep (X.3)
// and the -fast per-slab sweep (X.4), one launch per field (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/raymarch_warp.py::light_sweep_ref and
// ::light_sweep (XLA functions, not Pallas kernels: each a jax.lax.scan over
// slabs whose 2-tap bilinear resamples are dense [N, N] interpolation
// matrices multiplied on the matrix unit). Both march the light's major tex
// axis far to near in slab order (the volume permuted so that axis comes
// last, flipped when the light points down it):
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
//
// What bounds it on the card: bytes, by the count of chip_smoke.py and
// benchmark/work.py: the density read once and the field written once,
// 8 bytes a voxel (0.63 us at 64^3, 40 us at 256^3 at 3.35 TB/s), against
// 66 FP32 operations per voxel inside the box for X.3 and 38 for X.4. In
// practice the chain of dependent steps: ceil(n/d0) steps for X.3 (22 at
// 64^3 and 256^3 for the cells' light), n for X.4, each reading slabs an
// earlier step wrote d0+1 texels away at most, so a step waits for the
// blocks that wrote them. A step's time is its chain's latency: the wait,
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
//   voxels, so the range stays short). Steps overlap across the grid
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
//   whose p+s lies inside) come by value from the host, which computes them
//   with the plain version's float32 operations: no device read, no sync.

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
  float absl;            // ABSORPTION times the step length, float32
  int xlo, xhi, ylo, yhi, kmax;  // X.3: texels whose p+s lies in the box
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

// ---- launch ----------------------------------------------------------------

// threads per block (mirrored by ops/raymarch_warp.py::sweep_threads): 128
// up to 16,384 voxels a step (X.3: d0 slabs, X.4: one), else 256
int threads_for(long long count) { return count <= 16384 ? 128 : 256; }

// the most blocks of one instance at `threads` the card keeps resident
// (per device, instance and block size; 0: the query failed)
template <bool kRef>
int resident_blocks(int dev, int threads) {
  static int cache[kMaxDevices][2];
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  int& most = cache[dev][threads == 256];
  if (most == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, light_sweep_kernel<kRef>, threads, 0) == cudaSuccess) {
      most = sms * per_sm;
    }
  }
  return most;
}

template <bool kRef>
int launch(Sweep& p, cudaStream_t stream) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const long long count = static_cast<long long>(p.per) * p.n * p.n;
  const int threads = threads_for(count);
  const int most = resident_blocks<kRef>(dev, threads);
  if (most <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = (count + threads - 1) / threads;
  if (blocks > most) blocks = most;
  if (blocks > kFlags) blocks = kFlags;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(light_sweep_kernel<kRef>),
      dim3(static_cast<unsigned>(blocks)), dim3(threads), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
  const long long stride[3] = {static_cast<long long>(n) * n, n, 1};
  const int rest0 = axis == 0 ? 1 : 0;
  const int rest1 = axis == 2 ? 1 : 2;
  Sweep p;
  p.density = static_cast<const float*>(density);
  p.out = static_cast<float*>(out);
  p.epoch = static_cast<unsigned*>(scratch);
  p.flags = reinterpret_cast<unsigned long long*>(p.epoch + 32);
  p.n = n;
  p.per = ref ? d0 : 1;
  p.flip = flip;
  p.sk = stride[axis];
  p.sx = stride[rest0];
  p.sy = stride[rest1];
  p.w = w;
  p.shift_x = shift_x;
  p.shift_y = shift_y;
  p.absl = absl;
  p.xlo = xlo;
  p.xhi = xhi;
  p.ylo = ylo;
  p.yhi = yhi;
  p.kmax = kmax;
  const auto s = static_cast<cudaStream_t>(stream);
  return ref ? launch<true>(p, s) : launch<false>(p, s);
}
