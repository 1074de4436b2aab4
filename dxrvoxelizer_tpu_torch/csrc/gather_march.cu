// Gather ray-march: the reference's primary march per screen pixel, with
// the light transmittance read from a precomputed light volume, and the
// ray set-up fused in (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/raymarch_fast.py::raymarch_fast (an XLA
// function, not a Pallas kernel): its ray set-up (the screen-to-local
// transform and ComputeStartPoint, :184-196) and the march of its chunk_fn:
// 128 samples per pixel at pos_s = entry + dir * (s * step), each an 8-tap
// trilinear read of the density (GetSample, PSRayCast.hlsl:103-112) and,
// where it contributes, one of the light volume; transmittance as a cumprod
// and the shader's breaks as monotone masks, over chunks of 2^17 pixels.
// Here each pixel is one thread that sets up its ray and runs the loop with
// the shader's breaks (PSRayCast.hlsl:134-179): the first step outside the
// box ends the march, and so does the first occupied step whose
// transmittance falls below 0.01, whose value is then the final one. The
// composite follows: scatter * 0.8 + 0.2 lerped to clear^2 by the
// transmittance, its square root, and the clear colour for misses.
//
// What bounds it on the card: by the count of chip_smoke.py (GATHER_OPS_*:
// 46 FP32 operations per density sample, 27 per contributing step, 17 per
// hit pixel and 70 for the set-up of every pixel) against bytes of the
// colours out (12 bytes per pixel, 11 MB at 1280x720) and the two volumes
// in (1 MiB each at 64^3, 64 MiB at 256^3): operations at 64^3, bytes at
// 256^3. In practice the taps' latency: a ray is a dependent chain (each
// step's eight taps depend on the position, and whether the next step
// runs depends on this step's transmittance), and at 256^3 the two
// volumes (128 MiB) exceed the 50 MB L2.
//
// Design:
// - The set-up is in the kernel, so no ray table is written or read and
//   nothing is copied from the host per call: the 16 floats of
//   screen_to_local, the eye, the clear colour, the band's first row
//   (y_offset) and the step are kernel arguments. Per pixel: the screen
//   point, the row-order transform (a sum of four products, as
//   raymarch_ref.screen_rays), the division by h.w, the norm as
//   ((x*x + y*y) + z*z) and its correctly rounded root, the three slab
//   tests of compute_start_point with its d_i == 0 case, the inside case
//   and the final clamp, and the step offsets s * step rounded as
//   sample_offsets rounds them.
// - Screen tiles: a block is 16 x 16 pixels and a warp 8 x 4, so a warp's
//   rays are neighbours in 2-D whose taps share cache lines, and a block
//   outside the box's screen footprint ends at once. A sweep (PERF.md §6)
//   measured them faster than rows of 256 pixels (the previous design's
//   shape) and than 32 x 32 tiles whose hit pixels are compacted in shared
//   memory and then marched by all 256 threads (2.7-2.8x slower).
// - The density taps run kK = 2 steps ahead of the breaks, as in the light
//   volume (a step outside the box loads none): a batch issues the taps of
//   kK steps, then applies the breaks in order; the light-volume tap stays
//   conditional on a contributing step, at a position computed again (its
//   taps are not kept: fewer registers). The sweep measured K = 1, 2 and 4
//   close and K = 8 slower.
// - Taps index with 32-bit offsets (n <= 1024).
// Every operation is an explicitly rounded intrinsic in the plain version's
// order (trilinear.cuh; PyTorch's CUDA ops round each operation once and
// divide tensors exactly), so the kernel is the plain path (gather_rays +
// gather_march_plain) bit for bit.

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr float kZeroThreshold = 0.01f;  // PSRayCast.hlsl:10
constexpr float kFltMax = 3.402823466e38f;  // raymarch_ref.FLT_MAX
constexpr int kThreads = 256;
constexpr int kK = 2;     // steps per batch
constexpr int kTile = 16;  // a block's tile of kTile x kTile pixels
static_assert(kTile * kTile == kThreads, "tile");

// the frame's constants, passed by value (the host packs them: 24 floats)
struct Camera {
  float m[16];  // screen_to_local, row-vector convention, row-major
  float eye[3];
  float clear[3];
  float y_offset;  // the band's first screen row
  float step;      // float32(MAX_DIST / n_samples)
};
constexpr int kCameraFloats = 24;

struct Ray {
  float e[3];  // entry point (ComputeStartPoint)
  float d[3];  // unit direction
};

__device__ __forceinline__ float clamp_unit(float x) {
  // torch.clamp(x, -1, 1), which keeps a NaN
  return isnan(x) ? x : fminf(fmaxf(x, -1.0f), 1.0f);
}

// raymarch_ref.screen_rays + compute_start_point for pixel (px, py) of the
// band; returns whether the ray hits the box (or starts inside it)
__device__ __forceinline__ bool setup_ray(const Camera& c, int px, int py,
                                          Ray& r) {
  const float sx = __fadd_rn(static_cast<float>(px), 0.5f);
  const float sy =
      __fadd_rn(__fadd_rn(static_cast<float>(py), 0.5f), c.y_offset);
  // h = (sx, sy, 0, 1) @ m as a sum in row order, one rounding per operation
  float h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __fmul_rn(sx, c.m[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __fadd_rn(h[k], __fmul_rn(sy, c.m[4 + k]));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __fadd_rn(h[k], __fmul_rn(0.0f, c.m[8 + k]));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __fadd_rn(h[k], __fmul_rn(1.0f, c.m[12 + k]));
  float pos[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos[k] = __fdiv_rn(h[k], h[3]);  // ScreenToLocal
    d[k] = __fsub_rn(pos[k], c.eye[k]);
  }
  const float nrm = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
      __fmul_rn(d[2], d[2])));
#pragma unroll
  for (int k = 0; k < 3; ++k) r.d[k] = __fdiv_rn(d[k], nrm);
  // ComputeStartPoint (PSRayCast.hlsl:71-98)
  const bool inside = dxv::in_box(pos[0], pos[1], pos[2]);
  float u_best = kFltMax;
  bool hit = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, k = (i + 2) % 3;
    const float di = r.d[i];
    // d_i == 0: no crossing (the plain version's u = FLT_MAX never passes
    // u < u_best)
    if (di != 0.0f) {
      const float sgn = di > 0.0f ? 1.0f : (di < 0.0f ? -1.0f : 0.0f);
      const float u = __fdiv_rn(__fsub_rn(-sgn, pos[i]), di);
      const bool ok =
          u >= 0.0f &&
          fabsf(__fadd_rn(__fmul_rn(r.d[j], u), pos[j])) <= 1.0f &&
          fabsf(__fadd_rn(__fmul_rn(r.d[k], u), pos[k])) <= 1.0f &&
          u < u_best;
      if (ok) {
        u_best = u;
        hit = true;
      }
    }
  }
  const float u_final = (!inside && hit) ? u_best : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    r.e[k] = inside ? pos[k]
                    : clamp_unit(__fadd_rn(__fmul_rn(r.d[k], u_final), pos[k]));
  return inside || hit;
}

// step s of a ray: its taps and whether it lies in the box
struct Sample {
  dxv::Axis x, y, z;
  bool inside;
};

__device__ __forceinline__ Sample sample_at(const Ray& r, int s, float step,
                                            int n) {
  const float o = __fmul_rn(static_cast<float>(s), step);  // sample_offsets
  const float px = __fadd_rn(r.e[0], __fmul_rn(r.d[0], o));
  const float py = __fadd_rn(r.e[1], __fmul_rn(r.d[1], o));
  const float pz = __fadd_rn(r.e[2], __fmul_rn(r.d[2], o));
  Sample p;
  p.inside = dxv::in_box(px, py, pz);
  p.x = dxv::axis_taps(dxv::to_tex(0.5f, px), n);
  p.y = dxv::axis_taps(dxv::to_tex(-0.5f, py), n);
  p.z = dxv::axis_taps(dxv::to_tex(0.5f, pz), n);
  return p;
}

// the march from r.e along r.d and the composite -> rgb
__device__ __forceinline__ void march(const float* __restrict__ density,
                                      const float* __restrict__ light, int n,
                                      int n_samples, const Camera& c,
                                      const Ray& r, float* __restrict__ out) {
  float transmit = 1.0f;
  float scatter = 0.0f;
  for (int s0 = 0; s0 < n_samples; s0 += kK) {
    // issue: the batch's positions and density taps, before any break test
    dxv::Taps taps[kK];
    float fx[kK], fy[kK], fz[kK];
    bool inside[kK];
#pragma unroll
    for (int b = 0; b < kK; ++b) {
      const Sample p = sample_at(r, s0 + b, c.step, n);
      inside[b] = p.inside;
      // a step outside the box ends the march: its taps are not loaded
      taps[b] = p.inside ? dxv::load_taps(density, n, p.x, p.y, p.z)
                         : dxv::Taps{};
      fx[b] = p.x.f;
      fy[b] = p.y.f;
      fz[b] = p.z.f;
    }
    // apply: the breaks in step order; values past a break are discarded
    bool done = false;
#pragma unroll
    for (int b = 0; b < kK; ++b) {
      if (s0 + b >= n_samples || !inside[b]) {
        done = true;
        break;
      }
      const float dens =
          dxv::scale_sample(dxv::combine(taps[b], fx[b], fy[b], fz[b]));
      if (!(dens > kZeroThreshold)) continue;
      const float sigma = __fmul_rn(dens, c.step);
      const float att = fminf(fmaxf(__fsub_rn(1.0f, sigma), 0.0f), 1.0f);
      transmit = __fmul_rn(transmit, att);
      // the shader breaks BEFORE accumulating scatter (PSRayCast.hlsl:147-148)
      if (transmit < kZeroThreshold) {
        done = true;
        break;
      }
      // the light tap's position again (fewer registers than keeping it)
      const Sample p = sample_at(r, s0 + b, c.step, n);
      const float lt = dxv::trilinear(light, n, p.x, p.y, p.z);
      scatter = __fadd_rn(scatter, __fmul_rn(__fmul_rn(lt, transmit), sigma));
    }
    if (done) break;
  }
  const float res = __fadd_rn(__fmul_rn(scatter, 0.8f), 0.2f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float cc2 = __fmul_rn(c.clear[k], c.clear[k]);
    out[k] =
        __fsqrt_rn(__fadd_rn(res, __fmul_rn(__fsub_rn(cc2, res), transmit)));
  }
}

// a block is a 16 x 16 tile and a warp 8 x 4 pixels of it; one pixel per
// thread
__global__ void __launch_bounds__(kThreads)
gather_march_kernel(const float* __restrict__ density,
                    const float* __restrict__ light, float* __restrict__ rgb,
                    const Camera c, int n, int width, int height,
                    int n_samples) {
  const int tiles_x = (width + kTile - 1) / kTile;
  const int t = threadIdx.x, w = t / 32;
  const int px = (blockIdx.x % tiles_x) * kTile + (w % 2) * 8 + t % 8;
  const int py = (blockIdx.x / tiles_x) * kTile + (w / 2) * 4 + (t / 8) % 4;
  if (px >= width || py >= height) return;
  float* out = rgb + 3 * (static_cast<size_t>(py) * width + px);
  Ray r;
  if (!setup_ray(c, px, py, r)) {
    // misses return the clear color (PSRayCast.hlsl:121)
    out[0] = c.clear[0];
    out[1] = c.clear[1];
    out[2] = c.clear[2];
    return;
  }
  march(density, light, n, n_samples, c, r, out);
}

}  // namespace

// camera: kCameraFloats host floats (screen_to_local row-major, eye, clear,
// y_offset, step), read here and passed to the kernel by value
extern "C" int dxv_gather_march(const void* density, const void* light,
                                void* rgb, const float* camera, int n,
                                int width, int height, int n_samples,
                                void* stream) {
  if (width <= 0 || height <= 0) return 0;
  static_assert(sizeof(Camera) == kCameraFloats * sizeof(float), "layout");
  Camera c;
  const float* src = camera;
  for (int i = 0; i < 16; ++i) c.m[i] = *src++;
  for (int i = 0; i < 3; ++i) c.eye[i] = *src++;
  for (int i = 0; i < 3; ++i) c.clear[i] = *src++;
  c.y_offset = *src++;
  c.step = *src++;
  const unsigned blocks = static_cast<unsigned>(
      ((width + kTile - 1) / kTile) * ((height + kTile - 1) / kTile));
  gather_march_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(density), static_cast<const float*>(light),
      static_cast<float*>(rgb), c, n, width, height, n_samples);
  return static_cast<int>(cudaGetLastError());
}
