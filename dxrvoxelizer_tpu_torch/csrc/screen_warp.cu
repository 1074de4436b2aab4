// Screen resolve of the shear-warp renderer, with the screen mapping and
// the final composite fused in (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/screen_warp_pallas.py::_resolve_kernel
// (launched by bilinear_resolve). Same computation: each screen pixel
// bilinearly samples the composited scatter and transmit intermediates
// ([M, M] f32) at (gi_x, gi_y), clamp-to-edge at M-1 like
// raymarch_warp._bilinear_take. Fused here, per pixel: the screen mapping
// of raymarch_warp.screen_coords (the homogeneous transform by
// screen_to_local, the normalised ray direction, the ComputeStartPoint slab
// test of PSRayCast.hlsl:71-98, the permuted and flipped tex-space
// direction and its intersection with the reference plane -> gi_x, gi_y,
// ok), the swap of the intermediate axes, and the final composite of
// raymarch_warp._shearwarp_core (base = 0.8*scatter + 0.2, lerp to the
// squared clear colour by clip(transmit, 0, 1), sqrt, clear colour where
// the pixel misses the volume), written as [H, W, 3].
//
// What bounds it on the card: device-memory bytes. The two [M, M]
// intermediates are read once (64 KB each at M = 128; they stay in L1/L2,
// and neighbouring pixels read neighbouring texels) and 12 bytes per pixel
// are written; the operations (the mapping's for every pixel, the taps,
// samples and composite for the hit pixels) take a fraction of that time.
// The first port read per-pixel coordinates and a mask (9 more bytes per
// pixel) that about 140 elementwise torch operations and two transposes of
// the intermediates computed first, each a launch and a round trip through
// device memory; the TPU kernel takes coordinates because its 32x32 block
// tiling (raymarch_warp._to_blocks) needed them.
//
// A band of the image (a rank's share of a sharded frame, parallel/) is the
// launch over `height` rows from screen row `y_off`: its pixels equal those
// rows of the whole image bit for bit.
//
// Design: one thread per pixel in 32x8 blocks; the per-frame constants come
// by value. The mapping is scalarised in screen_coords' order with __f*_rn
// intrinsics, so nothing contracts into an FMA and every rounding is the one
// PyTorch's CUDA elementwise kernels make: the mask and the coordinates equal
// the plain path's bit for bit (one flipped mask bit at the silhouette would
// move a pixel by the whole clear-colour distance). `swap` exchanges
// (gi_x, gi_y) and reads the untransposed intermediates transposed (the
// strides swap). The taps are plain FP32 loads (not the texture unit, whose
// fixed-point filter weights would move pixels); the weights and the
// composite follow the plain torch expressions in order. The coordinates
// and the mask are written only when the caller passes buffers for them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr float kBig = 3.402823466e38f;  // FLT_MAX: "no hit yet"

// The per-frame constants.
struct ScreenParams {
  float s2l[16];  // screen_to_local, row-major
  float eye[3];   // eye in local space
  float tex[3];   // TEX_SCALE[perm[c]]
  int perm[3];    // the march axis last
  int flip, swap, m, width, height;
  int y_off, pad_;  // first screen row of the band (0: the whole image)
  float e_x, e_y, c_ref, gmin_x, gmin_y, gext_x, gext_y;
  float clear[3];
};
static_assert(sizeof(ScreenParams) == 168, "layout packed by the wrapper");

// Everything one launch takes, packed by ops/screen_warp_cuda.py in this
// order into one host buffer (one argument to cross from Python).
struct ResolveArgs {
  const float* scatter;   // [m, m], untransposed
  const float* transmit;  // [m, m]
  float* out;             // [height, width, 3]
  float* gi_x;            // [height * width] or null
  float* gi_y;            // [height * width] or null
  uint8_t* ok;            // [height * width] (bool) or null
  void* stream;
  ScreenParams p;
};
static_assert(sizeof(ResolveArgs) == 224, "layout packed by the wrapper");

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float pick(const float (&v)[3], int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

struct Bilinear {
  int a00, a10, a01, a11;
  float fx, fy;
};

// taps of img[x, y] with img[x, y] at x*sx + y*sy (sx, sy = m, 1, or 1, m
// for the transposed read)
__device__ __forceinline__ Bilinear setup(float x, float y, int m, int sx,
                                          int sy) {
  const float hi = static_cast<float>(m - 1);
  const int x0 = static_cast<int>(fminf(fmaxf(floorf(x), 0.0f), hi));
  const int y0 = static_cast<int>(fminf(fmaxf(floorf(y), 0.0f), hi));
  const int x1 = min(x0 + 1, m - 1);
  const int y1 = min(y0 + 1, m - 1);
  Bilinear b;
  // fractions from the *clamped* base texel (edge-clamp semantics)
  b.fx = fminf(fmaxf(sub(x, static_cast<float>(x0)), 0.0f), 1.0f);
  b.fy = fminf(fmaxf(sub(y, static_cast<float>(y0)), 0.0f), 1.0f);
  b.a00 = x0 * sx + y0 * sy;
  b.a10 = x1 * sx + y0 * sy;
  b.a01 = x0 * sx + y1 * sy;
  b.a11 = x1 * sx + y1 * sy;
  return b;
}

// v00*(1-fx)*(1-fy) + v10*fx*(1-fy) + v01*(1-fx)*fy + v11*fx*fy, left to right
__device__ __forceinline__ float sample(const float* __restrict__ img,
                                        const Bilinear& b) {
  const float gx = sub(1.0f, b.fx);
  const float gy = sub(1.0f, b.fy);
  float v = mul(mul(img[b.a00], gx), gy);
  v = add(v, mul(mul(img[b.a10], b.fx), gy));
  v = add(v, mul(mul(img[b.a01], gx), b.fy));
  v = add(v, mul(mul(img[b.a11], b.fx), b.fy));
  return v;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
resolve_screen_kernel(const float* __restrict__ scatter,
                      const float* __restrict__ transmit,
                      float* __restrict__ out, float* __restrict__ gx_out,
                      float* __restrict__ gy_out, uint8_t* __restrict__ ok_out,
                      const ScreenParams p) {
  const int col = blockIdx.x * kBlockX + threadIdx.x;
  const int row = blockIdx.y * kBlockY + threadIdx.y;
  if (col >= p.width || row >= p.height) return;
  const size_t idx = static_cast<size_t>(row) * p.width + col;

  // ---- the mapping, in screen_coords' order -------------------------------
  // arange + 0.5 (exact), then the band's first row added in float32, as
  // the JAX package's band render does (sy + y_off; exact below 2^23)
  const float px = static_cast<float>(col) + 0.5f;
  const float py = add(static_cast<float>(row) + 0.5f,
                       static_cast<float>(p.y_off));
  float h[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    h[c] = add(add(mul(px, p.s2l[c]), mul(py, p.s2l[4 + c])), p.s2l[12 + c]);
  float pn[3], d[3], dn[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pn[c] = quo(h[c], h[3]);
    d[c] = sub(pn[c], p.eye[c]);
  }
  const float d_len =
      __fsqrt_rn(add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2])));
#pragma unroll
  for (int c = 0; c < 3; ++c) dn[c] = quo(d[c], d_len);

  // ComputeStartPoint: inside the box, or the nearest face hit ahead
  const bool inside =
      fabsf(pn[0]) <= 1.0f && fabsf(pn[1]) <= 1.0f && fabsf(pn[2]) <= 1.0f;
  float u_best = kBig;
  bool hit = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, k = (i + 2) % 3;
    const float di = dn[i];
    const float sgn = di > 0.0f ? 1.0f : (di < 0.0f ? -1.0f : 0.0f);
    const float u = di != 0.0f ? quo(sub(-sgn, pn[i]), di) : kBig;
    const bool okc = u >= 0.0f && fabsf(add(mul(dn[j], u), pn[j])) <= 1.0f &&
                     fabsf(add(mul(dn[k], u), pn[k])) <= 1.0f && u < u_best;
    if (okc) u_best = u;
    hit = hit || okc;
  }

  // tex-space direction, the march axis last, and the reference plane
  const float dt0 = mul(pick(dn, p.perm[0]), p.tex[0]);
  const float dt1 = mul(pick(dn, p.perm[1]), p.tex[1]);
  float dz = mul(pick(dn, p.perm[2]), p.tex[2]);
  if (p.flip) dz = -dz;
  const bool valid = fabsf(dz) > 1e-6f;
  const float safe_dz = valid ? dz : 1.0f;
  const float g_px = add(quo(mul(dt0, p.c_ref), safe_dz), p.e_x);
  const float g_py = add(quo(mul(dt1, p.c_ref), safe_dz), p.e_y);
  // PyTorch's CUDA true division by a CPU scalar multiplies by the scalar's
  // float32 reciprocal (BinaryDivTrueKernel.cu), so `/ gext` does the same
  const float fm = static_cast<float>(p.m);
  const float gi_x = sub(mul(mul(sub(g_px, p.gmin_x), quo(1.0f, p.gext_x)), fm), 0.5f);
  const float gi_y = sub(mul(mul(sub(g_py, p.gmin_y), quo(1.0f, p.gext_y)), fm), 0.5f);
  const bool ok = (inside || hit) && valid;
  if (gx_out) gx_out[idx] = gi_x;
  if (gy_out) gy_out[idx] = gi_y;
  if (ok_out) ok_out[idx] = ok;

  // ---- resolve + composite ------------------------------------------------
  float* o = out + idx * 3;
  if (!ok) {  // miss: the clear colour (PSRayCast.hlsl:121)
    o[0] = p.clear[0];
    o[1] = p.clear[1];
    o[2] = p.clear[2];
    return;
  }
  // swap: intermediate rows track screen rows, so (x, y) = (gi_y, gi_x) on
  // the transposed intermediates
  const Bilinear b = p.swap ? setup(gi_y, gi_x, p.m, 1, p.m)
                            : setup(gi_x, gi_y, p.m, p.m, 1);
  const float sc = sample(scatter, b);
  const float tr = sample(transmit, b);
  const float base = add(mul(sc, 0.8f), 0.2f);
  const float trc = fminf(fmaxf(tr, 0.0f), 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float cc = mul(p.clear[c], p.clear[c]);
    const float res = add(base, mul(sub(cc, base), trc));
    o[c] = __fsqrt_rn(fmaxf(res, 0.0f));
  }
}

}  // namespace

// args: a ResolveArgs on the host.
extern "C" int dxv_resolve_screen(const void* args) {
  const ResolveArgs& a = *static_cast<const ResolveArgs*>(args);
  const ScreenParams& p = a.p;
  if (p.m < 1 || p.width < 0 || p.height < 0 || p.perm[0] < 0 ||
      p.perm[0] > 2 || p.perm[1] < 0 || p.perm[1] > 2 || p.perm[2] < 0 ||
      p.perm[2] > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.width == 0 || p.height == 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p.width + kBlockX - 1) / kBlockX,
                  (p.height + kBlockY - 1) / kBlockY);
  resolve_screen_kernel<<<grid, block, 0, static_cast<cudaStream_t>(a.stream)>>>(
      a.scatter, a.transmit, a.out, a.gi_x, a.gi_y, a.ok, p);
  return static_cast<int>(cudaGetLastError());
}
