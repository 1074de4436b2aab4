// Fused shear-warp march: z-mix, bilinear warp and front-to-back
// compositing of every sub-slab, per intermediate pixel (Hopper).
//
// Replaces: dxrvoxelizer_tpu/ops/march_pallas.py::_march_kernel (launched
// by march_pallas). Same computation: sub-slab s of KS = K*ss z-mixes the
// (density, light) slabs z0(s), z1(s) with weight wts[s], warps them to the
// M x M intermediate, and updates transmit/scatter with the shader's
// absorption (g = min(8d, 16), sigma = g*delta, early-out at 0.01, near-clip
// mask front[s]). The TPU kernel warps with two dense [M,N]x[N,N] matmuls
// per sub-slab because its matrix unit is the fast path; the matrices are
// 2-tap interpolation rows (ops/warp.py interp_matrix), so here the warp is
// a 4-tap bilinear read per pixel, with the two weights rebuilt from each
// sub-slab's scale/offset exactly as interp_matrix builds them.
//
// What bounds it on the card: a latency chain, before this design. The
// first port ran one thread per pixel in 16x16 blocks; each thread walked
// all KS sub-slabs with 16 scalar loads per step from L1/L2 (2 channels x
// 2 z-slabs x 4 taps) and a loop exit that depends on transmit, so step
// s+1's loads never issued before step s was done. M = 128 gave 16,384
// threads in 64 blocks on 132 SMs, and its time followed KS and stayed flat
// in M (PERF.md, Findings: the march's diagnosis). The work itself is bound by operations at
// 64^3 (the slab stack is 2 MB) and by bytes at 256^3 (the 134 MB stack,
// read once, exceeds the 50 MB L2).
//
// Design: a block owns an 8x8 tile of intermediate pixels and has 256
// threads (256 blocks at M = 128, two per SM). It walks the source slabs in
// chunks of CZ (4): a chunk holds the sub-slabs whose first slab z0 lies in
// it, and reads slabs [c*CZ, c*CZ + CZ] (one more for the z-mix). The
// chunk's texel box for the tile is the union over its sub-slabs of the
// taps' ranges (per axis, from the floor of the tile's first pixel's
// coordinate to the floor of its last pixel's plus one: coordinates are
// monotone in the pixel index), so each slab is staged once per tile, not
// once per sub-slab. One thread loads the box of the chunk's slabs into a
// two-stage shared-memory ring with two TMA box loads (density and light,
// fx x fy4 x (CZ+1) texels each, box columns from a multiple of 4) that
// complete on the stage's mbarrier, one chunk ahead of its use. The box
// size is the largest of the launch, which the host knows without a device
// sync (ops/march_cuda.march_footprint); a chunk whose box does not fit is
// read from global memory instead. Per chunk, phase A: every thread
// samples (d_w, l_w) of two (pixel, sub-slab) pairs from shared memory with
// the first port's expressions, through tap tables (each tile row's and
// column's two offsets and weights per sub-slab); phase B: one thread per
// pixel runs the composite over the chunk's sub-slabs in order, so every
// pixel's result is the same chain of operations as before, while the
// other warps build the next chunk's tap tables. After each chunk the block
// stops once every pixel's transmit is below 0.01 (__syncthreads_or).
// Everything stays FP32. Per-thread cp.async copies (16 bytes each) and
// one bulk copy per box row were tried first: issuing them took most of the
// block's time (PERF.md, Findings: what was hard).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace {

constexpr float kAbsorption = 1.0f;     // PSRayCast.hlsl:9
constexpr float kZeroThreshold = 0.01f;  // PSRayCast.hlsl:10
constexpr int kTile = 8;                 // ops/march_cuda.py TILE
constexpr int kPixels = kTile * kTile;
constexpr int kThreads = 256;            // 4 per pixel in phase A
constexpr int kMaxSs = 6;                // z-supersampling the kernel takes
constexpr int kMaxSmem = 227 * 1024;     // dynamic shared memory per block

struct Taps {
  int i0, i1;    // clamped read indices
  float w0, w1;  // interpolation weights (0 outside the volume)
};

// interp_matrix row for output texel `o` under coord = scale*(o+0.5)+offset
__device__ __forceinline__ Taps taps(float scale, float offset, int o, int n) {
  const float c = __fadd_rn(__fmul_rn(scale, static_cast<float>(o) + 0.5f),
                            offset);
  const float c0 = floorf(c);
  const float f = __fsub_rn(c, c0);
  const int i0 = static_cast<int>(c0);
  const int i1 = i0 + 1;
  Taps t;
  t.w0 = (i0 >= 0 && i0 <= n - 1) ? __fsub_rn(1.0f, f) : 0.0f;
  t.w1 = (i1 >= 0 && i1 <= n - 1) ? f : 0.0f;
  t.i0 = min(max(i0, 0), n - 1);
  t.i1 = min(max(i1, 0), n - 1);
  return t;
}

// texels [lo, hi] that the clamped taps of outputs o_a..o_b can read
__device__ __forceinline__ void span(float scale, float offset, int o_a,
                                     int o_b, int n, int& lo, int& hi) {
  const int fa = static_cast<int>(floorf(__fadd_rn(
      __fmul_rn(scale, static_cast<float>(o_a) + 0.5f), offset)));
  const int fb = static_cast<int>(floorf(__fadd_rn(
      __fmul_rn(scale, static_cast<float>(o_b) + 0.5f), offset)));
  lo = min(max(min(fa, fb), 0), n - 1);
  hi = min(max(max(fa, fb) + 1, 0), n - 1);
}

// floor((2s + 1 - ss) / (2ss)) clipped to [0, kn-1] (march_pallas.py:129-139)
__host__ __device__ __forceinline__ int first_slab(int s, int ss, int kn) {
  const int num = 2 * s + 1 - ss;
  const int den = 2 * ss;
  const int q = num >= 0 ? num / den : -((-num + den - 1) / den);
  return min(max(q, 0), kn - 1);
}

// the first sub-slab whose first slab is >= z (z0 is monotone in s)
__host__ __device__ __forceinline__ int sub_begin(int z, int ss, int ks) {
  return z == 0 ? 0 : min(ks, ss * z + ss / 2);
}

// A step's taps along one axis for one row (x) or column (y) of the tile:
// the two read offsets within the chunk's planes and their weights.
struct __align__(16) TapEntry {
  int a0, a1;
  float w0, w1;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarrier and bulk-copy (TMA) primitives, sm_90
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// one box of the 4-D tensor `tmap` ([2, kn, n, n] slabs, innermost first
// in the coordinates) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(float* dst, const CUtensorMap* tmap,
                                            int y, int x, int z, int ch,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(tmap)), "r"(y), "r"(x), "r"(z),
      "r"(ch), "r"(smem_addr(bar))
      : "memory");
}

// (d_w, l_w) of one (pixel, sub-slab): the 16 texels (4 taps of density and
// light at z0, and at z1 when z-mixing), the z-LERP (the XLA order), then
// (wx @ slab) then (@ wy^T): x taps first, then y taps
__device__ __forceinline__ float2 sample(const float* __restrict__ d0,
                                         const float* __restrict__ l0,
                                         const float* __restrict__ d1,
                                         const float* __restrict__ l1,
                                         const TapEntry& tx,
                                         const TapEntry& ty, bool zmix,
                                         float w) {
  // offsets of (i0, j0), (i0, j1), (i1, j0), (i1, j1)
  const int a[4] = {tx.a0 + ty.a0, tx.a0 + ty.a1, tx.a1 + ty.a0,
                    tx.a1 + ty.a1};
  float d[4], l[4];
  if (!zmix) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      d[t] = d0[a[t]];
      l[t] = l0[a[t]];
    }
  } else {
    const float u = 1.0f - w;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      d[t] = d0[a[t]] * u + d1[a[t]] * w;
      l[t] = l0[a[t]] * u + l1[a[t]] * w;
    }
  }
  const float d00 = d[0], d01 = d[1], d10 = d[2], d11 = d[3];
  const float l00 = l[0], l01 = l[1], l10 = l[2], l11 = l[3];
  const float dy0 = tx.w0 * d00 + tx.w1 * d10;
  const float dy1 = tx.w0 * d01 + tx.w1 * d11;
  const float d_w = dy0 * ty.w0 + dy1 * ty.w1;
  const float ly0 = tx.w0 * l00 + tx.w1 * l10;
  const float ly1 = tx.w0 * l01 + tx.w1 * l11;
  const float l_w = ly0 * ty.w0 + ly1 * ty.w1;
  return make_float2(d_w, l_w);
}

// Shared-memory layout in float4 units (the host sizes it the same way):
// the ring stages' mbarriers; per sub-slab (scale_x, off_x, scale_y, off_y)
// and (wts, front); per chunk its box; two stages of tap tables and slab
// offsets; the (d_w, l_w) of one chunk; then the ring, 128-byte aligned.
struct Layout {
  int bars, warp_p, comp_p, boxes, tabs, info, wl, ring;
  __host__ __device__ Layout(int ks, int nc, int nsub) {
    bars = 0;  // one mbarrier per ring stage
    warp_p = 1;
    comp_p = warp_p + ks;
    boxes = comp_p + (ks + 1) / 2;
    tabs = boxes + nc;
    info = tabs + 2 * nsub * 2 * kTile;
    wl = info + (2 * nsub + 1) / 2;
    ring = (wl + nsub * kPixels / 2 + 7) / 8 * 8;
  }
};

// floats of one channel's block of a ring stage: nslab planes of fx x fy4,
// padded to 128 bytes (each block is one TMA box)
__host__ __device__ inline int channel_block(int nslab, int fx, int fy4) {
  return (nslab * fx * fy4 + 31) / 32 * 32;
}

// the most sub-slabs of any chunk
__host__ __device__ inline int max_subslabs(int kn, int ss, int cz) {
  const int ks = kn * ss;
  int most = 0;
  for (int z = 0; z < kn; z += cz) {
    const int e = z + cz >= kn ? ks : sub_begin(z + cz, ss, ks);
    most = max(most, e - sub_begin(z, ss, ks));
  }
  return most;
}

__global__ void __launch_bounds__(kThreads, 2)
march_kernel(const __grid_constant__ CUtensorMap tmap,
             const float* __restrict__ slabs, const float* __restrict__ wts,
             const float* __restrict__ front,
             const float* __restrict__ scale_x, const float* __restrict__ off_x,
             const float* __restrict__ scale_y, const float* __restrict__ off_y,
             const float* __restrict__ delta, float* __restrict__ transmit_out,
             float* __restrict__ scatter_out, int kn, int n, int m, int ss,
             int cz, int fx, int fy4, int nsub) {
  const int ks = kn * ss;
  const int nc = (kn + cz - 1) / cz;
  const bool zmix = ss > 1;
  const int nslab = cz + (zmix ? 1 : 0);  // slabs a chunk stages
  const int plane_sz = fx * fy4;
  const int ch_sz = channel_block(nslab, fx, fy4);
  const int stage_sz = 2 * ch_sz;
  const Layout lay(ks, nc, nsub);
  extern __shared__ __align__(128) float4 smem4[];
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem4 + lay.bars);
  float4* warp_p = smem4 + lay.warp_p;
  float2* comp_p = reinterpret_cast<float2*>(smem4 + lay.comp_p);
  int4* boxes = reinterpret_cast<int4*>(smem4 + lay.boxes);  // x0 y0 rows q
  TapEntry* tabs = reinterpret_cast<TapEntry*>(smem4 + lay.tabs);
  int2* info = reinterpret_cast<int2*>(smem4 + lay.info);
  float2* wl = reinterpret_cast<float2*>(smem4 + lay.wl);
  float* ring = reinterpret_cast<float*>(smem4 + lay.ring);

  const int ti0 = blockIdx.y * kTile;  // intermediate rows (x)
  const int tj0 = blockIdx.x * kTile;  // intermediate columns (y)
  const int ti1 = min(ti0 + kTile, m) - 1;
  const int tj1 = min(tj0 + kTile, m) - 1;
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(n) * n;
  const size_t light_off = static_cast<size_t>(kn) * plane;

  // ---- prologue: sub-slab parameters and every chunk's box --------------
  for (int s = tid; s < ks; s += kThreads) {
    warp_p[s] = make_float4(scale_x[s], off_x[s], scale_y[s], off_y[s]);
    comp_p[s] = make_float2(zmix ? wts[s] : 0.0f, front[s]);
  }
  for (int c = tid; c < nc; c += kThreads) {
    const int sb = sub_begin(c * cz, ss, ks);
    const int se = c == nc - 1 ? ks : sub_begin((c + 1) * cz, ss, ks);
    int xl = n, xh = -1, yl = n, yh = -1;
    for (int s = sb; s < se; ++s) {
      int lo, hi;
      span(scale_x[s], off_x[s], ti0, ti1, n, lo, hi);
      xl = min(xl, lo);
      xh = max(xh, hi);
      span(scale_y[s], off_y[s], tj0, tj1, n, lo, hi);
      yl = min(yl, lo);
      yh = max(yh, hi);
    }
    const int y0 = yl & ~3;
    boxes[c] = make_int4(xl, y0, xh - xl + 1, (yh + 1 - y0 + 3) >> 2);
  }
  // the pixel of phase B's threads
  const int i = ti0 + tid / kTile;
  const int j = tj0 + tid % kTile;
  const bool active = tid < kPixels && i < m && j < m;
  const float dl = active ? delta[i * m + j] : 0.0f;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto staged = [&](int c) {
    const int4 b = boxes[c];
    return b.z <= fx && 4 * b.w <= fy4;
  };
  // chunk c's box of the nslab slabs from c*cz, density and light (two TMA
  // boxes of fx x fy4 x nslab; rows past the grid read as zeros and are never
  // sampled) into ring stage st, by one thread
  auto load = [&](int c, int st) {
    const bool ok = staged(c);
    mbar_arrive_expect_tx(&bars[st], ok ? 2u * nslab * plane_sz * 4u : 0u);
    if (!ok) return;
    const int4 b = boxes[c];
    float* dst = ring + static_cast<size_t>(st) * stage_sz;
    tma_load_4d(dst, &tmap, b.y, b.x, c * cz, 0, &bars[st]);
    tma_load_4d(dst + ch_sz, &tmap, b.y, b.x, c * cz, 1, &bars[st]);
  };
  // chunk c's tap tables (each tile row's and column's two offsets and
  // weights per sub-slab, into the staged box, or into the global planes
  // when the box does not fit) and slab offsets into stage st, by the
  // threads t0.. of the block
  auto tables = [&](int c, int st, int t0) {
    const int4 b = boxes[c];
    const bool ok = staged(c);
    const int sb = sub_begin(c * cz, ss, ks);
    const int se = c == nc - 1 ? ks : sub_begin((c + 1) * cz, ss, ks);
    for (int e = tid - t0; e < (se - sb) * 2 * kTile; e += kThreads - t0) {
      const int k = e / (2 * kTile), r = e % (2 * kTile);
      const int s = sb + k;
      const float4 wp = warp_p[s];
      Taps t;
      int org, stride;
      if (r < kTile) {
        t = taps(wp.x, wp.y, min(ti0 + r, ti1), n);
        org = ok ? b.x : 0;
        stride = ok ? fy4 : n;
      } else {
        t = taps(wp.z, wp.w, min(tj0 + r - kTile, tj1), n);
        org = ok ? b.y : 0;
        stride = 1;
      }
      TapEntry te;
      te.a0 = (t.i0 - org) * stride;
      te.a1 = (t.i1 - org) * stride;
      te.w0 = t.w0;
      te.w1 = t.w1;
      tabs[(st * nsub + k) * 2 * kTile + r] = te;
      if (r == 0) {
        const int z0 = zmix ? first_slab(s, ss, kn) : s;
        const int z1 = min(z0 + 1, kn - 1);
        // staged: slab z's density plane at (z - c*cz) * plane_sz, its
        // light plane one channel block later; else the slab indices
        info[st * nsub + k] =
            ok ? make_int2((z0 - c * cz) * plane_sz, (z1 - c * cz) * plane_sz)
               : make_int2(z0, z1);
      }
    }
  };

  if (tid == 0) load(0, 0);
  tables(0, 0, 0);
  __syncthreads();

  float transmit = 1.0f;
  float scatter = 0.0f;
  int c = 0;
  for (; c < nc; ++c) {
    const int st = c & 1;
    // the next chunk's box is in flight while this one is used; its stage
    // was last read by phase A of chunk c - 1, before the barriers since
    if (tid == 0 && c + 1 < nc) load(c + 1, st ^ 1);
    mbar_wait(&bars[st], (c >> 1) & 1);  // chunk c's box has landed
    const bool ok = staged(c);
    const int sb = sub_begin(c * cz, ss, ks);
    const int ns = (c == nc - 1 ? ks : sub_begin((c + 1) * cz, ss, ks)) - sb;

    // phase A: (d_w, l_w) of every (pixel, sub-slab) of the chunk, two per
    // thread at a time so that their loads overlap; a pixel outside a
    // slab's footprint gets zero weights and d_w = 0
    const int pa = tid % kPixels;
    const int py = min(ti0 + pa / kTile, ti1) - ti0;  // idle pixels clamp
    const int px = min(tj0 + pa % kTile, tj1) - tj0;
    const float* stage = ring + static_cast<size_t>(st) * stage_sz;
    auto pair = [&](int k) {
      const TapEntry tx = tabs[(st * nsub + k) * 2 * kTile + py];
      const TapEntry ty = tabs[(st * nsub + k) * 2 * kTile + kTile + px];
      const int2 zo = info[st * nsub + k];
      const float w = comp_p[sb + k].x;
      if (ok)
        return sample(stage + zo.x, stage + ch_sz + zo.x, stage + zo.y,
                      stage + ch_sz + zo.y, tx, ty, zmix, w);
      const float* d0 = slabs + static_cast<size_t>(zo.x) * plane;
      const float* d1 = slabs + static_cast<size_t>(zo.y) * plane;
      return sample(d0, d0 + light_off, d1, d1 + light_off, tx, ty, zmix, w);
    };
    constexpr int kStride = kThreads / kPixels;
    for (int k = tid / kPixels; k < ns; k += 2 * kStride) {
      const float2 v0 = pair(k);
      if (k + kStride < ns) {
        const float2 v1 = pair(k + kStride);
        wl[(k + kStride) * kPixels + pa] = v1;
      }
      wl[k * kPixels + pa] = v0;
    }
    __syncthreads();

    // phase B: the composite of each pixel over the chunk's sub-slabs, in
    // order (raymarch_warp._shearwarp_core's step), while its transmit has
    // not died (the shader's loop condition); only transmit and scatter
    // chain from step to step. Meanwhile the other warps build the next
    // chunk's tap tables.
    if (active) {
#pragma unroll 4
      for (int k = 0; k < ns; ++k) {
        const float2 v = wl[k * kPixels + tid];
        const float d_w = v.x, l_w = v.y;
        const float g_s = fminf(d_w * 8.0f, 16.0f);
        const bool occupied =
            (g_s > kZeroThreshold) && (comp_p[sb + k].y > 0.0f);
        const float sigma = g_s * dl;
        const float att =
            occupied ? fminf(fmaxf(1.0f - sigma * kAbsorption, 0.0f), 1.0f)
                     : 1.0f;
        const float new_transmit = transmit * att;
        if (transmit >= kZeroThreshold) {
          if (occupied && new_transmit >= kZeroThreshold)
            scatter += l_w * new_transmit * sigma;
          transmit = new_transmit;
        }
      }
    } else if (tid >= kPixels && c + 1 < nc) {
      tables(c + 1, st ^ 1, kPixels);
    }
    // the block stops once every pixel's transmit has died; the barrier also
    // publishes the next chunk's tables and frees the (d_w, l_w) buffer
    if (!__syncthreads_or(active && transmit >= kZeroThreshold)) break;
  }
  // no copy may land after the block has left: after an early stop, wait
  // for the chunk in flight
  if (c + 1 < nc) mbar_wait(&bars[(c + 1) & 1], ((c + 1) >> 1) & 1);
  if (active) {
    transmit_out[i * m + j] = transmit;
    scatter_out[i * m + j] = scatter;
  }
}

}  // namespace

// slabs [2, kn, n, n] (density, light; far axis first; n a multiple of 4,
// 16-byte aligned); wts, front, scale_x, off_x, scale_y, off_y [kn*ss];
// delta [m, m]; transmit, scatter [m, m]; cz source slabs per chunk; (fx,
// fy4) the ring slot: the largest chunk box of any tile, columns a multiple
// of 4.
extern "C" int dxv_march(const float* slabs, const float* wts,
                         const float* front, const float* scale_x,
                         const float* off_x, const float* scale_y,
                         const float* off_y, const float* delta,
                         float* transmit, float* scatter, int kn, int n, int m,
                         int ss, int cz, int fx, int fy4, void* stream) {
  if (kn < 1 || n < 1 || n % 4 || m < 1 || ss < 1 || ss > kMaxSs || cz < 1 ||
      fx < 0 || fy4 < 0 || fy4 % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (!encode) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e2 = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    if (q != cudaDriverEntryPointSuccess || !fn)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const int ks = kn * ss;
  const int nc = (kn + cz - 1) / cz;
  const int nsub = max_subslabs(kn, ss, cz);
  const int nslab = cz + (ss > 1 ? 1 : 0);
  const size_t meta = static_cast<size_t>(Layout(ks, nc, nsub).ring) * 16;
  size_t smem = meta + 2 * 2 * static_cast<size_t>(
                                   channel_block(nslab, fx, fy4)) * 4;
  if (smem > static_cast<size_t>(kMaxSmem) || nslab > 256 || fx > 256 ||
      fy4 > 256) {  // (a TMA box is at most 256 per axis)
    fx = fy4 = 0;  // read every box from global memory
    smem = meta;
  }
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmap = {};
  if (fx > 0 && fy4 > 0) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(kn), 2};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(n) * 4, static_cast<cuuint64_t>(n) * n * 4,
        static_cast<cuuint64_t>(kn) * n * n * 4};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(fy4),
                               static_cast<cuuint32_t>(fx),
                               static_cast<cuuint32_t>(nslab), 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(
        &tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(slabs),
        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  march_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tmap, slabs, wts, front, scale_x, off_x, scale_y, off_y, delta,
      transmit, scatter, kn, n, m, ss, cz, fx, fy4, nsub);
  return static_cast<int>(cudaGetLastError());
}
