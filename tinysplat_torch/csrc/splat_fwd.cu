// S1: the splat-input layer's forward, one thread per splat slot.
//
// Replaces what XLA fuses inside the JAX package's jitted render
// (tinysplat_tpu/render.py:139-169): project_gaussians
// (tinysplat_tpu/ops/projection.py:170), eval_sh (tinysplat_tpu/ops/sh.py:127),
// the +0.5 shift and clamp at 0, sigmoid opacities and the Mip-Splatting
// compensation. Its plain version is splat_fwd_plain
// (tinysplat_torch/ops/splat_inputs_cuda.py), which the port ran as a few
// hundred elementwise launches.
//
// Bound: bytes. A splat reads 12 + 12 + 16 + 12 K + 4 + 1 bytes (means,
// log-scales, quats, K SH coefficients of 3 channels, logit, alive) and
// writes 53 (xys, depth, radius, conic, tile count, valid, colors4,
// opacity) for a few hundred FP32 operations; the camera (~150 bytes) is
// read by every thread from the same words. The design keeps every
// intermediate in registers and writes each output once; the SH bases are
// a template parameter so that the coefficient loop unrolls.
//
// Arithmetic: splat_common.cuh, op for op with the plain version; built
// with -fmad=false.
#include "splat_common.cuh"

using namespace splat;

namespace {

struct FwdArgs {
  const float *means, *scales, *quats, *dc, *rest, *opac;
  const uint8_t* alive;
  const float *view, *proj, *cam_pos, *fx, *fy, *cx_off, *cy_off;
  const int* deg;
  int n, width, proj_h, tile_size, position, antialiased;
  float *xys, *depths;
  int* radii;
  float* conics;
  int* tiles_hit;
  uint8_t* valid;
  float *colors4, *opac_out;
};

// torch's float -> int32 cast of a floored value, then + 1 with int32 wrap.
__device__ __forceinline__ int plus_one(int v) { return (int)((unsigned)v + 1u); }
__device__ __forceinline__ int clamp_int(int v, int hi) { return min(max(v, 0), hi); }

template <int K>
__global__ void __launch_bounds__(kBlock) splat_fwd_kernel(FwdArgs p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const Camera cam = load_camera(p.view, p.proj, p.cam_pos, p.fx, p.fy, p.cx_off, p.cy_off,
                                 p.deg, p.width, p.proj_h, p.position);
  float m[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) m[j] = p.means[3 * i + j];
  Cov3 cv;
  covariance(cv, p.scales, p.quats, i);
  Proj f;
  jacobian(f, cam, m);
  conic2d(f, cv);
  Screen sc;
  screen(sc, cam, m);
  View vw;
  view_dir(vw, cam.origin, m);
  float basis[K], v[3];
  masked_basis<K>(vw.d, cam.deg, basis);
  sh_colour<K>(basis, p.dc + 3 * i, p.rest + (size_t)i * 3 * (K - 1), v);

  // ndc2pix: 0.5 * size * ndc + center - 0.5
  const float x = (cam.half_w * (sc.h0 * sc.rw) + cam.cx) - 0.5f;
  const float y = (cam.half_h * (sc.h1 * sc.rw) + cam.cy) - 0.5f;
  p.xys[2 * i] = x;
  p.xys[2 * i + 1] = y;
  p.depths[i] = f.tz;
  p.conics[3 * i] = f.c * f.invd;
  p.conics[3 * i + 1] = -f.b * f.invd;
  p.conics[3 * i + 2] = f.a * f.invd;

  // 3-sigma radius from the larger eigenvalue of the 2D covariance.
  const float ht = 0.5f * (f.a + f.c);
  const float disc = sqrtf(clamp_min(ht * ht - f.det, F32(0.1)));
  const float radius_f = ceilf(3.0f * sqrtf(clamp_min(ht + disc, 0.0f)));
  const bool pvalid = (f.tz > F32(kClipThresh)) && f.inv;
  const int radius = (int)(pvalid ? radius_f : 0.0f);
  p.radii[i] = radius;

  // projection.tile_ranges; torch divides by a host scalar on the card as a
  // product with its float32 reciprocal.
  const int ts = p.tile_size;
  const int tiles_x = (p.width + ts - 1) / ts, tiles_y = (p.proj_h + ts - 1) / ts;
  const float r = (float)radius, inv_ts = 1.0f / (float)ts;
  const int bx0 = clamp_int((int)floorf((x - r) * inv_ts), tiles_x);
  const int by0 = clamp_int((int)floorf((y - r) * inv_ts), tiles_y);
  int bx1 = clamp_int(plus_one((int)floorf((x + r) * inv_ts)), tiles_x);
  int by1 = clamp_int(plus_one((int)floorf((y + r) * inv_ts)), tiles_y);
  if (radius <= 0) {
    bx1 = bx0;
    by1 = by0;
  }
  p.tiles_hit[i] = pvalid ? (bx1 - bx0) * (by1 - by0) : 0;
  p.valid[i] = (pvalid && p.alive[i]) ? 1 : 0;

  // maximum(rgb + 0.5, 0), NaN propagating; then the depth.
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) p.colors4[4 * i + ch] = isnan(v[ch]) ? v[ch] : fmaxf(v[ch], 0.0f);
  p.colors4[4 * i + 3] = f.tz;
  float o = sigmoid(p.opac[i]);
  if (p.antialiased) o = o * compensation(f.a, f.b, f.c, f.invd).comp;
  p.opac_out[i] = o;
}

}  // namespace

extern "C" int splat_fwd(const float* means, const float* scales, const float* quats,
                         const float* dc, const float* rest, const float* opac,
                         const uint8_t* alive, const float* view, const float* proj,
                         const float* cam_pos, const float* fx, const float* fy,
                         const float* cx_off, const float* cy_off, const int* deg, int n, int k,
                         int width, int proj_h, int tile_size, int position, int antialiased,
                         float* xys, float* depths, int* radii, float* conics,
                         int* tiles_hit, uint8_t* valid, float* colors4, float* opac_out,
                         cudaStream_t stream) {
  if (tile_size <= 0) return (int)cudaErrorInvalidValue;
  FwdArgs p{means, scales, quats, dc, rest, opac, alive, view, proj, cam_pos, fx, fy, cx_off,
            cy_off, deg, n, width, proj_h, tile_size, position, antialiased, xys, depths,
            radii, conics, tiles_hit, valid, colors4, opac_out};
  if (n > 0) {
    const dim3 grid((n + kBlock - 1) / kBlock);
    switch (k) {
      case 1: splat_fwd_kernel<1><<<grid, kBlock, 0, stream>>>(p); break;
      case 4: splat_fwd_kernel<4><<<grid, kBlock, 0, stream>>>(p); break;
      case 9: splat_fwd_kernel<9><<<grid, kBlock, 0, stream>>>(p); break;
      case 16: splat_fwd_kernel<16><<<grid, kBlock, 0, stream>>>(p); break;
      case 25: splat_fwd_kernel<25><<<grid, kBlock, 0, stream>>>(p); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
