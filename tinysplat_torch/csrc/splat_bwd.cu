// S2: the analytic backward of S1 (splat_fwd.cu), one thread per splat slot.
//
// Replaces the backward that XLA derives and fuses for the JAX package's
// render chain (tinysplat_tpu/render.py:139-169: project_gaussians at
// tinysplat_tpu/ops/projection.py:170, eval_sh at tinysplat_tpu/ops/sh.py:127);
// in the port that chain's backward was autograd over a few hundred
// elementwise ops. Its plain version is splat_bwd_plain
// (tinysplat_torch/ops/splat_inputs_cuda.py), line for line the same
// hand-derived chain rule with autograd's subgradient conventions.
//
// Bound: bytes. A splat reads S1's inputs but alive (49 + 12 K bytes) and
// the cotangents of xys, depth, conic, colors4 and opacity (44), and writes
// the gradients of those inputs (4 (3 + 3 + 4 + 3 K + 1) bytes). The
// forward is recomputed in registers (splat_common.cuh, the same code as
// S1, so every branch falls as it fell in S1); nothing is saved between
// the two kernels.
//
// The camera gradients of pose_opt (viewmat rows 0-2, full_projmat,
// cam_pos: 31 sums over the splats) are formed without atomics: each block
// sums its threads' terms in float64 in a fixed tree (warp shuffles, then
// the 8 warps in order) into one row of `partials`, and a one-block kernel
// folds the rows in block order. Two launches give the same bytes.
#include "splat_common.cuh"

using namespace splat;

namespace {

struct BwdArgs {
  const float *means, *scales, *quats, *dc, *rest, *opac;
  const float *view, *proj, *cam_pos, *fx, *fy;
  const int* deg;
  const float *g_xys, *g_depths, *g_conics, *g_colors4, *g_opac;
  int n, width, proj_h, position, antialiased;
  float *g_means, *g_scales, *g_quats, *g_dc, *g_rest, *g_opac_out;
  int cam_grad;
  double* partials;
};

// d(basis k)/d(x, y, z) for k >= 1 (ops/sh.py sh_basis), weighted by g[k]
// and added to gd.
template <int K>
__device__ __forceinline__ void sh_basis_grad(float x, float y, float z, const float* g,
                                              float* gd) {
  if (K > 1) {
    gd[1] += g[1] * F32(-kShC1);
    gd[2] += g[2] * F32(kShC1);
    gd[0] += g[3] * F32(-kShC1);
  }
  if (K > 4) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gd[0] += g[4] * (F32(kShC2_0) * y);
    gd[1] += g[4] * (F32(kShC2_0) * x);
    gd[1] += g[5] * (F32(kShC2_1) * z);
    gd[2] += g[5] * (F32(kShC2_1) * y);
    gd[0] += g[6] * (F32(-2.0 * kShC2_2) * x);
    gd[1] += g[6] * (F32(-2.0 * kShC2_2) * y);
    gd[2] += g[6] * (F32(4.0 * kShC2_2) * z);
    gd[0] += g[7] * (F32(kShC2_3) * z);
    gd[2] += g[7] * (F32(kShC2_3) * x);
    gd[0] += g[8] * (F32(2.0 * kShC2_4) * x);
    gd[1] += g[8] * (F32(-2.0 * kShC2_4) * y);
    if (K > 9) {
      gd[0] += g[9] * (F32(kShC3_0) * 6.0f * x * y);
      gd[1] += g[9] * (F32(kShC3_0) * 3.0f * (xx - yy));
      gd[0] += g[10] * (F32(kShC3_1) * y * z);
      gd[1] += g[10] * (F32(kShC3_1) * x * z);
      gd[2] += g[10] * (F32(kShC3_1) * x * y);
      gd[0] += g[11] * (F32(kShC3_2) * -2.0f * x * y);
      gd[1] += g[11] * (F32(kShC3_2) * (4.0f * zz - xx - 3.0f * yy));
      gd[2] += g[11] * (F32(kShC3_2) * 8.0f * y * z);
      gd[0] += g[12] * (F32(kShC3_3) * -6.0f * x * z);
      gd[1] += g[12] * (F32(kShC3_3) * -6.0f * y * z);
      gd[2] += g[12] * (F32(kShC3_3) * (6.0f * zz - 3.0f * xx - 3.0f * yy));
      gd[0] += g[13] * (F32(kShC3_4) * (4.0f * zz - 3.0f * xx - yy));
      gd[1] += g[13] * (F32(kShC3_4) * -2.0f * x * y);
      gd[2] += g[13] * (F32(kShC3_4) * 8.0f * x * z);
      gd[0] += g[14] * (F32(kShC3_5) * 2.0f * x * z);
      gd[1] += g[14] * (F32(kShC3_5) * -2.0f * y * z);
      gd[2] += g[14] * (F32(kShC3_5) * (xx - yy));
      gd[0] += g[15] * (F32(kShC3_6) * 3.0f * (xx - yy));
      gd[1] += g[15] * (F32(kShC3_6) * -6.0f * x * y);
    }
    if (K > 16) {
      gd[0] += g[16] * (F32(kShC4_0) * y * (3.0f * xx - yy));
      gd[1] += g[16] * (F32(kShC4_0) * x * (xx - 3.0f * yy));
      gd[0] += g[17] * (F32(kShC4_1) * 6.0f * x * y * z);
      gd[1] += g[17] * (F32(kShC4_1) * 3.0f * z * (xx - yy));
      gd[2] += g[17] * (F32(kShC4_1) * y * (3.0f * xx - yy));
      gd[0] += g[18] * (F32(kShC4_2) * y * (7.0f * zz - 1.0f));
      gd[1] += g[18] * (F32(kShC4_2) * x * (7.0f * zz - 1.0f));
      gd[2] += g[18] * (F32(kShC4_2) * 14.0f * x * y * z);
      gd[1] += g[19] * (F32(kShC4_3) * z * (7.0f * zz - 3.0f));
      gd[2] += g[19] * (F32(kShC4_3) * y * (21.0f * zz - 3.0f));
      gd[2] += g[20] * (F32(kShC4_4) * z * (140.0f * zz - 60.0f));
      gd[0] += g[21] * (F32(kShC4_5) * z * (7.0f * zz - 3.0f));
      gd[2] += g[21] * (F32(kShC4_5) * x * (21.0f * zz - 3.0f));
      gd[0] += g[22] * (F32(kShC4_6) * 2.0f * x * (7.0f * zz - 1.0f));
      gd[1] += g[22] * (F32(kShC4_6) * -2.0f * y * (7.0f * zz - 1.0f));
      gd[2] += g[22] * (F32(kShC4_6) * 14.0f * z * (xx - yy));
      gd[0] += g[23] * (F32(kShC4_7) * 3.0f * z * (xx - yy));
      gd[1] += g[23] * (F32(kShC4_7) * -6.0f * x * y * z);
      gd[2] += g[23] * (F32(kShC4_7) * x * (xx - 3.0f * yy));
      gd[0] += g[24] * (F32(kShC4_8) * 4.0f * x * (xx - 3.0f * yy));
      gd[1] += g[24] * (F32(kShC4_8) * 4.0f * y * (yy - 3.0f * xx));
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kBlock) splat_bwd_kernel(BwdArgs p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float cg[kCamCols];
#pragma unroll
  for (int j = 0; j < kCamCols; ++j) cg[j] = 0.0f;
  if (i < p.n) {
    const Camera cam = load_camera(p.view, p.proj, p.cam_pos, p.fx, p.fy, nullptr, nullptr,
                                   p.deg, p.width, p.proj_h, p.position);
    Fwd<K> f;
    forward<K>(f, cam, i, p.means, p.scales, p.quats, p.dc, p.rest, p.opac);

    // -- opacity (and the compensation's share of the conic) ------------------
    float gA = p.g_conics[3 * i], gB = p.g_conics[3 * i + 1], gC = p.g_conics[3 * i + 2];
    const float g_op = p.g_opac[i];
    float g_sig_o = g_op;
    if (p.antialiased) {
      const Comp k = compensation(f.a, f.b, f.c, f.invd);
      g_sig_o = g_op * k.comp;
      const float g_s = k.det_c > 0.0f ? g_op * f.sig_o : 0.0f;
      const float g_cl = g_s / (2.0f * k.comp_s);
      const float g_ratio = (k.ratio >= F32(1e-8) && k.ratio <= 1.0f) ? g_cl : 0.0f;
      const float g_do = g_ratio * k.safe;
      const float g_qC = g_do * k.x2, g_qA = g_do * k.x1, g_qB = -g_do * (2.0f * k.qB);
      const float g_safe =
          g_ratio * k.det_o - ((g_qC * k.qC + g_qA * k.qA) + g_qB * k.qB) / k.safe;
      const float g_dc = k.det_c >= F32(1e-12) ? g_safe : 0.0f;
      gA = gA + (g_qA / k.safe + g_dc * k.cC);
      gB = gB + (g_qB / k.safe - 2.0f * g_dc * k.cB);
      gC = gC + (g_qC / k.safe + g_dc * k.cA);
    }
    p.g_opac_out[i] = (g_sig_o * (1.0f - f.sig_o)) * f.sig_o;

    // -- colours: maximum(v, 0) halves the gradient at a tie ------------------
    float g_rgb[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float g = p.g_colors4[4 * i + ch];
      g_rgb[ch] = f.v[ch] < 0.0f ? 0.0f : (f.v[ch] == 0.0f ? g / 2.0f : g);
    }
    float g_basis[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      g_basis[k] = band_of(k) > cam.deg
                       ? 0.0f
                       : (f.coeff[k][0] * g_rgb[0] + f.coeff[k][1] * g_rgb[1]) +
                             f.coeff[k][2] * g_rgb[2];
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) p.g_dc[3 * i + ch] = f.basis[0] * g_rgb[ch];
#pragma unroll
    for (int k = 1; k < K; ++k)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        p.g_rest[(size_t)i * 3 * (K - 1) + 3 * (k - 1) + ch] = f.basis[k] * g_rgb[ch];
    float g_d[3] = {0.0f, 0.0f, 0.0f};
    sh_basis_grad<K>(f.d[0], f.d[1], f.d[2], g_basis, g_d);
    const float g_nc = -(((g_d[0] * f.d[0] + g_d[1] * f.d[1]) + g_d[2] * f.d[2]) / f.nc);
    const float scale_n = f.n >= F32(1e-12) ? g_nc / f.n : 0.0f;
    float g_dirs[3], g_m[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_dirs[j] = g_d[j] / f.nc + f.dirs[j] * scale_n;
      g_m[j] = g_dirs[j];
    }

    // -- conics ----------------------------------------------------------------
    float g_a = gC * f.invd, g_b = -(gB * f.invd), g_c = gA * f.invd;
    const float g_invd = (gA * f.c - gB * f.b) + gC * f.a;
    const float g_det = f.inv ? -g_invd * (f.invd * f.invd) : 0.0f;
    g_a = g_a + g_det * f.c;
    g_c = g_c + g_det * f.a;
    g_b = g_b - 2.0f * g_det * f.b;

    // -- 2D covariance -> T rows and Sigma ---------------------------------------
    float g_t0[3], g_t1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_t0[k] = 2.0f * g_a * f.u0[k] + g_b * f.u1[k];
      g_t1[k] = g_b * f.u0[k] + 2.0f * g_c * f.u1[k];
    }
    float D[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        D[r][j] = 2.0f * g_a * f.t0[r] * f.t0[j] +
                  g_b * (f.t0[r] * f.t1[j] + f.t1[r] * f.t0[j]) +
                  2.0f * g_c * f.t1[r] * f.t1[j];
    float gR[3][3], g_s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float gM = (D[r][0] * f.M[0][j] + D[r][1] * f.M[1][j]) + D[r][2] * f.M[2][j];
        g_s[j] += gM * f.R[r][j];
        gR[r][j] = gM * f.s[j];
      }
#pragma unroll
    for (int j = 0; j < 3; ++j) p.g_scales[3 * i + j] = g_s[j] * f.s[j];
    const float qw = f.qn[0], qx = f.qn[1], qy = f.qn[2], qz = f.qn[3];
    float g_qn[4];
    g_qn[0] = 2.0f * (-gR[0][1] * qz + gR[0][2] * qy + gR[1][0] * qz - gR[1][2] * qx -
                      gR[2][0] * qy + gR[2][1] * qx);
    g_qn[1] = 2.0f * (gR[0][1] * qy + gR[0][2] * qz + gR[1][0] * qy - 2.0f * gR[1][1] * qx -
                      gR[1][2] * qw + gR[2][0] * qz + gR[2][1] * qw - 2.0f * gR[2][2] * qx);
    g_qn[2] = 2.0f * (-2.0f * gR[0][0] * qy + gR[0][1] * qx + gR[0][2] * qw + gR[1][0] * qx +
                      gR[1][2] * qz - gR[2][0] * qw + gR[2][1] * qz - 2.0f * gR[2][2] * qy);
    g_qn[3] = 2.0f * (-2.0f * gR[0][0] * qz - gR[0][1] * qw + gR[0][2] * qx + gR[1][0] * qw -
                      2.0f * gR[1][1] * qz + gR[1][2] * qy + gR[2][0] * qx + gR[2][1] * qy);
    const float g_nrm =
        -(((g_qn[0] * qw + g_qn[1] * qx) + g_qn[2] * qy) + g_qn[3] * qz) / f.nrm;
    const float g_ss = f.ss >= F32(1e-24) ? g_nrm / (2.0f * f.nrm) : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) p.g_quats[4 * i + j] = g_qn[j] / f.nrm + 2.0f * f.q[j] * g_ss;

    // -- T = J W ------------------------------------------------------------------
    const float g_j00 = (g_t0[0] * cam.W[0][0] + g_t0[1] * cam.W[0][1]) + g_t0[2] * cam.W[0][2];
    const float g_j02 = (g_t0[0] * cam.W[2][0] + g_t0[1] * cam.W[2][1]) + g_t0[2] * cam.W[2][2];
    const float g_j11 = (g_t1[0] * cam.W[1][0] + g_t1[1] * cam.W[1][1]) + g_t1[2] * cam.W[1][2];
    const float g_j12 = (g_t1[0] * cam.W[2][0] + g_t1[1] * cam.W[2][1]) + g_t1[2] * cam.W[2][2];
    float g_rz = g_j00 * cam.fx + g_j11 * cam.fy;
    const float g_rz2 = g_j02 * (-cam.fx * f.txc) + g_j12 * (-cam.fy * f.tyc);
    const float g_txc = g_j02 * f.rz2 * -cam.fx;
    const float g_tyc = g_j12 * f.rz2 * -cam.fy;
    g_rz = g_rz + 2.0f * f.rz * g_rz2;
    float g_tzw = -g_rz * (f.rz * f.rz);
    g_tzw = g_tzw + g_txc * f.cxr + g_tyc * f.cyr;
    const float g_qxr = (f.qxr >= -cam.lim_x && f.qxr <= cam.lim_x) ? g_txc * f.tzw : 0.0f;
    const float g_qyr = (f.qyr >= -cam.lim_y && f.qyr <= cam.lim_y) ? g_tyc * f.tzw : 0.0f;
    g_tzw = g_tzw - (g_qxr * f.qxr + g_qyr * f.qyr) / f.tzw;
    const float g_mc[3] = {g_qxr / f.tzw, g_qyr / f.tzw,
                           (f.tz_small ? 0.0f : g_tzw) + (p.g_colors4[4 * i + 3] + p.g_depths[i])};
#pragma unroll
    for (int j = 0; j < 3; ++j)
      g_m[j] = g_m[j] + ((g_mc[0] * cam.W[0][j] + g_mc[1] * cam.W[1][j]) + g_mc[2] * cam.W[2][j]);

    // -- screen centres ---------------------------------------------------------------
    const float gx = p.g_xys[2 * i], gy = p.g_xys[2 * i + 1];
    const float g_h0 = gx * cam.half_w * f.rw, g_h1 = gy * cam.half_h * f.rw;
    const float g_rw = gx * cam.half_w * f.h0 + gy * cam.half_h * f.h1;
    const float g_h3a = f.h3a >= F32(1e-6) ? -(g_rw * f.sg) * (f.rcp * f.rcp) : 0.0f;
    const float g_h3 = g_h3a * sign_of(f.h3);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_m[j] = g_m[j] + ((g_h0 * cam.P[0][j] + g_h1 * cam.P[1][j]) + g_h3 * cam.P[3][j]);
      p.g_means[3 * i + j] = g_m[j];
    }

    if (p.cam_grad) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {  // viewmat row r: W[r][0..2], t[r]
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float gT = r == 0   ? g_t0[k] * f.j00
                           : r == 1 ? g_t1[k] * f.j11
                                    : g_t0[k] * f.j02 + g_t1[k] * f.j12;
          cg[4 * r + k] = g_mc[r] * f.m[k] + gT;
        }
        cg[4 * r + 3] = p.position ? g_mc[r] : g_mc[r] - g_dirs[r];
      }
      const float g_h[4] = {g_h0, g_h1, 0.0f, g_h3};
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // full_projmat row r
        if (r == 2) continue;
#pragma unroll
        for (int k = 0; k < 3; ++k) cg[12 + 4 * r + k] = g_h[r] * f.m[k];
        cg[12 + 4 * r + 3] = g_h[r];
      }
      if (p.position)
#pragma unroll
        for (int j = 0; j < 3; ++j) cg[28 + j] = -g_dirs[j];
    }
  }

  if (p.cam_grad) {  // uniform across the block
    __shared__ double warp_sums[kBlock / 32][kCamCols];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < kCamCols; ++j) {
      double v = (double)cg[j];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_sums[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < kCamCols) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) s += warp_sums[w][threadIdx.x];
      p.partials[(size_t)blockIdx.x * kCamCols + threadIdx.x] = s;
    }
  }
}

// Column j of the camera gradient: the blocks' partials summed in block order.
__global__ void splat_bwd_fold_kernel(const double* partials, int blocks, float* g_cam) {
  const int j = threadIdx.x;
  if (j >= kCamCols) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partials[(size_t)b * kCamCols + j];
  g_cam[j] = (float)s;
}

}  // namespace

extern "C" int splat_bwd(const float* means, const float* scales, const float* quats,
                         const float* dc, const float* rest, const float* opac, const float* view,
                         const float* proj, const float* cam_pos, const float* fx,
                         const float* fy, const int* deg, const float* g_xys,
                         const float* g_depths, const float* g_conics, const float* g_colors4,
                         const float* g_opac, int n, int k, int width, int proj_h, int position,
                         int antialiased, float* g_means, float* g_scales,
                         float* g_quats, float* g_dc, float* g_rest, float* g_opac_out,
                         int cam_grad, double* partials, float* g_cam, cudaStream_t stream) {
  BwdArgs p{means,   scales,   quats,   dc,   rest,   opac,       view,     proj,
            cam_pos, fx,       fy,      deg,  g_xys,  g_depths,   g_conics, g_colors4,
            g_opac,  n,        width,   proj_h, position, antialiased, g_means, g_scales,
            g_quats, g_dc,     g_rest,  g_opac_out, cam_grad, partials};
  const int blocks = (n + kBlock - 1) / kBlock;
  if (n > 0) {
    switch (k) {
      case 1: splat_bwd_kernel<1><<<blocks, kBlock, 0, stream>>>(p); break;
      case 4: splat_bwd_kernel<4><<<blocks, kBlock, 0, stream>>>(p); break;
      case 9: splat_bwd_kernel<9><<<blocks, kBlock, 0, stream>>>(p); break;
      case 16: splat_bwd_kernel<16><<<blocks, kBlock, 0, stream>>>(p); break;
      case 25: splat_bwd_kernel<25><<<blocks, kBlock, 0, stream>>>(p); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (cam_grad) splat_bwd_fold_kernel<<<1, 32, 0, stream>>>(partials, blocks, g_cam);
  return (int)cudaGetLastError();
}
