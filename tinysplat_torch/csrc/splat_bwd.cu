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
// Bound: bytes. A splat reads S1's inputs but alive (44 + 12 K bytes) and
// the cotangents of xys, depth, conic, colors4 and opacity (44), and writes
// the gradients of those inputs (4 (3 + 3 + 4 + 3 K + 1) bytes): 516 bytes
// at K = 16, 360 of them the SH rows. The forward is recomputed from S1's
// pieces (splat_common.cuh, so every branch falls as it fell in S1);
// nothing is saved between the two kernels.
//
// The design keeps the loads in flight:
// - The SH rows go through shared memory. A block's splats own one
//   contiguous span of colors_rest; it comes in by cp.async (16 bytes where
//   the span is 16-byte aligned, 4 at a ragged head or tail), each thread
//   reads its row there twice (the colour, then the basis gradients) and
//   overwrites it with its row of g_rest, and the span goes out in 16-byte
//   stores. A thread alone would read and write 180-byte rows at a 180-byte
//   stride: 32 lines a warp instruction.
// - The live set is cut by phase, not by a register cap: the colour phase
//   (view direction, bases, colour, the colour gradients, with the camera
//   not yet loaded) leaves only the view direction's gradient; the geometry
//   phase recomputes the covariance chain where it walks it back (the
//   rotation and M from the stored quaternion and scales again) instead of
//   holding it across the mean's backward. Left to itself ptxas then takes
//   about 100 registers at every K, without spills: 4-5 blocks of 128 an SM
//   (chip_smoke.py phase 17 prints them). A cap of 128 (4 blocks) made it
//   schedule wider and no faster; caps for 5 or 6 blocks spill.
//
// The camera gradients of pose_opt (viewmat rows 0-2, full_projmat,
// cam_pos: 31 sums over the splats) are formed without atomics: each block
// sums its threads' terms in float64 in a fixed tree (warp shuffles, then
// its 4 warps in order) into its entry of each column of `partials`
// (column-major); then 31 fold blocks, one a column, each sum the column in
// fixed runs a thread, a fixed shuffle tree and their 8 warps in order. Two
// launches give the same bytes.
#include "splat_common.cuh"

using namespace splat;

namespace {

constexpr int kBwdBlock = 128;     // threads a block of S2, one splat each
constexpr int kBwdWarps = kBwdBlock / 32;
constexpr int kFoldThreads = 256;  // threads of each fold block, one a camera column

struct BwdArgs {
  const float *means, *scales, *quats, *dc, *rest, *opac;
  const float *view, *proj, *cam_pos, *fx, *fy;
  const int* deg;
  const float *g_xys, *g_depths, *g_conics, *g_colors4, *g_opac;
  int n, width, proj_h, position, antialiased;
  float *g_means, *g_scales, *g_quats, *g_dc, *g_rest, *g_opac_out;
  int cam_grad, blocks;
  double* partials;
};

// Dynamic shared memory of a block: its span of colors_rest, and 16 bytes so
// that the span can sit at its own offset from a 16-byte boundary.
__host__ __device__ constexpr int span_smem_bytes(int k) {
  return k > 1 ? kBwdBlock * (k - 1) * 3 * 4 + 16 : 0;
}
// Within the default limit at every K: no launch has to ask for more.
static_assert(span_smem_bytes(25) <= 48 * 1024, "S2's span exceeds 48 KB");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Floats before the first 16-byte boundary at or after p.
__device__ __forceinline__ int head_floats(const float* p) {
  return (int)((16 - ((uintptr_t)p & 15)) & 15) >> 2;
}

// src[0, count) -> dst[0, count) by the block, where dst and src sit at the
// same offset from a 16-byte boundary: 4-byte copies up to the boundary and
// past the last whole 16 bytes, 16-byte copies between.
__device__ __forceinline__ void span_in(float* dst, const float* src, int count) {
  const int head = min(count, head_floats(src));
  const int chunks = (count - head) >> 2;
  for (int e = threadIdx.x; e < head; e += kBwdBlock) cp_async4(dst + e, src + e);
  for (int c = threadIdx.x; c < chunks; c += kBwdBlock)
    cp_async16(dst + head + 4 * c, src + head + 4 * c);
  for (int e = head + 4 * chunks + threadIdx.x; e < count; e += kBwdBlock)
    cp_async4(dst + e, src + e);
}

// src[0, count) in shared memory -> dst[0, count) by the block: 16-byte
// stores between dst's 16-byte boundaries, 4-byte ones at its ends. src
// need not share dst's offset (a colors_rest view may start anywhere).
__device__ __forceinline__ void span_out(float* dst, const float* src, int count) {
  const int head = min(count, head_floats(dst));
  const int chunks = (count - head) >> 2;
  const bool aligned = ((uintptr_t)(src + head) & 15) == 0;
  for (int e = threadIdx.x; e < head; e += kBwdBlock) dst[e] = src[e];
  for (int c = threadIdx.x; c < chunks; c += kBwdBlock) {
    const float* s = src + head + 4 * c;
    const float4 v = aligned ? *reinterpret_cast<const float4*>(s)
                             : make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(dst + head + 4 * c) = v;
  }
  for (int e = head + 4 * chunks + threadIdx.x; e < count; e += kBwdBlock) dst[e] = src[e];
}

// d(basis k)/d(x, y, z) for k >= 1 (ops/sh.py sh_basis), weighted by g and
// added to gd. Called for k = 1, 2, ... in turn, every gd[j] takes its terms
// in increasing k, as the plain version adds them.
__device__ __forceinline__ void sh_basis_grad(int k, float x, float y, float z, float g,
                                              float* gd) {
  const float xx = x * x, yy = y * y, zz = z * z;
  switch (k) {
    case 1: gd[1] += g * F32(-kShC1); break;
    case 2: gd[2] += g * F32(kShC1); break;
    case 3: gd[0] += g * F32(-kShC1); break;
    case 4:
      gd[0] += g * (F32(kShC2_0) * y);
      gd[1] += g * (F32(kShC2_0) * x);
      break;
    case 5:
      gd[1] += g * (F32(kShC2_1) * z);
      gd[2] += g * (F32(kShC2_1) * y);
      break;
    case 6:
      gd[0] += g * (F32(-2.0 * kShC2_2) * x);
      gd[1] += g * (F32(-2.0 * kShC2_2) * y);
      gd[2] += g * (F32(4.0 * kShC2_2) * z);
      break;
    case 7:
      gd[0] += g * (F32(kShC2_3) * z);
      gd[2] += g * (F32(kShC2_3) * x);
      break;
    case 8:
      gd[0] += g * (F32(2.0 * kShC2_4) * x);
      gd[1] += g * (F32(-2.0 * kShC2_4) * y);
      break;
    case 9:
      gd[0] += g * (F32(kShC3_0) * 6.0f * x * y);
      gd[1] += g * (F32(kShC3_0) * 3.0f * (xx - yy));
      break;
    case 10:
      gd[0] += g * (F32(kShC3_1) * y * z);
      gd[1] += g * (F32(kShC3_1) * x * z);
      gd[2] += g * (F32(kShC3_1) * x * y);
      break;
    case 11:
      gd[0] += g * (F32(kShC3_2) * -2.0f * x * y);
      gd[1] += g * (F32(kShC3_2) * (4.0f * zz - xx - 3.0f * yy));
      gd[2] += g * (F32(kShC3_2) * 8.0f * y * z);
      break;
    case 12:
      gd[0] += g * (F32(kShC3_3) * -6.0f * x * z);
      gd[1] += g * (F32(kShC3_3) * -6.0f * y * z);
      gd[2] += g * (F32(kShC3_3) * (6.0f * zz - 3.0f * xx - 3.0f * yy));
      break;
    case 13:
      gd[0] += g * (F32(kShC3_4) * (4.0f * zz - 3.0f * xx - yy));
      gd[1] += g * (F32(kShC3_4) * -2.0f * x * y);
      gd[2] += g * (F32(kShC3_4) * 8.0f * x * z);
      break;
    case 14:
      gd[0] += g * (F32(kShC3_5) * 2.0f * x * z);
      gd[1] += g * (F32(kShC3_5) * -2.0f * y * z);
      gd[2] += g * (F32(kShC3_5) * (xx - yy));
      break;
    case 15:
      gd[0] += g * (F32(kShC3_6) * 3.0f * (xx - yy));
      gd[1] += g * (F32(kShC3_6) * -6.0f * x * y);
      break;
    case 16:
      gd[0] += g * (F32(kShC4_0) * y * (3.0f * xx - yy));
      gd[1] += g * (F32(kShC4_0) * x * (xx - 3.0f * yy));
      break;
    case 17:
      gd[0] += g * (F32(kShC4_1) * 6.0f * x * y * z);
      gd[1] += g * (F32(kShC4_1) * 3.0f * z * (xx - yy));
      gd[2] += g * (F32(kShC4_1) * y * (3.0f * xx - yy));
      break;
    case 18:
      gd[0] += g * (F32(kShC4_2) * y * (7.0f * zz - 1.0f));
      gd[1] += g * (F32(kShC4_2) * x * (7.0f * zz - 1.0f));
      gd[2] += g * (F32(kShC4_2) * 14.0f * x * y * z);
      break;
    case 19:
      gd[1] += g * (F32(kShC4_3) * z * (7.0f * zz - 3.0f));
      gd[2] += g * (F32(kShC4_3) * y * (21.0f * zz - 3.0f));
      break;
    case 20: gd[2] += g * (F32(kShC4_4) * z * (140.0f * zz - 60.0f)); break;
    case 21:
      gd[0] += g * (F32(kShC4_5) * z * (7.0f * zz - 3.0f));
      gd[2] += g * (F32(kShC4_5) * x * (21.0f * zz - 3.0f));
      break;
    case 22:
      gd[0] += g * (F32(kShC4_6) * 2.0f * x * (7.0f * zz - 1.0f));
      gd[1] += g * (F32(kShC4_6) * -2.0f * y * (7.0f * zz - 1.0f));
      gd[2] += g * (F32(kShC4_6) * 14.0f * z * (xx - yy));
      break;
    case 23:
      gd[0] += g * (F32(kShC4_7) * 3.0f * z * (xx - yy));
      gd[1] += g * (F32(kShC4_7) * -6.0f * x * y * z);
      gd[2] += g * (F32(kShC4_7) * x * (xx - 3.0f * yy));
      break;
    case 24:
      gd[0] += g * (F32(kShC4_8) * 4.0f * x * (xx - 3.0f * yy));
      gd[1] += g * (F32(kShC4_8) * 4.0f * y * (yy - 3.0f * xx));
      break;
    default: break;
  }
}

// The colour phase of splat i: reads its SH row from `row` (shared memory),
// writes g_dc, overwrites the row with its g_rest row, and returns the
// gradient of the view direction's un-normalised dirs (= of the mean).
template <int K>
__device__ __forceinline__ void colour_backward(const BwdArgs& p, const float* origin, int deg,
                                                int i, const float* m, float* row,
                                                float* g_dirs) {
  View vw;
  view_dir(vw, origin, m);
  float basis[K], v[3];
  masked_basis<K>(vw.d, deg, basis);
  sh_colour<K>(basis, p.dc + 3 * i, row, v);
  // maximum(v, 0) halves the gradient at a tie
  float g_rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float g = p.g_colors4[4 * i + ch];
    g_rgb[ch] = v[ch] < 0.0f ? 0.0f : (v[ch] == 0.0f ? g / 2.0f : g);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) p.g_dc[3 * i + ch] = basis[0] * g_rgb[ch];
  float g_d[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 1; k < K; ++k) {
    float* c = row + 3 * (k - 1);
    const float g_basis =
        band_of(k) > deg ? 0.0f : (c[0] * g_rgb[0] + c[1] * g_rgb[1]) + c[2] * g_rgb[2];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] = basis[k] * g_rgb[ch];
    sh_basis_grad(k, vw.d[0], vw.d[1], vw.d[2], g_basis, g_d);
    // One basis at a time: without this the compiler loads the whole row
    // ahead of the stores, and at K = 25 the live set spills.
    asm volatile("" ::: "memory");
  }
  const float g_nc = -(((g_d[0] * vw.d[0] + g_d[1] * vw.d[1]) + g_d[2] * vw.d[2]) / vw.nc);
  const float scale_n = vw.n >= F32(1e-12) ? g_nc / vw.n : 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) g_dirs[j] = g_d[j] / vw.nc + vw.dirs[j] * scale_n;
}

// The geometry phase of splat i up to the mean: opacity, conic, the 2D
// covariance's share of T, T = J W, the screen centre. Writes g_opacities and
// g_means; returns the 2D covariance's gradient (g_abc) and T's rows (t0,
// t1) for the covariance's backward, and the camera columns in cg.
__device__ __forceinline__ void mean_backward(const BwdArgs& p, const Camera& cam, int i,
                                              const float* m, const float* g_dirs, float* g_abc,
                                              float* t0, float* t1, float* cg) {
  Proj f;
  {
    Cov3 cv;
    covariance(cv, p.scales, p.quats, i);
    jacobian(f, cam, m);
    conic2d(f, cv);
  }

  // -- opacity (and the compensation's share of the conic) ------------------
  float gA = p.g_conics[3 * i], gB = p.g_conics[3 * i + 1], gC = p.g_conics[3 * i + 2];
  const float g_op = p.g_opac[i];
  const float sig_o = sigmoid(p.opac[i]);
  float g_sig_o = g_op;
  if (p.antialiased) {
    const Comp k = compensation(f.a, f.b, f.c, f.invd);
    g_sig_o = g_op * k.comp;
    const float g_s = k.det_c > 0.0f ? g_op * sig_o : 0.0f;
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
  p.g_opac_out[i] = (g_sig_o * (1.0f - sig_o)) * sig_o;

  // -- conics ----------------------------------------------------------------
  float g_a = gC * f.invd, g_b = -(gB * f.invd), g_c = gA * f.invd;
  const float g_invd = (gA * f.c - gB * f.b) + gC * f.a;
  const float g_det = f.inv ? -g_invd * (f.invd * f.invd) : 0.0f;
  g_a = g_a + g_det * f.c;
  g_c = g_c + g_det * f.a;
  g_b = g_b - 2.0f * g_det * f.b;
  g_abc[0] = g_a;
  g_abc[1] = g_b;
  g_abc[2] = g_c;

  // -- 2D covariance -> T rows -------------------------------------------------
  float g_t0[3], g_t1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_t0[k] = 2.0f * g_a * f.u0[k] + g_b * f.u1[k];
    g_t1[k] = g_b * f.u0[k] + 2.0f * g_c * f.u1[k];
    t0[k] = f.t0[k];
    t1[k] = f.t1[k];
  }

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
  float g_m[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    g_m[j] = g_dirs[j] + ((g_mc[0] * cam.W[0][j] + g_mc[1] * cam.W[1][j]) + g_mc[2] * cam.W[2][j]);

  // -- screen centres -------------------------------------------------------------
  Screen sc;
  screen(sc, cam, m);
  const float gx = p.g_xys[2 * i], gy = p.g_xys[2 * i + 1];
  const float g_h0 = gx * cam.half_w * sc.rw, g_h1 = gy * cam.half_h * sc.rw;
  const float g_rw = gx * cam.half_w * sc.h0 + gy * cam.half_h * sc.h1;
  const float g_h3a = sc.h3a >= F32(1e-6) ? -(g_rw * sc.sg) * (sc.rcp * sc.rcp) : 0.0f;
  const float g_h3 = g_h3a * sign_of(sc.h3);
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
        cg[4 * r + k] = g_mc[r] * m[k] + gT;
      }
      cg[4 * r + 3] = p.position ? g_mc[r] : g_mc[r] - g_dirs[r];
    }
    const float g_h[4] = {g_h0, g_h1, 0.0f, g_h3};
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // full_projmat row r
#pragma unroll
      for (int k = 0; k < 3; ++k) cg[12 + 4 * r + k] = g_h[r] * m[k];
      cg[12 + 4 * r + 3] = g_h[r];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) cg[28 + j] = p.position ? -g_dirs[j] : 0.0f;
  }
}

// The 3D covariance's backward of splat i: the covariance chain recomputed
// from the stored quaternion and scales, walked back from the 2D
// covariance's gradient. Writes g_scales and g_quats.
__device__ __forceinline__ void covariance_backward(const BwdArgs& p, int i, const float* g_abc,
                                                    const float* t0, const float* t1) {
  const float g_a = g_abc[0], g_b = g_abc[1], g_c = g_abc[2];
  Cov3 f;
  covariance(f, p.scales, p.quats, i);
  float D[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      D[r][j] = 2.0f * g_a * t0[r] * t0[j] + g_b * (t0[r] * t1[j] + t1[r] * t0[j]) +
                2.0f * g_c * t1[r] * t1[j];
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
  const float g_nrm = -(((g_qn[0] * qw + g_qn[1] * qx) + g_qn[2] * qy) + g_qn[3] * qz) / f.nrm;
  const float g_ss = f.ss >= F32(1e-24) ? g_nrm / (2.0f * f.nrm) : 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) p.g_quats[4 * i + j] = g_qn[j] / f.nrm + 2.0f * f.q[j] * g_ss;
}

template <int K>
__global__ void __launch_bounds__(kBwdBlock) splat_bwd_kernel(BwdArgs p) {
  constexpr int kRow = 3 * (K - 1);  // floats of a splat's colors_rest row
  extern __shared__ __align__(16) float span[];
  const int base = blockIdx.x * kBwdBlock;
  const int i = base + threadIdx.x;
  const bool live = i < p.n;
  const int count = min(kBwdBlock, p.n - base) * kRow;  // floats of the block's span
  const float* rest = p.rest + (size_t)base * kRow;
  // The span sits at rest's offset from a 16-byte boundary.
  float* rows = span + (K > 1 ? (4 - head_floats(rest)) & 3 : 0);
  if (K > 1) span_in(rows, rest, count);

  // The colour phase needs of the camera only the origin and the degree;
  // the rest is loaded after it, so that it is not held through it.
  float origin[3], m[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 3; ++j) origin[j] = view_origin(p.view, p.cam_pos, p.position, j);
  const int deg = __ldg(p.deg);
  if (live)
#pragma unroll
    for (int j = 0; j < 3; ++j) m[j] = p.means[3 * i + j];
  if (K > 1) {
    cp_async_wait_all();
    __syncthreads();
  }

  // -- colour phase ------------------------------------------------------------
  float g_dirs[3];
  if (live) colour_backward<K>(p, origin, deg, i, m, rows + threadIdx.x * kRow, g_dirs);

  // -- geometry phase -----------------------------------------------------------
  const Camera cam = load_camera(p.view, p.proj, p.cam_pos, p.fx, p.fy, nullptr, nullptr,
                                 p.deg, p.width, p.proj_h, p.position);
  float cg[kCamCols];
#pragma unroll
  for (int j = 0; j < kCamCols; ++j) cg[j] = 0.0f;
  float g_abc[3], t0[3], t1[3];
  if (live) mean_backward(p, cam, i, m, g_dirs, g_abc, t0, t1, cg);

  __shared__ double warp_sums[kBwdWarps][kCamCols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (p.cam_grad) {  // uniform across the block
#pragma unroll
    for (int j = 0; j < kCamCols; ++j) {
      double v = (double)cg[j];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_sums[warp][j] = v;
    }
  }
  if (live) covariance_backward(p, i, g_abc, t0, t1);

  // Every row of g_rest is in place and every warp's sums are in.
  __syncthreads();
  if (p.cam_grad && threadIdx.x < kCamCols) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += warp_sums[w][threadIdx.x];
    p.partials[(size_t)threadIdx.x * p.blocks + blockIdx.x] = s;
  }
  if (K > 1) span_out(p.g_rest + (size_t)base * kRow, rows, count);
}

// Column blockIdx.x of the camera gradient: thread t sums the blocks'
// partials [t run, (t + 1) run) in order, then a fixed shuffle tree and the
// warps in order.
__global__ void __launch_bounds__(kFoldThreads) splat_bwd_fold_kernel(const double* partials,
                                                                      int blocks, int run,
                                                                      float* g_cam) {
  const double* col = partials + (size_t)blockIdx.x * blocks;
  const int t = threadIdx.x, b0 = min(t * run, blocks), b1 = min(b0 + run, blocks);
  double s = 0.0;
#pragma unroll 8
  for (int b = b0; b < b1; ++b) s += col[b];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
  __shared__ double warp_sums[kFoldThreads / 32];
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kFoldThreads / 32; ++w) t += warp_sums[w];
    g_cam[blockIdx.x] = (float)t;
  }
}

template <int K>
int bwd_info(int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, splat_bwd_kernel<K>);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, splat_bwd_kernel<K>, kBwdBlock,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem + (int)a.sharedSizeBytes;
  out[3] = resident;
  out[4] = kBwdBlock;
  return 0;
}

}  // namespace

// blocks, smem and fold_run are the wrapper's launch geometry
// (splat_inputs_cuda.bwd_geometry); a launch whose geometry is not this
// kernel's is refused (cudaErrorInvalidValue).
extern "C" int splat_bwd(const float* means, const float* scales, const float* quats,
                         const float* dc, const float* rest, const float* opac, const float* view,
                         const float* proj, const float* cam_pos, const float* fx,
                         const float* fy, const int* deg, const float* g_xys,
                         const float* g_depths, const float* g_conics, const float* g_colors4,
                         const float* g_opac, int n, int k, int width, int proj_h, int position,
                         int antialiased, float* g_means, float* g_scales,
                         float* g_quats, float* g_dc, float* g_rest, float* g_opac_out,
                         int cam_grad, double* partials, float* g_cam, int blocks, int smem,
                         int fold_run, cudaStream_t stream) {
  if (n < 0 || blocks != (n + kBwdBlock - 1) / kBwdBlock || smem != span_smem_bytes(k) ||
      fold_run != (blocks + kFoldThreads - 1) / kFoldThreads)
    return (int)cudaErrorInvalidValue;
  BwdArgs p{means,   scales,   quats,   dc,   rest,   opac,       view,     proj,
            cam_pos, fx,       fy,      deg,  g_xys,  g_depths,   g_conics, g_colors4,
            g_opac,  n,        width,   proj_h, position, antialiased, g_means, g_scales,
            g_quats, g_dc,     g_rest,  g_opac_out, cam_grad, blocks, partials};
  if (n > 0) {
    switch (k) {
      case 1: splat_bwd_kernel<1><<<blocks, kBwdBlock, smem, stream>>>(p); break;
      case 4: splat_bwd_kernel<4><<<blocks, kBwdBlock, smem, stream>>>(p); break;
      case 9: splat_bwd_kernel<9><<<blocks, kBwdBlock, smem, stream>>>(p); break;
      case 16: splat_bwd_kernel<16><<<blocks, kBwdBlock, smem, stream>>>(p); break;
      case 25: splat_bwd_kernel<25><<<blocks, kBwdBlock, smem, stream>>>(p); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (cam_grad)
    splat_bwd_fold_kernel<<<kCamCols, kFoldThreads, 0, stream>>>(partials, blocks, fold_run,
                                                                 g_cam);
  return (int)cudaGetLastError();
}

// S2's resources at k bases and smem bytes of dynamic shared memory: out =
// {registers a thread, local (spill) bytes a thread, shared bytes a block,
// blocks resident an SM, threads a block}.
extern "C" int splat_bwd_info(int k, int smem, int* out) {
  switch (k) {
    case 1: return bwd_info<1>(smem, out);
    case 4: return bwd_info<4>(smem, out);
    case 9: return bwd_info<9>(smem, out);
    case 16: return bwd_info<16>(smem, out);
    case 25: return bwd_info<25>(smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
