// The splat-input layer's forward arithmetic, shared by S1 (splat_fwd.cu)
// and S2 (splat_bwd.cu, which recomputes it before walking it back).
//
// It is the plain version's (tinysplat_torch/ops/splat_inputs_cuda.py:
// splat_fwd_plain, i.e. ops/projection.py project_gaussians and ops/sh.py
// eval_sh) op for op: each torch op rounds once, so the sources build
// with -fmad=false and every product and sum here rounds on its own. Three
// values come from library calls in the plain version, a cuBLAS product or
// a reduction, whose order of summation is not documented. On an H100
// (torch 2.11, CUDA 12.8) the orders below reproduce them bit for bit
// (chip_smoke.py phase 17), but for the einsum:
//   means @ W^T and [means, 1] @ P^T: a fused multiply-add chain over k
//   (__fmaf_rn, the inner loop of a GEMM), the bias added after;
//   sum(q * q): (q0^2 + q2^2) + (q1^2 + q3^2), products rounded;
//   the view-direction norm: sqrt((x^2 + z^2) + y^2), products rounded;
//   the SH einsum: a fused multiply-add chain over the bases, which does
//   not reproduce cuBLAS's batched product; held to the plain version with
//   a stated bound (splat_inputs_cuda.FWD_TOL).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splat {

constexpr int kBlock = 256;   // threads a block of S1, one splat each (S2: kBwdBlock)
constexpr int kCamCols = 31;  // viewmat rows 0-2 (12), full_projmat (16), cam_pos (3)

// Python float constants become float32 as torch casts a scalar: from the
// double, never from a decimal float literal.
#define F32(x) ((float)(x))

// ops/sh.py's constants (scalars: constexpr arrays are not readable in
// device code).
constexpr double kShC0 = 0.28209479177387814;
constexpr double kShC1 = 0.4886025119029199;
constexpr double kShC2_0 = 1.0925484305920792, kShC2_1 = -1.0925484305920792,
                 kShC2_2 = 0.31539156525252005, kShC2_3 = -1.0925484305920792,
                 kShC2_4 = 0.5462742152960396;
constexpr double kShC3_0 = -0.5900435899266435, kShC3_1 = 2.890611442640554,
                 kShC3_2 = -0.4570457994644658, kShC3_3 = 0.3731763325901154,
                 kShC3_4 = -0.4570457994644658, kShC3_5 = 1.445305721320277,
                 kShC3_6 = -0.5900435899266435;
constexpr double kShC4_0 = 2.5033429417967046, kShC4_1 = -1.7701307697799304,
                 kShC4_2 = 0.9461746957575601, kShC4_3 = -0.6690465435572892,
                 kShC4_4 = 0.10578554691520431, kShC4_5 = -0.6690465435572892,
                 kShC4_6 = 0.47308734787878004, kShC4_7 = -1.7701307697799304,
                 kShC4_8 = 0.6258357354491761;
constexpr double kBlur = 0.3;        // COV2D_BLUR
constexpr double kClipThresh = 0.01; // CLIP_THRESH

// torch's NaN-propagating clamps and maximum.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float sign_of(float v) {  // torch.sign: NaN -> 0
  return (float)((0.0f < v) - (v < 0.0f));
}

struct Camera {
  float W[3][3], t[3], P[4][4], origin[3];
  float fx, fy, lim_x, lim_y, half_w, half_h, cx, cy;
  int deg;
};

// Component j of the point view directions start from: the camera
// position, or (viewdirs_mode "reference") the view matrix's translation.
__device__ __forceinline__ float view_origin(const float* view, const float* cam_pos,
                                             int position, int j) {
  return position ? __ldg(cam_pos + j) : __ldg(view + 4 * j + 3);
}

// The camera from device memory (every thread reads the same words).
// cx_off / cy_off may be null (S2 needs no principal point).
__device__ __forceinline__ Camera load_camera(const float* view, const float* proj,
                                              const float* cam_pos, const float* fx,
                                              const float* fy, const float* cx_off,
                                              const float* cy_off, const int* deg, int width,
                                              int proj_h, int position) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.W[i][j] = __ldg(view + 4 * i + j);
    c.t[i] = __ldg(view + 4 * i + 3);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) c.P[i / 4][i % 4] = __ldg(proj + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) c.origin[i] = view_origin(view, cam_pos, position, i);
  c.fx = __ldg(fx);
  c.fy = __ldg(fy);
  // tan_fov = 0.5 * size / f, which torch evaluates as reciprocal(f) * (0.5 * size).
  c.lim_x = F32(1.3) * ((1.0f / c.fx) * F32(0.5 * width));
  c.lim_y = F32(1.3) * ((1.0f / c.fy) * F32(0.5 * proj_h));
  c.half_w = F32(0.5 * (double)width);
  c.half_h = F32(0.5 * (double)proj_h);
  c.cx = cx_off ? __ldg(cx_off) + F32(width / 2.0) : 0.0f;
  c.cy = cy_off ? __ldg(cy_off) + F32(proj_h / 2.0) : 0.0f;
  c.deg = __ldg(deg);
  return c;
}

// SH band of basis k.
__host__ __device__ constexpr int band_of(int k) {
  return k < 1 ? 0 : k < 4 ? 1 : k < 9 ? 2 : k < 16 ? 3 : 4;
}

// ops/sh.py sh_basis, op for op.
template <int K>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* o) {
  o[0] = F32(kShC0);
  if (K > 1) {
    o[1] = F32(-kShC1) * y;
    o[2] = F32(kShC1) * z;
    o[3] = F32(-kShC1) * x;
  }
  if (K > 4) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    o[4] = F32(kShC2_0) * xy;
    o[5] = F32(kShC2_1) * yz;
    o[6] = F32(kShC2_2) * ((2.0f * zz - xx) - yy);
    o[7] = F32(kShC2_3) * xz;
    o[8] = F32(kShC2_4) * (xx - yy);
    if (K > 9) {
      o[9] = (F32(kShC3_0) * y) * (3.0f * xx - yy);
      o[10] = (F32(kShC3_1) * xy) * z;
      o[11] = (F32(kShC3_2) * y) * ((4.0f * zz - xx) - yy);
      o[12] = (F32(kShC3_3) * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      o[13] = (F32(kShC3_4) * x) * ((4.0f * zz - xx) - yy);
      o[14] = (F32(kShC3_5) * z) * (xx - yy);
      o[15] = (F32(kShC3_6) * x) * (xx - 3.0f * yy);
    }
    if (K > 16) {
      o[16] = (F32(kShC4_0) * xy) * (xx - yy);
      o[17] = (F32(kShC4_1) * yz) * (3.0f * xx - yy);
      o[18] = (F32(kShC4_2) * xy) * (7.0f * zz - 1.0f);
      o[19] = (F32(kShC4_3) * yz) * (7.0f * zz - 3.0f);
      o[20] = F32(kShC4_4) * (zz * (35.0f * zz - 30.0f) + 3.0f);
      o[21] = (F32(kShC4_5) * xz) * (7.0f * zz - 3.0f);
      o[22] = (F32(kShC4_6) * (xx - yy)) * (7.0f * zz - 1.0f);
      o[23] = (F32(kShC4_7) * xz) * (xx - 3.0f * yy);
      o[24] = F32(kShC4_8) * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

// The forward in pieces, each the plain version's ops in its order. S1
// calls them all; S2 calls them phase by phase (view direction and colour
// first, then the geometry), so that what it holds live at once stays small
// and every branch it recomputes falls as it fell in S1.

// The 3D covariance: exp of the log-scales, the normalised quaternion, its
// rotation R, M = R diag(s) and Sigma = M M^T.
struct Cov3 {
  float s[3], q[4], ss, nrm, qn[4];
  float R[3][3], M[3][3], Sig[3][3];
};

__device__ __forceinline__ void covariance(Cov3& c, const float* scales, const float* quats,
                                           int i) {
#pragma unroll
  for (int j = 0; j < 3; ++j) c.s[j] = expf(scales[3 * i + j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) c.q[j] = quats[4 * i + j];
  c.ss = (c.q[0] * c.q[0] + c.q[2] * c.q[2]) + (c.q[1] * c.q[1] + c.q[3] * c.q[3]);
  c.nrm = sqrtf(clamp_min(c.ss, F32(1e-24)));
#pragma unroll
  for (int j = 0; j < 4; ++j) c.qn[j] = c.q[j] / c.nrm;
  const float w = c.qn[0], x = c.qn[1], y = c.qn[2], z = c.qn[3];
  c.R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  c.R[0][1] = 2.0f * (x * y - w * z);
  c.R[0][2] = 2.0f * (x * z + w * y);
  c.R[1][0] = 2.0f * (x * y + w * z);
  c.R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  c.R[1][2] = 2.0f * (y * z - w * x);
  c.R[2][0] = 2.0f * (x * z - w * y);
  c.R[2][1] = 2.0f * (y * z + w * x);
  c.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j) c.M[r][j] = c.R[r][j] * c.s[j];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = r; j < 3; ++j)
      c.Sig[r][j] = c.Sig[j][r] =
          (c.M[r][0] * c.M[j][0] + c.M[r][1] * c.M[j][1]) + c.M[r][2] * c.M[j][2];
}

// The mean in camera space, the clamped projection's Jacobian rows T = J W
// (jacobian), then the blurred 2D covariance (a, b; b, c) T Sigma T^T and
// its inverse determinant (conic2d).
struct Proj {
  float tz;  // camera z (the depth)
  bool tz_small;
  float tzw, qxr, qyr, cxr, cyr, txc, tyc, rz, rz2, j00, j02, j11, j12;
  float t0[3], t1[3], u0[3], u1[3];
  float a, b, c, det, invd;
  bool inv;
};

__device__ __forceinline__ void jacobian(Proj& f, const Camera& cam, const float* m) {
  // means @ W^T + t
  float mc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    mc[r] = __fmaf_rn(m[2], cam.W[r][2], __fmaf_rn(m[1], cam.W[r][1], m[0] * cam.W[r][0])) +
            cam.t[r];
  f.tz = mc[2];
  f.tz_small = fabsf(f.tz) < F32(1e-8);
  f.tzw = f.tz_small ? F32(1e-8) : f.tz;
  f.qxr = mc[0] / f.tzw;
  f.qyr = mc[1] / f.tzw;
  f.cxr = clamp_to(f.qxr, -cam.lim_x, cam.lim_x);
  f.cyr = clamp_to(f.qyr, -cam.lim_y, cam.lim_y);
  f.txc = f.cxr * f.tzw;
  f.tyc = f.cyr * f.tzw;
  f.rz = 1.0f / f.tzw;
  f.rz2 = f.rz * f.rz;
  f.j00 = cam.fx * f.rz;
  f.j02 = (-cam.fx * f.txc) * f.rz2;
  f.j11 = cam.fy * f.rz;
  f.j12 = (-cam.fy * f.tyc) * f.rz2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.t0[k] = f.j00 * cam.W[0][k] + f.j02 * cam.W[2][k];
    f.t1[k] = f.j11 * cam.W[1][k] + f.j12 * cam.W[2][k];
  }
}

__device__ __forceinline__ void conic2d(Proj& f, const Cov3& cov) {
  const float(&Sig)[3][3] = cov.Sig;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.u0[k] = (Sig[k][0] * f.t0[0] + Sig[k][1] * f.t0[1]) + Sig[k][2] * f.t0[2];
    f.u1[k] = (Sig[k][0] * f.t1[0] + Sig[k][1] * f.t1[1]) + Sig[k][2] * f.t1[2];
  }
  f.a = ((f.t0[0] * f.u0[0] + f.t0[1] * f.u0[1]) + f.t0[2] * f.u0[2]) + F32(kBlur);
  f.b = (f.t0[0] * f.u1[0] + f.t0[1] * f.u1[1]) + f.t0[2] * f.u1[2];
  f.c = ((f.t1[0] * f.u1[0] + f.t1[1] * f.u1[1]) + f.t1[2] * f.u1[2]) + F32(kBlur);
  f.det = f.a * f.c - f.b * f.b;
  f.inv = f.det > 0.0f;
  f.invd = 1.0f / (f.inv ? f.det : 1.0f);
}

// [means, 1] @ P^T (rows 0, 1, 3) and the perspective divide's factor.
struct Screen {
  float h0, h1, h3, h3a, rcp, sg, rw;
};

__device__ __forceinline__ void screen(Screen& f, const Camera& cam, const float* m) {
  float h[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    h[r] = __fmaf_rn(1.0f, cam.P[r][3],
                     __fmaf_rn(m[2], cam.P[r][2], __fmaf_rn(m[1], cam.P[r][1], m[0] * cam.P[r][0])));
  f.h0 = h[0];
  f.h1 = h[1];
  f.h3 = h[3];
  f.h3a = fabsf(f.h3);
  f.rcp = 1.0f / clamp_min(f.h3a, F32(1e-6));
  f.sg = sign_of(f.h3 + F32(1e-30));
  f.rw = f.rcp * f.sg;
}

// The unit view direction from the origin.
struct View {
  float dirs[3], n, nc, d[3];
};

__device__ __forceinline__ void view_dir(View& f, const float* origin, const float* m) {
#pragma unroll
  for (int j = 0; j < 3; ++j) f.dirs[j] = m[j] - origin[j];
  f.n = sqrtf((f.dirs[0] * f.dirs[0] + f.dirs[2] * f.dirs[2]) + f.dirs[1] * f.dirs[1]);
  f.nc = clamp_min(f.n, F32(1e-12));
#pragma unroll
  for (int j = 0; j < 3; ++j) f.d[j] = f.dirs[j] / f.nc;
}

// The SH bases at unit direction d, zero above the active degree.
template <int K>
__device__ __forceinline__ void masked_basis(const float* d, int deg, float* basis) {
  sh_basis<K>(d[0], d[1], d[2], basis);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (band_of(k) > deg) basis[k] = 0.0f;
}

// The SH colour + 0.5: a fused multiply-add chain over the bases in
// increasing k. dc holds the splat's 3 DC coefficients, rest its (K - 1) x 3
// others (in device or shared memory).
template <int K>
__device__ __forceinline__ void sh_colour(const float* basis, const float* dc, const float* rest,
                                          float* v) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = basis[0] * dc[ch];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = __fmaf_rn(basis[k], rest[3 * (k - 1) + ch], acc);
    v[ch] = acc + 0.5f;
  }
}

__device__ __forceinline__ float sigmoid(float logit) { return 1.0f / (1.0f + expf(-logit)); }

// render.antialias_compensation of the conic (c*invd, -b*invd, a*invd).
struct Comp {
  float cA, cB, cC, det_c, safe, qA, qB, qC, x1, x2, det_o, ratio, comp_s, comp;
};

__device__ __forceinline__ Comp compensation(float a, float b, float c, float invd) {
  Comp k;
  k.cA = c * invd;
  k.cB = -b * invd;
  k.cC = a * invd;
  k.det_c = k.cA * k.cC - k.cB * k.cB;
  k.safe = clamp_min(k.det_c, F32(1e-12));
  k.qA = k.cA / k.safe;
  k.qB = k.cB / k.safe;
  k.qC = k.cC / k.safe;
  k.x1 = k.qC - F32(kBlur);
  k.x2 = k.qA - F32(kBlur);
  k.det_o = k.x1 * k.x2 - k.qB * k.qB;
  k.ratio = k.det_o * k.safe;
  k.comp_s = sqrtf(clamp_to(k.ratio, F32(1e-8), 1.0f));
  k.comp = k.det_c > 0.0f ? k.comp_s : 0.0f;
  return k;
}

}  // namespace splat
