// density_fwd / density_bwd: SuGaR's density term (Guedon & Lepetit 2023,
// eqs. 1 + 5) over the probe's S points and their K nearest splats, and its
// gradient into the splats' rows and the rendered depth map.
//
// Replaces no TPU kernel: tinysplat_tpu/regularizers/density.py
// `density_loss` is plain jnp, which XLA fuses. The port ran it as ~110
// torch ops forward and as many backward, each over the (S, K) pairs, and
// autograd added the gathers' gradients back with a sorted index_put_ (the
// plain version, regularizers/density.py). What it computes, for a point p
// and its neighbours j = idx[s, k]:
//
//   mu = p - m_j,  qn = q_j / max(|q_j|, 1e-12),  R = rotmat(qn)
//   Q_k = clamp(sum_a (R^T mu)_a^2 exp(-2 s_ja), 0, 1e8)
//   d = sum_k sigmoid(o_j) exp(-Q_k / 2), set to 1 + 1e-12 (1 in float32) where d > 1
//   beta = mean_k min_a exp(s_ja)
//   p projected by the camera (the renderer's principal-point offset);
//   mask = z > 0.001 and the pixel inside [0, W - 1] x [0, H - 1];
//   sdf_hat = bilinear(depth, px, py), border clamped, - z
//   err = |d - exp(-sdf_hat^2 / (2 clamp(beta, 1e-9)^2))|                 (density)
//       = |beta sqrt(-2 log clamp(d, 0.001, 0.999)) - sdf_hat|              (SDF)
//   loss = sum of err over the masked points / max(their count, 1)
//
// Every product and sum is its own float32 operation, in the plain
// version's order where one op is one torch op (built with -fmad=false, as
// the splat-input kernels are), so the two agree to a few ulps a value.
//
// The forward: 16 lanes a point, lane l takes neighbours l, l + 16, ...,
// gathers each row once (means 3, quats 4, scales 3, opacity 1: 44 bytes
// and the 8-byte index) and the lanes add d and beta's sum by an xor
// butterfly, which leaves the same bits in every lane. Lane 0 projects the
// point, reads the 4 depth taps and forms err. The block's 16 points are
// added in a fixed order into one partial (sum, count) a block, and one
// small block adds the partials in a fixed order and writes the loss and
// the denominator: the loss repeats bit for bit from call to call and the
// host reads nothing.
//
// The backward takes the upstream gradient and the denominator from device
// memory, recomputes a point's pairs from the same inputs (the forward saves
// no per-point value), and adds each neighbour's 11 gradient values into a
// zeroed (N, 12) buffer, a row [means 3, opacity 1 | quats 4 | scales 3, 0],
// with three 16-byte vector reductions (atomicAdd on float4, sm_90:
// `red.global.add.v4.f32`); lane 0 adds a masked point's 4 depth taps into
// a zeroed (H, W) map with scalar atomics (coincident border taps both add,
// as index_put_ does). The scales take exp(-2 s)'s path and beta's: the
// mean over K, amin's gradient split evenly over the axes tied at the
// minimum (as torch.amin's backward), exp's. No sort, and no per-pair value
// in device memory. Where the camera carries a gradient (pose_opt), lane 0
// also forms the point's d(loss)/d(viewmat, projmat, cx_off, cy_off), 34
// floats, through the projection and the bilinear lookup; a block adds its
// 16 points' in a fixed order into one partial row, and a second small
// kernel adds the rows column by column in a fixed order, so the camera's
// gradient repeats bit for bit. The adds come in an order that changes from launch to
// launch: a row that m pairs reach differs from the float64 sum of the same
// pieces by at most 1.001 (m - 1) 2^-24 x the sum of their |pieces|
// + m 2^-126 (the atomics flush subnormals to 0), and so does a depth tap
// from its pieces.
//
// What bounds it on an H100: bytes. At the benchmark's 100,000 points x 16
// neighbours over 262,144 splats each pass reads 52 B a pair (83 MB) from a
// 11.5 MB table that stays in the 50 MB L2; the backward writes 48 B a pair
// into the (N, 12) buffer (12.6 MB) and 16 B a point into the depth map.
// Index loads of one group are one 128-byte line; its 16 row loads are
// independent, so a warp has 32 in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 16;  // lanes a point
constexpr int kThreads = 256;
constexpr int kPoints = kThreads / kGroup;  // points a block
constexpr int kFinalThreads = 256;
constexpr int kRow = 12;  // floats of a splat's gradient row
constexpr int kCam = 34;  // floats of the camera's gradient: viewmat 16, projmat 16, cx, cy
constexpr unsigned kFull = 0xffffffffu;

struct Splats {
  const float* means;   // (n, 3)
  const float4* quats;  // (n, 4)
  const float* scales;  // (n, 3), log
  const float* opac;    // (n, 1), logit
  int n;
};

struct View {
  const float* depth;  // (dh, dw), strides sy, sx in floats
  long long sy, sx;
  int dh, dw;
  const float* view;  // (4, 4) world -> camera, row-major
  const float* proj;  // (4, 4) camera -> clip
  const float* cx_off;
  const float* cy_off;
  int img_h, img_w;
};

// One (point, neighbour) pair's forward values.
struct Pair {
  float mu[3];  // p - m
  float q[4];   // the stored quaternion
  float nrm;    // |q|
  float qn[4];  // q / max(|q|, 1e-12)
  float R[3][3];
  float rt[3];   // R^T mu
  float is2[3];  // exp(-2 s)
  float es[3];   // exp(s)
  float qraw;    // sum_a rt_a^2 is2_a
  float e;       // exp(-0.5 clamp(qraw, 0, 1e8))
  float op;      // sigmoid(o)
};

__device__ __forceinline__ void load_pair(const float p[3], int j, const Splats& sp, Pair& P) {
  const float* m = sp.means + 3LL * j;
  const float4 q = __ldg(sp.quats + j);
  const float* s = sp.scales + 3LL * j;
  const float o = __ldg(sp.opac + j);
#pragma unroll
  for (int i = 0; i < 3; ++i) P.mu[i] = p[i] - __ldg(m + i);
  P.q[0] = q.x; P.q[1] = q.y; P.q[2] = q.z; P.q[3] = q.w;
  P.nrm = sqrtf((q.x * q.x + q.y * q.y) + (q.z * q.z + q.w * q.w));
  const float c = fmaxf(P.nrm, 1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) P.qn[i] = P.q[i] / c;
  const float w = P.qn[0], x = P.qn[1], y = P.qn[2], z = P.qn[3];
  P.R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  P.R[0][1] = 2.0f * (x * y - w * z);
  P.R[0][2] = 2.0f * (x * z + w * y);
  P.R[1][0] = 2.0f * (x * y + w * z);
  P.R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  P.R[1][2] = 2.0f * (y * z - w * x);
  P.R[2][0] = 2.0f * (x * z - w * y);
  P.R[2][1] = 2.0f * (y * z + w * x);
  P.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
  float qraw = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    P.rt[a] = (P.R[0][a] * P.mu[0] + P.R[1][a] * P.mu[1]) + P.R[2][a] * P.mu[2];
    const float sa = __ldg(s + a);
    P.is2[a] = expf(-2.0f * sa);
    P.es[a] = expf(sa);
    qraw = qraw + P.rt[a] * P.rt[a] * P.is2[a];
  }
  P.qraw = qraw;
  P.e = expf(-0.5f * fminf(fmaxf(qraw, 0.0f), 1e8f));
  P.op = 1.0f / (1.0f + expf(-o));
}

__device__ __forceinline__ float min3(const float v[3]) {
  return fminf(fminf(v[0], v[1]), v[2]);
}

// The sum over a point's 16 lanes, the same bits in every lane.
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o, kGroup);
  return v;
}

__device__ __forceinline__ int neighbour(const long long* idx, long long s, int K, int k, int n) {
  const long long j = __ldg(idx + s * K + k);
  if (j < 0 || j >= n) __trap();  // as torch's index check: an index past the table is fatal
  return static_cast<int>(j);
}

// d (before the > 1 rule) and beta of point s, in every lane of its group.
// A lane past the points (s >= S) adds nothing and gives 0s.
__device__ __forceinline__ void point_sums(const float p[3], const long long* idx, long long s,
                                           bool valid, int K, int lane, const Splats& sp,
                                           float& d_raw, float& beta) {
  float dl = 0.0f, bl = 0.0f;
  if (valid) {
    for (int k = lane; k < K; k += kGroup) {
      Pair P;
      load_pair(p, neighbour(idx, s, K, k, sp.n), sp, P);
      dl = dl + P.e * P.op;
      bl = bl + min3(P.es);
    }
  }
  d_raw = group_sum(dl);
  beta = group_sum(bl) / static_cast<float>(K);
}

// The point's projection and depth lookup (lane 0 of a group).
struct Look {
  bool mask;
  float z, sdf_hat;
  long long tap[4];  // y * dw + x of the taps, into a contiguous (dh, dw) map
  float fx, fy;
  // What the camera's gradient reads: camera-space point, clip-space point,
  // max(|w|, 1e-9), sign(w), the pixel before the clamp, the taps' depths.
  float cam[3], hom[4], aw, sg, px, py, I[4];
};

__device__ __forceinline__ Look look(const float p[3], const View& v) {
  Look L;
  float cam[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* r = v.view + 4 * i;
    cam[i] = ((p[0] * __ldg(r) + p[1] * __ldg(r + 1)) + p[2] * __ldg(r + 2)) + __ldg(r + 3);
    L.cam[i] = cam[i];
  }
  L.z = cam[2];
  float* hom = L.hom;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* r = v.proj + 4 * i;
    hom[i] = ((cam[0] * __ldg(r) + cam[1] * __ldg(r + 1)) + cam[2] * __ldg(r + 2)) + __ldg(r + 3);
  }
  const float w = hom[3];
  const float aw = fmaxf(fabsf(w), 1e-9f);
  const float sg = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  L.aw = aw;
  L.sg = sg;
  const float W = static_cast<float>(v.img_w), H = static_cast<float>(v.img_h);
  const float px = ((0.5f * W * ((hom[0] / aw) * sg) + W / 2.0f) + __ldg(v.cx_off)) - 0.5f;
  const float py = ((0.5f * H * ((hom[1] / aw) * sg) + H / 2.0f) + __ldg(v.cy_off)) - 0.5f;
  L.px = px;
  L.py = py;
  L.mask = L.z > 0.001f && px >= 0.0f && px <= W - 1.0f && py >= 0.0f && py <= H - 1.0f;
  const float wm = static_cast<float>(v.dw - 1), hm = static_cast<float>(v.dh - 1);
  const float x = fminf(fmaxf(px, 0.0f), wm), y = fminf(fmaxf(py, 0.0f), hm);
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = fminf(x0 + 1.0f, wm), y1 = fminf(y0 + 1.0f, hm);
  L.fx = x - x0;
  L.fy = y - y0;
  const long long xi[2] = {static_cast<long long>(x0), static_cast<long long>(x1)};
  const long long yi[2] = {static_cast<long long>(y0), static_cast<long long>(y1)};
  float* I = L.I;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const long long yy = yi[t >> 1], xx = xi[t & 1];
    L.tap[t] = yy * v.dw + xx;
    I[t] = __ldg(v.depth + yy * v.sy + xx * v.sx);
  }
  const float gx = 1.0f - L.fx, gy = 1.0f - L.fy;
  const float B = ((I[0] * gx * gy + I[1] * L.fx * gy) + I[2] * gx * L.fy) + I[3] * L.fx * L.fy;
  L.sdf_hat = B - L.z;
  return L;
}

__device__ __forceinline__ float sgnf(float v) { return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f); }

__device__ __forceinline__ float clamp_beta(float beta) { return fmaxf(beta, 1e-9f); }

__device__ __forceinline__ float sdf_root(float d) {
  return sqrtf(-2.0f * logf(fminf(fmaxf(d, 0.001f), 0.999f)));
}

__device__ __forceinline__ float point_error(float d, float beta, float sdf_hat, bool sdf) {
  if (sdf) return fabsf(beta * sdf_root(d) - sdf_hat);
  const float bc = clamp_beta(beta);
  const float d_hat = expf((-0.5f * (sdf_hat * sdf_hat)) / (bc * bc));
  return fabsf(d - d_hat);
}

__device__ __forceinline__ void load_point(const float* points, long long s, float p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = __ldg(points + 3 * s + i);
}

__global__ void __launch_bounds__(kThreads)
density_fwd_kernel(const float* __restrict__ points, const long long* __restrict__ idx,
                   long long S, int K, Splats sp, View v, int use_sdf,
                   float* __restrict__ part_sum, int* __restrict__ part_count) {
  __shared__ float errs[kPoints];
  __shared__ int masks[kPoints];
  const int lane = threadIdx.x % kGroup, slot = threadIdx.x / kGroup;
  const long long s = static_cast<long long>(blockIdx.x) * kPoints + slot;
  const bool valid = s < S;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (valid) load_point(points, s, p);
  float d_raw, beta;
  point_sums(p, idx, s, valid, K, lane, sp, d_raw, beta);
  if (lane == 0) {
    float err = 0.0f;
    int m = 0;
    if (valid) {
      const Look L = look(p, v);
      if (L.mask) {
        const float d = d_raw > 1.0f ? 1.0f : d_raw;
        err = point_error(d, beta, L.sdf_hat, use_sdf != 0);
        m = 1;
      }
    }
    errs[slot] = err;
    masks[slot] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    int count = 0;
    for (int i = 0; i < kPoints; ++i) {
      sum = sum + errs[i];
      count += masks[i];
    }
    part_sum[blockIdx.x] = sum;
    part_count[blockIdx.x] = count;
  }
}

// One block: the partials in a fixed order, then loss = sum / max(count, 1).
__global__ void __launch_bounds__(kFinalThreads)
density_final_kernel(const float* __restrict__ part_sum, const int* __restrict__ part_count,
                     long long blocks, float* __restrict__ loss, float* __restrict__ denom) {
  __shared__ float sums[kFinalThreads];
  __shared__ long long counts[kFinalThreads];
  float sum = 0.0f;
  long long count = 0;
  for (long long b = threadIdx.x; b < blocks; b += kFinalThreads) {
    sum = sum + part_sum[b];
    count += part_count[b];
  }
  sums[threadIdx.x] = sum;
  counts[threadIdx.x] = count;
  __syncthreads();
  for (int half = kFinalThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      sums[threadIdx.x] = sums[threadIdx.x] + sums[threadIdx.x + half];
      counts[threadIdx.x] += counts[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float dn = fmaxf(static_cast<float>(counts[0]), 1.0f);
    *denom = dn;
    *loss = sums[0] / dn;
  }
}

// A masked point's upstream values from d(loss)/d(err) (derr): d(loss)/d(d
// before the > 1 rule), d(loss)/d(beta) and d(loss)/d(sdf_hat), as autograd's
// chain through the plain version's ops gives them.
struct Upstream {
  float dd, dbeta, dsdf_hat;
};

__device__ __forceinline__ Upstream point_upstream(float d_raw, float beta, float sdf_hat,
                                                   float derr, bool sdf) {
  Upstream u;
  const bool clipped = d_raw > 1.0f;
  const float d = clipped ? 1.0f : d_raw;
  float dd;
  if (sdf) {  // err = |beta r - sdf_hat|, r = sqrt(-2 log clamp(d, 0.001, 0.999))
    const float r = sdf_root(d);
    const float t = derr * sgnf(beta * r - sdf_hat);
    u.dsdf_hat = -t;
    u.dbeta = t * r;
    const float dlg = ((t * beta) / (2.0f * r)) * -2.0f;
    dd = (d >= 0.001f && d <= 0.999f) ? dlg / fminf(fmaxf(d, 0.001f), 0.999f) : 0.0f;
  } else {  // err = |d - exp(t2 / t3)|, t2 = -0.5 sdf_hat^2, t3 = clamp(beta, 1e-9)^2
    const float bc = clamp_beta(beta);
    const float t2 = -0.5f * (sdf_hat * sdf_hat), t3 = bc * bc;
    const float d_hat = expf(t2 / t3);
    const float t = derr * sgnf(d - d_hat);
    dd = t;
    const float du = -t * d_hat;
    u.dbeta = beta >= 1e-9f ? (-du * ((t2 / t3) / t3)) * (2.0f * bc) : 0.0f;
    u.dsdf_hat = ((du / t3) * -0.5f) * (2.0f * sdf_hat);
  }
  u.dd = clipped ? 0.0f : dd;
  return u;
}

// d(loss)/d(the pair's splat row), given d(loss)/d(d before the > 1 rule)
// (dd) and d(loss)/d(beta) (dbeta), as autograd's chain through the plain
// version's ops gives it.
__device__ __forceinline__ void pair_grad(const Pair& P, float dd, float dbeta, int K,
                                          float g[11]) {
  // c = exp(-0.5 Q) * sigmoid(o); d = sum_k c.
  const float de = dd * P.op;
  const float dop = dd * P.e;
  const float dq = (de * P.e) * -0.5f;
  const float dqraw = (P.qraw >= 0.0f && P.qraw <= 1e8f) ? dq : 0.0f;
  float drt[3], ds[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float drr = dqraw * P.is2[a];
    const float dis2 = dqraw * (P.rt[a] * P.rt[a]);
    drt[a] = drr * P.rt[a] + drr * P.rt[a];
    ds[a] = (dis2 * P.is2[a]) * -2.0f;
  }
  // beta = mean_k amin_a exp(s): split evenly over the tied axes.
  const float mn = min3(P.es);
  const int ties = (P.es[0] == mn) + (P.es[1] == mn) + (P.es[2] == mn);
  const float dmin = (dbeta / static_cast<float>(K)) / static_cast<float>(ties);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if (P.es[a] == mn) ds[a] = ds[a] + dmin * P.es[a];
  // rt_a = sum_i R[i][a] mu_i; mu = p - m.
  float H[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] = -((drt[0] * P.R[i][0] + drt[1] * P.R[i][1]) + drt[2] * P.R[i][2]);
  #pragma unroll
    for (int a = 0; a < 3; ++a) H[i][a] = 2.0f * (drt[a] * P.mu[i]);
  }
  // R = rotmat(qn), H = 2 dL/dR.
  const float w = P.qn[0], x = P.qn[1], y = P.qn[2], z = P.qn[3];
  float dqn[4];
  dqn[0] = ((-z * H[0][1] + y * H[0][2]) + (z * H[1][0] - x * H[1][2])) +
           (-y * H[2][0] + x * H[2][1]);
  dqn[1] = ((y * H[0][1] + z * H[0][2]) + (y * H[1][0] - 2.0f * x * H[1][1])) +
           ((-w * H[1][2] + z * H[2][0]) + (w * H[2][1] - 2.0f * x * H[2][2]));
  dqn[2] = ((-2.0f * y * H[0][0] + x * H[0][1]) + (w * H[0][2] + x * H[1][0])) +
           ((z * H[1][2] - w * H[2][0]) + (z * H[2][1] - 2.0f * y * H[2][2]));
  dqn[3] = ((-2.0f * z * H[0][0] - w * H[0][1]) + (x * H[0][2] + w * H[1][0])) +
           ((-2.0f * z * H[1][1] + y * H[1][2]) + (x * H[2][0] + y * H[2][1]));
  // qn = q / max(|q|, 1e-12).
  const float c = fmaxf(P.nrm, 1e-12f);
  float dc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) dc = dc - dqn[i] * ((P.q[i] / c) / c);
  const float dn = P.nrm >= 1e-12f ? dc / P.nrm : 0.0f;
  // g: means 0-2, opacity 3, quats 4-7, scales 8-10.
  g[3] = (dop * (1.0f - P.op)) * P.op;
#pragma unroll
  for (int i = 0; i < 4; ++i) g[4 + i] = dqn[i] / c + P.q[i] * dn;
#pragma unroll
  for (int a = 0; a < 3; ++a) g[8 + a] = ds[a];
}

// d(loss)/d(the camera) of a masked point, [viewmat 16 | projmat 16 | cx_off,
// cy_off] row-major, from d(loss)/d(sdf_hat) (dsh), as autograd's chain
// through approximate_density's ops gives it: sdf_hat = B(x, y) - z with x =
// clamp(px, 0, dw - 1) (its gradient passes on the closed range), B's
// weights from x - floor(x); px = W/2 ndc_x + W/2 + cx_off - 0.5 (py alike);
// ndc = hom_xy / max(|w|, 1e-9) sign(w); hom = P [cam, 1]; cam = V [p, 1].
// The mask and the floors carry none.
__device__ __forceinline__ void camera_grad(const float p[3], const Look& L, const View& v,
                                            float dsh, float* out) {
  const float gx = 1.0f - L.fx, gy = 1.0f - L.fy;
  const float dbx = (L.I[1] - L.I[0]) * gy + (L.I[3] - L.I[2]) * L.fy;
  const float dby = (L.I[2] - L.I[0]) * gx + (L.I[3] - L.I[1]) * L.fx;
  const float wm = static_cast<float>(v.dw - 1), hm = static_cast<float>(v.dh - 1);
  const float dpx = (L.px >= 0.0f && L.px <= wm) ? dsh * dbx : 0.0f;
  const float dpy = (L.py >= 0.0f && L.py <= hm) ? dsh * dby : 0.0f;
  const float dnx = (dpx * (0.5f * static_cast<float>(v.img_w))) * L.sg;
  const float dny = (dpy * (0.5f * static_cast<float>(v.img_h))) * L.sg;
  float dhom[4];
  dhom[0] = dnx / L.aw;
  dhom[1] = dny / L.aw;
  dhom[2] = 0.0f;
  const float daw = -((dnx * L.hom[0] + dny * L.hom[1]) / L.aw) / L.aw;
  dhom[3] = fabsf(L.hom[3]) >= 1e-9f ? daw * L.sg : 0.0f;
  const float ch[4] = {L.cam[0], L.cam[1], L.cam[2], 1.0f};
  float dcam[3] = {0.0f, 0.0f, -dsh};  // sdf_hat's - z
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* r = v.proj + 4 * i;
  #pragma unroll
    for (int j = 0; j < 4; ++j) out[16 + 4 * i + j] = dhom[i] * ch[j];
  #pragma unroll
    for (int j = 0; j < 3; ++j) dcam[j] = dcam[j] + dhom[i] * __ldg(r + j);
  }
  const float ph[4] = {p[0], p[1], p[2], 1.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
  #pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * i + j] = dcam[i] * ph[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) out[12 + j] = 0.0f;
  out[32] = dpx;
  out[33] = dpy;
}

__device__ __forceinline__ void add_row(float* rows, int j, const float g[11]) {
  float4* r = reinterpret_cast<float4*>(rows + static_cast<long long>(j) * kRow);
  atomicAdd(r, make_float4(g[0], g[1], g[2], g[3]));
  atomicAdd(r + 1, make_float4(g[4], g[5], g[6], g[7]));
  atomicAdd(r + 2, make_float4(g[8], g[9], g[10], 0.0f));
}

__global__ void __launch_bounds__(kThreads)
density_bwd_kernel(const float* __restrict__ points, const long long* __restrict__ idx,
                   long long S, int K, Splats sp, View v, int use_sdf,
                   const float* __restrict__ upstream, const float* __restrict__ denom,
                   float* __restrict__ rows, float* __restrict__ grad_depth,
                   float* __restrict__ cam_part) {
  __shared__ float cams[kPoints][kCam];
  const int lane = threadIdx.x % kGroup, slot = threadIdx.x / kGroup;
  const long long s = static_cast<long long>(blockIdx.x) * kPoints + slot;
  const bool valid = s < S;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (valid) load_point(points, s, p);
  float d_raw, beta;
  point_sums(p, idx, s, valid, K, lane, sp, d_raw, beta);
  // Lane 0: the point's upstream values, d(loss)/d(d_raw) and d(loss)/d(beta).
  float dd = 0.0f, dbeta = 0.0f;
  int live = 0;
  if (lane == 0 && cam_part != nullptr) {
#pragma unroll
    for (int c = 0; c < kCam; ++c) cams[slot][c] = 0.0f;
  }
  if (lane == 0 && valid) {
    const Look L = look(p, v);
    if (L.mask) {
      live = 1;
      const Upstream u = point_upstream(d_raw, beta, L.sdf_hat,
                                        __ldg(upstream) / __ldg(denom), use_sdf != 0);
      dd = u.dd;
      dbeta = u.dbeta;
      if (grad_depth != nullptr) {  // sdf_hat = bilinear(depth) - z
        const float gx = 1.0f - L.fx, gy = 1.0f - L.fy;
        atomicAdd(grad_depth + L.tap[0], (u.dsdf_hat * gy) * gx);
        atomicAdd(grad_depth + L.tap[1], (u.dsdf_hat * gy) * L.fx);
        atomicAdd(grad_depth + L.tap[2], (u.dsdf_hat * L.fy) * gx);
        atomicAdd(grad_depth + L.tap[3], (u.dsdf_hat * L.fy) * L.fx);
      }
      if (cam_part != nullptr) camera_grad(p, L, v, u.dsdf_hat, cams[slot]);
    }
  }
  if (cam_part != nullptr) {  // the block's 16 points in a fixed order
    __syncthreads();
    if (threadIdx.x < kCam) {
      float sum = 0.0f;
      for (int i = 0; i < kPoints; ++i) sum = sum + cams[i][threadIdx.x];
      cam_part[static_cast<long long>(blockIdx.x) * kCam + threadIdx.x] = sum;
    }
  }
  live = __shfl_sync(kFull, live, 0, kGroup);
  dd = __shfl_sync(kFull, dd, 0, kGroup);
  dbeta = __shfl_sync(kFull, dbeta, 0, kGroup);
  if (!live || rows == nullptr) return;
  for (int k = lane; k < K; k += kGroup) {
    const int j = neighbour(idx, s, K, k, sp.n);
    Pair P;
    load_pair(p, j, sp, P);
    float g[11];
    pair_grad(P, dd, dbeta, K, g);
    add_row(rows, j, g);
  }
}

// Block c: column c of the blocks' camera rows in a fixed order.
__global__ void __launch_bounds__(kFinalThreads)
density_camera_final_kernel(const float* __restrict__ cam_part, long long blocks,
                            float* __restrict__ cam_grad) {
  __shared__ float sums[kFinalThreads];
  float sum = 0.0f;
  for (long long b = threadIdx.x; b < blocks; b += kFinalThreads)
    sum = sum + cam_part[b * kCam + blockIdx.x];
  sums[threadIdx.x] = sum;
  __syncthreads();
  for (int half = kFinalThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] = sums[threadIdx.x] + sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) cam_grad[blockIdx.x] = sums[0];
}

Splats splats(const float* means, const float* quats, const float* scales, const float* opac,
              int n) {
  return Splats{means, reinterpret_cast<const float4*>(quats), scales, opac, n};
}

View view_of(const float* depth, long long sy, long long sx, int dh, int dw, const float* view,
             const float* proj, const float* cx_off, const float* cy_off, int img_h, int img_w) {
  return View{depth, sy, sx, dh, dw, view, proj, cx_off, cy_off, img_h, img_w};
}

unsigned blocks_for(long long S) { return static_cast<unsigned>((S + kPoints - 1) / kPoints); }

}  // namespace

// points (S, 3) f32; idx (S, K) int64, each in [0, n); means (n, 3), quats
// (n, 4) 16-byte aligned, scales (n, 3), opac (n, 1) f32, all contiguous;
// depth (dh, dw) f32 at element strides sy, sx; view, proj (4, 4) f32
// row-major; cx_off, cy_off one f32 each; part_sum / part_count one a block
// of 16 points (ceil(S / 16), at least 1); loss and denom one f32 each.
// Returns cudaGetLastError().
extern "C" int density_fwd(const float* points, const long long* idx, long long S, int K,
                           const float* means, const float* quats, const float* scales,
                           const float* opac, int n, const float* depth, long long sy,
                           long long sx, int dh, int dw, const float* view, const float* proj,
                           const float* cx_off, const float* cy_off, int img_h, int img_w,
                           int use_sdf, float* part_sum, int* part_count, float* loss,
                           float* denom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(S);
  if (blocks > 0) {
    density_fwd_kernel<<<blocks, kThreads, 0, st>>>(
        points, idx, S, K, splats(means, quats, scales, opac, n),
        view_of(depth, sy, sx, dh, dw, view, proj, cx_off, cy_off, img_h, img_w), use_sdf,
        part_sum, part_count);
  }
  density_final_kernel<<<1, kFinalThreads, 0, st>>>(part_sum, part_count, blocks, loss, denom);
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs; upstream and denom one f32 each in device memory;
// rows (n, 12) f32 zeroed, 16-byte aligned, or null (no splat gradient);
// grad_depth (dh, dw) f32 zeroed, contiguous, or null (no depth gradient);
// cam_part 34 f32 a block of 16 points and cam_grad 34 f32 (viewmat 16,
// projmat 16, cx_off, cy_off), or both null (no camera gradient).
// Returns cudaGetLastError().
extern "C" int density_bwd(const float* points, const long long* idx, long long S, int K,
                           const float* means, const float* quats, const float* scales,
                           const float* opac, int n, const float* depth, long long sy,
                           long long sx, int dh, int dw, const float* view, const float* proj,
                           const float* cx_off, const float* cy_off, int img_h, int img_w,
                           int use_sdf, const float* upstream, const float* denom, float* rows,
                           float* grad_depth, float* cam_part, float* cam_grad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(S);
  if (blocks > 0) {
    density_bwd_kernel<<<blocks, kThreads, 0, st>>>(
        points, idx, S, K, splats(means, quats, scales, opac, n),
        view_of(depth, sy, sx, dh, dw, view, proj, cx_off, cy_off, img_h, img_w), use_sdf,
        upstream, denom, rows, grad_depth, cam_part);
  }
  if (cam_grad != nullptr)
    density_camera_final_kernel<<<kCam, kFinalThreads, 0, st>>>(cam_part, blocks, cam_grad);
  return static_cast<int>(cudaGetLastError());
}
