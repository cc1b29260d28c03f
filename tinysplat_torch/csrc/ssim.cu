// L1 / L2: the loss layer's SSIM, forward and backward, one kernel each.
//
// Replaces no Pallas kernel: the JAX package's SSIM is XLA
// (tinysplat_tpu/ops/ssim.py, the separable Gaussian blur as banded
// matrix products). The port first ran it as a chain of torch ops: two
// depthwise cuDNN convolutions over 15 stacked channels, two transposed
// ones in the backward, a cat of permuted views and some twenty
// elementwise kernels. Its plain version is ssim_fwd_plain / ssim_bwd_plain
// (tinysplat_torch/ops/ssim_cuda.py): the same algorithm in torch ops.
//
// SSIM at a valid position is a function of five window moments of the two
// images x and y: mu_x, mu_y and the raw second moments e_xx, e_yy, e_xy
// (an 11 x 11 separable Gaussian). The backward needs, at each position,
// the map's partial derivatives by those moments; the gradient of x at a
// pixel is then the adjoint blur (the correlation with the mirrored window)
// of their products with the upstream gradient g, combined at the pixel:
//   dx = B*(g dS/dmu_x) + 2 x B*(g dS/de_xx) + y B*(g dS/de_xy).
// dS/de_xx = dS/de_yy, so three partials serve x (a fourth, dS/dmu_y, and
// the same kernel with x and y swapped serve y).
//
// Bound: bytes. The arithmetic is ~230 FP32 operations an output value
// (a fifth of a microsecond of the card for a whole 1600 x 1066 frame),
// against 4 bytes in and 4-16 bytes out a value for each kernel. The design
// keeps everything but the inputs and outputs out of device memory:
// - A block owns a kRows x kCols tile of pixels, every channel. It stages
//   its tile plus the window's halo of both images (L1), or of the three
//   partials and g (L2, then multiplied in place), in shared memory, by
//   whole row segments of the interleaved (H, W, C) layout: coalesced, with
//   no permute and no stack, every copy in flight at once (cp.async, zero
//   fill outside the image), so a block waits on memory once.
// - A thread owns one float of the tile's rows (a pixel's channel) and
//   walks down the staged rows: the horizontal taps from shared memory, the
//   vertical ones into the accumulators of the output rows the staged row
//   reaches (at most kTaps rows in flight, in registers: the loop is
//   unrolled, so each accumulator is a register). An output row is done
//   kTaps - 1 staged rows after its first; its epilogue runs at once.
// - L1 writes the map and, when a gradient is wanted, the partials, in the
//   (H', W', C) layout; L2 writes each pixel's gradient once, from one
//   thread: no atomics, so two launches give the same bytes.
// The window arrives by value, as a launch argument (no upload, no sync),
// zero-padded to kTaps: a shorter window runs the same code. The images are
// RGB (kC = 3, as every caller's); the wrapper runs the plain version for
// CPU tensors and raises on any other channel count.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTaps = 11;            // the most window taps
constexpr int kHalo = kTaps - 1;     // staged rows / pixels past a tile
constexpr int kRows = 16;            // pixel rows a block
constexpr int kCols = 64;            // pixels of a block's row
constexpr int kC = 3;                // channels: RGB, the only images SSIM is taken of
constexpr int kThreads = kCols * kC; // one thread a float of the tile's rows
constexpr int kStaged = kRows + kHalo;
constexpr int kSpan = (kCols + kHalo) * kC;  // floats of a staged row
constexpr int kPlane = kStaged * kSpan;      // floats of a staged plane
constexpr int kFwdPlanes = 2;        // x, y
constexpr int kBwdPlanes = 3;        // g dS/dmu, g dS/de_xx, g dS/de_xy
static_assert(kSpan < 2 * kThreads, "a staged row takes two passes of the block");

struct Window {
  float w[kTaps];
};

constexpr int smem_bytes(int planes) {
  return planes * kPlane * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0));
}

// Calls fn(r, s, f) for each float f of each staged row r that this
// thread stages: slot s = 0, f = threadIdx.x and, where the row is longer
// than the block, s = 1, f = threadIdx.x + the block's size. The loop is
// unrolled whole (r and s are constants in each call), so the calls' loads
// are independent of each other.
template <class Fn>
__device__ __forceinline__ void each_staged(Fn fn) {
#pragma unroll
  for (int r = 0; r < kStaged; ++r) {
    const int t = static_cast<int>(threadIdx.x);
    fn(r, 0, t);
    if (t + kThreads < kSpan) fn(r, 1, t + kThreads);
  }
}

// The block's staged planes: float f of staged row r of plane p at
// smem[p kPlane + r kSpan + f], copied from src(p, r, f, &in) by cp.async,
// zero where `in` comes back false (outside the image). Every copy is in
// flight at once; each row segment is contiguous in device memory, so a
// warp's copies are one run of addresses. The copies land by
// staged_wait().
template <int P, class Src>
__device__ __forceinline__ void stage(float* smem, Src src) {
  each_staged([&](int r, int, int f) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      bool in;
      const float* from = src(p, r, f, &in);
      cp_async4(smem + p * kPlane + r * kSpan + f, from, in);
    }
  });
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for the thread's own staged copies (not yet the block's).
__device__ __forceinline__ void staged_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The separable blur of a thread's column: taps(r, h) adds the thread's
// horizontal taps of staged row r into h[0..M); each output row i takes
// w[0..kTaps) of staged rows i .. i + kHalo; emit(i, m) receives row i's M
// sums as soon as they are complete.
template <int M, class Taps, class Emit>
__device__ __forceinline__ void blur_column(const Window& win, Taps taps, Emit emit) {
  float acc[kRows][M];
#pragma unroll
  for (int r = 0; r < kStaged; ++r) {
    float h[M];
#pragma unroll
    for (int k = 0; k < M; ++k) h[k] = 0.0f;
    taps(r, h);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int a = r - i;
      if (a < 0 || a >= kTaps) continue;
#pragma unroll
      for (int k = 0; k < M; ++k)
        acc[i][k] = a == 0 ? win.w[0] * h[k] : fmaf(win.w[a], h[k], acc[i][k]);
      if (a == kHalo) emit(i, acc[i]);
    }
  }
}

// L1. Grid (tiles across, tiles down, images); kThreads threads.
__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y, int h, int w, int ho,
                int wo, Window win, float c1, float c2, float* __restrict__ smap,
                float* __restrict__ partials, int n_partials) {
  extern __shared__ float smem[];
  const int n = blockIdx.z, i0 = blockIdx.y * kRows, j0 = blockIdx.x * kCols;
  const int row_floats = w * kC, f0 = j0 * kC;
  const size_t image = static_cast<size_t>(n) * h * row_floats;
  stage<kFwdPlanes>(smem, [&](int p, int r, int f, bool* in) {
    const int gi = i0 + r, gf = f0 + f;
    *in = gi < h && gf < row_floats;
    const float* img = p == 0 ? x : y;
    return *in ? img + image + static_cast<size_t>(gi) * row_floats + gf : img;
  });
  staged_wait();
  __syncthreads();

  const int t = threadIdx.x;
  const bool live = j0 + t / kC < wo;
  const float* sx = smem + t;
  const float* sy = smem + kPlane + t;
  const size_t plane = static_cast<size_t>(gridDim.z) * ho * wo * kC;
  blur_column<5>(
      win,
      [&](int r, float* m) {
#pragma unroll
        for (int b = 0; b < kTaps; ++b) {
          const float xv = sx[r * kSpan + b * kC], yv = sy[r * kSpan + b * kC];
          m[0] = fmaf(win.w[b], xv, m[0]);
          m[1] = fmaf(win.w[b], yv, m[1]);
          m[2] = fmaf(win.w[b], xv * xv, m[2]);
          m[3] = fmaf(win.w[b], yv * yv, m[3]);
          m[4] = fmaf(win.w[b], xv * yv, m[4]);
        }
      },
      [&](int i, const float* m) {
        const int io = i0 + i;
        if (!live || io >= ho) return;
        // The plain version's expressions, in its order.
        const float mu_x = m[0], mu_y = m[1];
        const float mu_xx = mu_x * mu_x, mu_yy = mu_y * mu_y, mu_xy = mu_x * mu_y;
        const float s_xx = m[2] - mu_xx, s_yy = m[3] - mu_yy, s_xy = m[4] - mu_xy;
        const float a1 = 2.0f * mu_xy + c1, b1 = (mu_xx + mu_yy) + c1;
        const float a2 = 2.0f * s_xy + c2, b2 = (s_xx + s_yy) + c2;
        const float cs = a2 / b2, l = a1 / b1, s = l * cs;
        const size_t o = (static_cast<size_t>(n) * ho + io) * wo * kC + f0 + t;
        smap[o] = s;
        if (n_partials == 0) return;
        const float d_xx = -(s / b2);             // dS/de_xx = dS/de_yy
        const float d_xy = 2.0f * (l / b2);       // dS/de_xy
        const float u = 2.0f * (cs / b1) - d_xy;  // dS/dmu_x = u mu_y + v mu_x
        const float v = -2.0f * (d_xx + s / b1);
        partials[o] = u * mu_y + v * mu_x;
        partials[plane + o] = d_xx;
        partials[2 * plane + o] = d_xy;
        if (n_partials == 4) partials[3 * plane + o] = u * mu_x + v * mu_y;
      });
}

// L2. Grid (tiles across, tiles down, images) over the pixels of `self`;
// kThreads threads. g_* are the upstream gradient's strides in floats (its
// pixel stride is kC times its channel stride); p_mu is dS/dmu of `self`.
__global__ void __launch_bounds__(kThreads)
ssim_bwd_kernel(const float* __restrict__ g, int64_t g_n, int64_t g_i, int64_t g_f,
                const float* __restrict__ p_mu, const float* __restrict__ p_xx,
                const float* __restrict__ p_xy, const float* __restrict__ self,
                const float* __restrict__ other, int h, int w, int ho, int wo, Window mirrored,
                float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int n = blockIdx.z, p0 = blockIdx.y * kRows, q0 = blockIdx.x * kCols;
  // Staged row r, float f: map row p0 - kHalo + r, map float (q0 - kHalo) kC + f.
  const int map_floats = wo * kC, mf0 = (q0 - kHalo) * kC;
  auto in_map = [&](int r, int f) {
    const int mi = p0 - kHalo + r, mf = mf0 + f;
    return mi >= 0 && mi < ho && mf >= 0 && mf < map_floats;
  };
  stage<kBwdPlanes>(smem, [&](int p, int r, int f, bool* in) {
    const float* part = p == 0 ? p_mu : p == 1 ? p_xx : p_xy;
    *in = in_map(r, f);
    return *in ? part + (static_cast<size_t>(n) * ho + p0 - kHalo + r) * map_floats + mf0 + f
               : part;
  });
  // Each thread multiplies the partials it copied by the upstream gradient:
  // every load issued (into registers) while the copies fly, then the
  // products.
  float gv[kStaged][2];
  each_staged([&](int r, int slot, int f) {
    gv[r][slot] = in_map(r, f)
                      ? __ldg(g + n * g_n + (p0 - kHalo + r) * g_i + (mf0 + f) * g_f)
                      : 0.0f;
  });
  staged_wait();
  each_staged([&](int r, int slot, int f) {
#pragma unroll
    for (int p = 0; p < kBwdPlanes; ++p) smem[p * kPlane + r * kSpan + f] *= gv[r][slot];
  });
  __syncthreads();

  const int t = threadIdx.x;
  const bool live = q0 + t / kC < w;
  const float* sq = smem + t;
  const int row_floats = w * kC;
  blur_column<3>(
      mirrored,
      [&](int r, float* a) {
#pragma unroll
        for (int b = 0; b < kTaps; ++b) {
          const int at = r * kSpan + b * kC;
          a[0] = fmaf(mirrored.w[b], sq[at], a[0]);
          a[1] = fmaf(mirrored.w[b], sq[kPlane + at], a[1]);
          a[2] = fmaf(mirrored.w[b], sq[2 * kPlane + at], a[2]);
        }
      },
      [&](int i, const float* a) {
        const int p = p0 + i;
        if (!live || p >= h) return;
        const size_t o = (static_cast<size_t>(n) * h + p) * row_floats + q0 * kC + t;
        grad[o] = (a[0] + 2.0f * __ldg(self + o) * a[1]) + __ldg(other + o) * a[2];
      });
}

// Opts `kernel` into `smem` bytes of dynamic shared memory on the current
// device, once a device: the attribute stays set, so later launches make
// no driver call. `opted` holds a bit for each device (0-63) already done;
// a device past 63 is opted in at every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, std::atomic<uint64_t>& opted) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (bit && (opted.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) opted.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace

// SSIM's map of the (n, h, w, c) images x and y, valid positions only:
// (n, h - taps + 1, w - taps + 1, c). window: `taps` floats in host memory.
// n_partials 0 writes the map only; 3 also writes dS/dmu_x, dS/de_xx and
// dS/de_xy as planes of the map's shape; 4 adds dS/dmu_y.
extern "C" int ssim_fwd(const float* x, const float* y, int n, int h, int w, int c,
                        const float* window, int taps, float c1, float c2, float* smap,
                        float* partials, int n_partials, cudaStream_t stream) {
  const int ho = h - taps + 1, wo = w - taps + 1;
  if (c != kC || taps < 1 || taps > kTaps || ho < 1 || wo < 1 || n < 0 ||
      (n_partials != 0 && n_partials != 3 && n_partials != 4))
    return (int)cudaErrorInvalidValue;
  Window win{};
  for (int k = 0; k < taps; ++k) win.w[k] = window[k];
  const int smem = smem_bytes(kFwdPlanes);
  static std::atomic<uint64_t> opted{0};
  const cudaError_t e = allow_smem(ssim_fwd_kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    const dim3 grid((wo + kCols - 1) / kCols, (ho + kRows - 1) / kRows, n);
    ssim_fwd_kernel<<<grid, kThreads, smem, stream>>>(x, y, h, w, ho, wo, win, c1, c2, smap,
                                                      partials, n_partials);
  }
  return (int)cudaGetLastError();
}

// The gradient of SSIM's map by `self` (n, h, w, c), given the upstream
// gradient g of the map (strides g_n, g_i, g_f in floats by image, map row
// and map float), the forward's partials p_mu (of `self`), p_xx and p_xy,
// and the other image. window: the forward's `taps` floats in host memory.
extern "C" int ssim_bwd(const float* g, int64_t g_n, int64_t g_i, int64_t g_f,
                        const float* p_mu, const float* p_xx, const float* p_xy,
                        const float* self, const float* other, int n, int h, int w, int c,
                        const float* window, int taps, float* grad, cudaStream_t stream) {
  const int ho = h - taps + 1, wo = w - taps + 1;
  if (c != kC || taps < 1 || taps > kTaps || ho < 1 || wo < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  // The adjoint of the valid correlation: the mirrored window over the map
  // rows and pixels p - kHalo .. p, zero-padded at its low end.
  Window mirrored{};
  for (int k = 0; k < taps; ++k) mirrored.w[kHalo - k] = window[k];
  const int smem = smem_bytes(kBwdPlanes);
  static std::atomic<uint64_t> opted{0};
  const cudaError_t e = allow_smem(ssim_bwd_kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    const dim3 grid((w + kCols - 1) / kCols, (h + kRows - 1) / kRows, n);
    ssim_bwd_kernel<<<grid, kThreads, smem, stream>>>(g, g_n, g_i, g_f, p_mu, p_xx, p_xy, self,
                                                      other, h, w, ho, wo, mirrored, grad);
  }
  return (int)cudaGetLastError();
}
