// P2: what one elementwise op, and one pass of a triangular product, costs
// inside a kernel on this card.
//
// Replaces scripts/probe_vpu_costs.py: _probe_kernel and _tri_kern (the
// Pallas TPU VPU / MXU cost probe). Each elementwise row runs ITERS
// dependent iterations of one op over a (128, L) f32 tile, 4 independent
// chains per element (x * (1 + 0.001 c), c = 0..3), and writes the sum of
// the chains. The expressions are the JAX probe's, with the instructions
// the port's kernels execute: exp is expf, as K1 and K2 call it
// (composite_common.cuh), and divisions are __fdiv_rn, as K2's are. Every
// other product and sum is rounded on its own (__fmul_rn / __fadd_rn), so
// nvcc contracts nothing and the plain PyTorch version gets the same bits;
// the fma row is one fused fmaf.
//
// The triangular rows compute x <- (T x) * 1e-3, ITERS times, with T the
// (128, 128) lower-triangular ones, over 64-column strips (one block each):
//   tri_highest   f32 FFMA, T and the strip in shared memory;
//   tri_matmul    one bf16 mma.sync pass (m16n8k16, f32 accumulate);
//   tri_x2_manual the hi + lo bf16 split, two mma passes, summed.
// No cuBLAS: the point is the exact instruction executed.
//
// What bounds it: operations. Elementwise rows: the FP32 pipe's throughput
// (128 results / clock / SM) for fma, mul, min and select; the
// special-function unit's (16 / clock / SM) for ex2, lg2 and rcp.
// Triangular rows: 2 * 128 * 128 * L FLOP a pass at the route's rate.
// What the design does: one thread per element with the 4 chains in
// registers (no memory traffic inside the loop); the strip kernels keep the
// strip on chip across all passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op {
  kFma, kMul2, kExp, kExp2, kLog2, kDiv, kRecip, kCmpSel, kMin, kBf16Split,
  kTriMatmul, kTriHighest, kTriX2Manual
};

constexpr int kRows = 128;   // the tile's rows (and T's size)
constexpr int kStrip = 64;   // columns per block in the triangular rows
constexpr int kXStride = kStrip + 4;  // shared row stride: conflict-free B loads

template <int OP>
__device__ __forceinline__ float apply(float x) {
  if constexpr (OP == kFma) {
    return fmaf(x, 1.000001f, 1e-8f);
  } else if constexpr (OP == kMul2) {
    return __fmul_rn(__fmul_rn(x, 1.000001f), 0.999999f);
  } else if constexpr (OP == kExp) {
    return expf(__fmul_rn(-fabsf(x), 1e-6f));
  } else if constexpr (OP == kExp2) {
    return exp2f(__fmul_rn(-fabsf(x), 1e-6f));
  } else if constexpr (OP == kLog2) {
    return log2f(__fadd_rn(fabsf(x), 1.0f));
  } else if constexpr (OP == kDiv) {
    return __fdiv_rn(x, __fadd_rn(fabsf(x), 1.0f));
  } else if constexpr (OP == kRecip) {
    return __frcp_rn(__fadd_rn(fabsf(x), 1.0f));
  } else if constexpr (OP == kCmpSel) {
    return x > 0.5f ? __fmul_rn(x, 0.999f) : __fadd_rn(x, 1e-7f);
  } else if constexpr (OP == kMin) {
    return fminf(__fmul_rn(x, 1.000001f), 2.0f);
  } else {  // kBf16Split
    const float b = __bfloat162float(__float2bfloat16_rn(x));
    return __fadd_rn(__fmul_rn(b, 1.000001f), __fmul_rn(1e-8f, __fsub_rn(x, b)));
  }
}

template <int OP>
__global__ void op_chains(const float* __restrict__ x, float* __restrict__ out, long long n,
                          int iters) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  float c0 = __fmul_rn(v, static_cast<float>(1.0 + 0.001 * 0));
  float c1 = __fmul_rn(v, static_cast<float>(1.0 + 0.001 * 1));
  float c2 = __fmul_rn(v, static_cast<float>(1.0 + 0.001 * 2));
  float c3 = __fmul_rn(v, static_cast<float>(1.0 + 0.001 * 3));
  for (int k = 0; k < iters; ++k) {
    c0 = apply<OP>(c0);
    c1 = apply<OP>(c1);
    c2 = apply<OP>(c2);
    c3 = apply<OP>(c3);
  }
  out[i] = __fadd_rn(__fadd_rn(__fadd_rn(c0, c1), c2), c3);
}

// tri_highest: each thread owns one column of the strip and 32 rows.
__global__ void tri_ffma(const float* __restrict__ x, float* __restrict__ out, int lanes,
                         int iters) {
  extern __shared__ __align__(16) float smem[];
  float* Ts = smem;                  // (128, 128) lower-triangular ones
  float* Xs = smem + kRows * kRows;  // (128, kStrip) the strip
  const int c0 = blockIdx.x * kStrip, tid = threadIdx.x;
  for (int i = tid; i < kRows * kRows; i += blockDim.x)
    Ts[i] = (i % kRows) <= (i / kRows) ? 1.0f : 0.0f;
  for (int i = tid; i < kRows * kStrip; i += blockDim.x)
    Xs[i] = x[static_cast<long long>(i / kStrip) * lanes + c0 + i % kStrip];
  __syncthreads();
  const int tx = tid % kStrip, r0 = (tid / kStrip) * 32;
  for (int it = 0; it < iters; ++it) {
    float acc[32];
#pragma unroll
    for (int rr = 0; rr < 32; ++rr) acc[rr] = 0.0f;
    for (int j = 0; j < kRows; j += 4) {
      const float x0 = Xs[(j + 0) * kStrip + tx], x1 = Xs[(j + 1) * kStrip + tx];
      const float x2 = Xs[(j + 2) * kStrip + tx], x3 = Xs[(j + 3) * kStrip + tx];
#pragma unroll
      for (int rr = 0; rr < 32; ++rr) {
        const float4 t = *reinterpret_cast<const float4*>(&Ts[(r0 + rr) * kRows + j]);
        acc[rr] = fmaf(t.x, x0, acc[rr]);
        acc[rr] = fmaf(t.y, x1, acc[rr]);
        acc[rr] = fmaf(t.z, x2, acc[rr]);
        acc[rr] = fmaf(t.w, x3, acc[rr]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 32; ++rr) Xs[(r0 + rr) * kStrip + tx] = __fmul_rn(acc[rr], 1e-3f);
    __syncthreads();
  }
  for (int i = tid; i < kRows * kStrip; i += blockDim.x)
    out[static_cast<long long>(i / kStrip) * lanes + c0 + i % kStrip] = Xs[i];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tri_matmul (kSplit false) and tri_x2_manual (true): 8 warps, warp w owns
// rows [16 w, 16 w + 16) of the strip, all 8 column tiles of 8.
template <bool kSplit>
__global__ void tri_mma(const float* __restrict__ x, float* __restrict__ out, int lanes,
                        int iters) {
  __shared__ __align__(16) float Xs[kRows][kXStride];
  const int c0 = blockIdx.x * kStrip, tid = threadIdx.x;
  for (int i = tid; i < kRows * kStrip; i += blockDim.x)
    Xs[i / kStrip][i % kStrip] = x[static_cast<long long>(i / kStrip) * lanes + c0 + i % kStrip];
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, tg = lane & 3;
  const int m0 = warp * 16;
  // T's A fragments (row-major 16x16 per k tile), exact in bf16: 0 or 1.
  uint32_t a[8][4];
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    const int k0 = kt * 16 + 2 * tg;
    auto t = [](int r, int c) { return c <= r ? 1.0f : 0.0f; };
    a[kt][0] = pack_bf16(t(m0 + g, k0), t(m0 + g, k0 + 1));
    a[kt][1] = pack_bf16(t(m0 + g + 8, k0), t(m0 + g + 8, k0 + 1));
    a[kt][2] = pack_bf16(t(m0 + g, k0 + 8), t(m0 + g, k0 + 9));
    a[kt][3] = pack_bf16(t(m0 + g + 8, k0 + 8), t(m0 + g + 8, k0 + 9));
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    float acc[8][4], acc_lo[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] = acc_lo[nt][q] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      const int k0 = kt * 16 + 2 * tg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + g;
        const float x00 = Xs[k0][n], x01 = Xs[k0 + 1][n];
        const float x10 = Xs[k0 + 8][n], x11 = Xs[k0 + 9][n];
        mma_bf16(acc[nt], a[kt], pack_bf16(x00, x01), pack_bf16(x10, x11));
        if (kSplit) {
          auto lo = [](float v) {
            return __fsub_rn(v, __bfloat162float(__float2bfloat16_rn(v)));
          };
          mma_bf16(acc_lo[nt], a[kt], pack_bf16(lo(x00), lo(x01)),
                   pack_bf16(lo(x10), lo(x11)));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * tg;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = kSplit ? __fadd_rn(acc[nt][q], acc_lo[nt][q]) : acc[nt][q];
        Xs[m0 + g + (q >= 2 ? 8 : 0)][col + (q & 1)] = __fmul_rn(v, 1e-3f);
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < kRows * kStrip; i += blockDim.x)
    out[static_cast<long long>(i / kStrip) * lanes + c0 + i % kStrip] = Xs[i / kStrip][i % kStrip];
}

template <int OP>
void launch_chains(const float* x, float* out, long long n, int iters, cudaStream_t s) {
  const int threads = 256;
  op_chains<OP><<<static_cast<int>((n + threads - 1) / threads), threads, 0, s>>>(x, out, n,
                                                                                 iters);
}

}  // namespace

// op: the Op enum above (the order of the JAX probe's OPS). x, out: (rows,
// lanes) f32; the triangular rows need rows == 128 and lanes % 64 == 0.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for bad shapes).
extern "C" int probe_op_costs(int op, const float* x, float* out, int rows, int lanes,
                              int iters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(rows) * lanes;
  if (op >= kTriMatmul && (rows != kRows || lanes % kStrip != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int strips = lanes / kStrip;
  switch (op) {
    case kFma: launch_chains<kFma>(x, out, n, iters, s); break;
    case kMul2: launch_chains<kMul2>(x, out, n, iters, s); break;
    case kExp: launch_chains<kExp>(x, out, n, iters, s); break;
    case kExp2: launch_chains<kExp2>(x, out, n, iters, s); break;
    case kLog2: launch_chains<kLog2>(x, out, n, iters, s); break;
    case kDiv: launch_chains<kDiv>(x, out, n, iters, s); break;
    case kRecip: launch_chains<kRecip>(x, out, n, iters, s); break;
    case kCmpSel: launch_chains<kCmpSel>(x, out, n, iters, s); break;
    case kMin: launch_chains<kMin>(x, out, n, iters, s); break;
    case kBf16Split: launch_chains<kBf16Split>(x, out, n, iters, s); break;
    case kTriMatmul: tri_mma<false><<<strips, 256, 0, s>>>(x, out, lanes, iters); break;
    case kTriX2Manual: tri_mma<true><<<strips, 256, 0, s>>>(x, out, lanes, iters); break;
    case kTriHighest: {
      const int smem = (kRows * kRows + kRows * kStrip) * static_cast<int>(sizeof(float));
      const cudaError_t e =
          cudaFuncSetAttribute(tri_ffma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      tri_ffma<<<strips, 256, smem, s>>>(x, out, lanes, iters);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
