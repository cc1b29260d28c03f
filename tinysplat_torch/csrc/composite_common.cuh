// What the compositing kernels K1 (composite_fwd.cu) and K2
// (composite_bwd.cu) share: the table layout, the thresholds, and one
// entry's alpha at one pixel.
//
// Both kernels evaluate alpha through entry_alpha(), so K2's keep mask and
// clamp test agree with K1's bit for bit, and both agree with their plain
// PyTorch versions (ops/rasterize_cuda.py), which evaluate the same
// expressions one elementwise op per rounding in the same order.
#pragma once

#include <cuda_runtime.h>

namespace tinysplat {

constexpr int kTileH = 16;
constexpr int kCols = 10;  // table row: x, y, conic a, b, c, opacity, c0..c3
constexpr int kOutRows = 8;  // K1 output rows: c0..c3, T_final, n_contrib, last_contrib, 0
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kTEps = 1e-4f;

// Every product, sum and quotient is rounded on its own (no fused
// multiply-add), in the order the plain PyTorch versions evaluate it: a
// pixel then cannot flip across the 1/255 or 1e-4 thresholds between a
// kernel and its plain version.
__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }

struct EntryAlpha {
  float alpha;  // min(0.999, opacity exp(-sigma))
  float raw;    // opacity exp(-sigma) before the clamp (the gradient stops at it)
  bool keep;    // sigma >= 0 and alpha >= 1/255
};

// sigma = 0.5 (a dx dx + c dy dy) + b dx dy, with dx = px - x, dy = py - y.
__device__ __forceinline__ EntryAlpha entry_alpha(float dx, float dy, float a, float b,
                                                  float c, float opacity) {
  const float quad = add_rn(mul_rn(mul_rn(a, dx), dx), mul_rn(mul_rn(c, dy), dy));
  const float sigma = add_rn(mul_rn(0.5f, quad), mul_rn(mul_rn(b, dx), dy));
  const float raw = mul_rn(opacity, expf(-sigma));
  const float alpha = fminf(kAlphaMax, raw);
  return {alpha, raw, sigma >= 0.0f && alpha >= kAlphaEps};
}

// The table row of slot `slot` of entry_rank: out-of-range slots and ids
// read the zero sentinel row (opacity 0, so it never contributes).
__device__ __forceinline__ int table_row(const int* entry_rank, long long n_entries,
                                         long long slot, int sentinel) {
  const int r = (slot >= 0 && slot < n_entries) ? entry_rank[slot] : -1;
  return (r < 0 || r > sentinel) ? sentinel : r;
}

}  // namespace tinysplat
