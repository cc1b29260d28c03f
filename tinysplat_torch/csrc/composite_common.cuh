// What the compositing kernels K1 (composite_fwd.cu) and K2
// (composite_bwd.cu) share: the table layout, the thresholds, one entry's
// alpha at one pixel, the sub-tile blocks and the staged entry rows.
//
// Both kernels evaluate alpha through entry_alpha(), so K2's keep mask and
// clamp test agree with K1's bit for bit, and both agree with their plain
// PyTorch versions (ops/rasterize_cuda.py), which evaluate the same
// expressions one elementwise op per rounding in the same order.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tinysplat {

constexpr int kTileH = 16;  // the SUB-tile height (a tile may be of any height)
constexpr int kCols = 10;  // table row: x, y, conic a, b, c, opacity, c0..c3
constexpr int kOutRows = 8;  // K1 output rows: c0..c3, T_final, n_contrib, last_contrib, 0
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kTEps = 1e-4f;

// A block covers a kTileH x kSubX sub-tile of a tile_h x tile_x tile, one
// thread per pixel; a warp covers a kWarpW x kWarpH patch of it. A tile is
// ceil(tile_h / kTileH) x ceil(tile_x / kSubX) sub-tiles, row by row; where
// it is not a multiple of the sub-tile, the last row and column of them are
// ragged, and a thread whose pixel lies past the tile's edge composites
// nothing, keeps nothing and writes nothing. The wrappers size the work
// order and K2's scratch by rasterize_cuda.SUB_X (and SUB_H = kTileH) and
// pass SUB_X to the entry points, which refuse a launch unless it is kSubX.
constexpr int kSubX = 16;
constexpr int kSubThreads = kTileH * kSubX;
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
// An entry row staged in shared memory, read as three float4 broadcasts:
// [x y ex ey] [a b c opacity] [c0 c1 c2 c3], (ex, ey) from entry_extent().
constexpr int kRowStride = 12;
constexpr unsigned kFull = 0xffffffffu;

// Every product, sum and quotient is rounded on its own (no fused
// multiply-add), in the order the plain PyTorch versions evaluate it: a
// pixel then cannot flip across the 1/255 or 1e-4 thresholds between a
// kernel and its plain version.
__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }

struct EntryAlpha {
  float alpha;  // min(0.999, opacity exp(-sigma)); NaN stays NaN, as in torch.clamp
  float raw;    // opacity exp(-sigma) before the clamp (the gradient stops at it)
  bool keep;    // sigma >= 0 and alpha >= 1/255
};

// sigma = 0.5 (a dx dx + c dy dy) + b dx dy, with dx = px - x, dy = py - y.
__device__ __forceinline__ EntryAlpha entry_alpha(float dx, float dy, float a, float b,
                                                  float c, float opacity) {
  const float quad = add_rn(mul_rn(mul_rn(a, dx), dx), mul_rn(mul_rn(c, dy), dy));
  const float sigma = add_rn(mul_rn(0.5f, quad), mul_rn(mul_rn(b, dx), dy));
  const float raw = mul_rn(opacity, expf(-sigma));
  // Not fminf, which would turn a NaN into 0.999: a NaN alpha fails the test.
  const float alpha = raw > kAlphaMax ? kAlphaMax : raw;
  return {alpha, raw, sigma >= 0.0f && alpha >= kAlphaEps};
}

// The table row of slot `slot` of entry_rank: out-of-range slots and ids
// read the zero sentinel row (opacity 0, so it never contributes).
__device__ __forceinline__ int table_row(const int* entry_rank, long long n_entries,
                                         long long slot, int sentinel) {
  const int r = (slot >= 0 && slot < n_entries) ? entry_rank[slot] : -1;
  return (r < 0 || r > sentinel) ? sentinel : r;
}

// This thread's pixel in the sub-tile block of work item order[blockIdx.x]
// (item = tile * n_sub + sub, sub = sub-tile row * n_sub_x + column). `pix`
// indexes the tile's pixels row-major, as the (num_tiles, 8, tile_h * tile_x)
// output rows do (0 for a pixel past the tile's edge, so that an address
// built from it stays inside the tile's rows); (wx0, wy0) is the first pixel
// of the thread's warp patch. `inside`: the pixel lies in the tile;
// `warp_inside`: some pixel of the warp's patch does (the same in all lanes).
struct SubTilePixel {
  int t, item, pix;
  float px, py, wx0, wy0;
  bool inside, warp_inside;
};

__device__ __forceinline__ SubTilePixel sub_tile_pixel(const int* order, int n_sub,
                                                      int n_sub_x, const int* sx,
                                                      const int* sy, int tile_h,
                                                      int tile_x) {
  const int item = order[blockIdx.x];
  const int t = item / n_sub, s = item % n_sub;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarpsX = kSubX / kWarpW;
  const int wx = (s % n_sub_x) * kSubX + (warp % kWarpsX) * kWarpW;
  const int wy = (s / n_sub_x) * kTileH + (warp / kWarpsX) * kWarpH;
  const int lx = wx + lane % kWarpW, ly = wy + lane / kWarpW;
  const bool inside = lx < tile_x && ly < tile_h;
  return {t, item, inside ? ly * tile_x + lx : 0, static_cast<float>(sx[t] + lx),
          static_cast<float>(sy[t] + ly), static_cast<float>(sx[t] + wx),
          static_cast<float>(sy[t] + wy), inside, wx < tile_x && wy < tile_h};
}

// The sub-tile grid of a tile_h x tile_x tile: n_sub_x columns, n_sub in all.
inline void sub_tile_grid(int tile_h, int tile_x, int* n_sub_x, int* n_sub) {
  *n_sub_x = (tile_x + kSubX - 1) / kSubX;
  *n_sub = ((tile_h + kTileH - 1) / kTileH) * *n_sub_x;
}

// Half-widths (ex, ey) of a box around an entry's centre outside which no
// pixel passes the alpha test. alpha >= 1/255 needs opacity >= 1/255 and
// sigma <= ln(255 opacity), and sigma <= s bounds |dx| by sqrt(2 s c / det)
// and |dy| by sqrt(2 s a / det), det = ac - b^2. The margins (s x 1.1 + 0.1,
// half-widths x 1.01 + 0.5 px) cover the float rounding of sigma, which is
// at most a few ulps of sigma times the conic's condition number, and that
// of det, a few ulps times the same: the number is kept below 1e4 (trace^2 /
// det, which is at least it). -inf: no pixel passes (also a NaN opacity,
// whose alpha is NaN); +inf (or NaN): no bound, for a conic that is not
// positive definite or too thin to bound safely. rasterize_cuda.entry_extent
// is the same box in torch, for the work counters.
__device__ __forceinline__ float2 entry_extent(float a, float b, float c, float opacity) {
  if (!(opacity >= kAlphaEps)) return make_float2(-CUDART_INF_F, -CUDART_INF_F);
  const float det = a * c - b * b;
  const float trace = a + c;
  if (!(a > 0.0f && c > 0.0f && det > 0.0f && trace * trace < 1e4f * det)) {
    return make_float2(CUDART_INF_F, CUDART_INF_F);
  }
  const float s2 = 2.0f * (fmaxf(logf(255.0f * opacity), 0.0f) * 1.1f + 0.1f) / det;
  return make_float2(sqrtf(s2 * c) * 1.01f + 0.5f, sqrtf(s2 * a) * 1.01f + 0.5f);
}

// Whether an entry's box (first float4 of its staged row) misses the warp
// patch of kWarpW x kWarpH pixels from (wx0, wy0): then none of the warp's
// pixels keeps it, and the warp skips it.
__device__ __forceinline__ bool misses_patch(float4 r0, float wx0, float wy0) {
  return r0.x + r0.z < wx0 || r0.x - r0.z > wx0 + (kWarpW - 1) ||
         r0.y + r0.w < wy0 || r0.y - r0.w > wy0 + (kWarpH - 1);
}

// Stage entry slot `slot`'s table row at dst (kRowStride floats, 16-byte
// aligned) in the layout above. Scalar loads: a row is 40 bytes, so only
// every other row would be 16-byte aligned in the table.
__device__ __forceinline__ void stage_row(const float* table, const int* entry_rank,
                                          long long n_entries, long long slot, int sentinel,
                                          float* dst) {
  const float* src = table + static_cast<size_t>(table_row(entry_rank, n_entries, slot,
                                                           sentinel)) * kCols;
  float v[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) v[k] = src[k];
  const float2 ext = entry_extent(v[2], v[3], v[4], v[5]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], ext.x, ext.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[2], v[3], v[4], v[5]);
  reinterpret_cast<float4*>(dst)[2] = make_float4(v[6], v[7], v[8], v[9]);
}

}  // namespace tinysplat
