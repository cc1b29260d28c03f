// K1: front-to-back alpha compositing of depth-sorted tile entries.
//
// Replaces tinysplat_tpu/ops/rasterize_pallas.py:_fwd_kernel (the Pallas TPU
// forward compositing kernel). What it computes, per tile t of 16 x tile_x
// pixels and per pixel (px, py) = (sx[t] + lx, sy[t] + ly):
//
//   for the entries e < counts[t] of the tile's depth-sorted range
//   [tile_starts[t], tile_starts[t] + counts[t]) of entry_rank, front to back:
//     row    = table[entry_rank[e]]      (entry_rank -1 -> the zero sentinel)
//     sigma  = 0.5 (a dx^2 + c dy^2) + b dx dy,  dx = px - x, dy = py - y
//     alpha  = min(0.999, op exp(-sigma)); skipped where sigma < 0 or
//              alpha < 1/255
//     stop (sticky) before the first entry whose T (1 - alpha) <= 1e-4
//     C     += alpha T color[0..3];  T *= 1 - alpha
//   out[t] = [C0..C3, T_final, n_contrib, last_contrib, 0]   (8 rows x P)
//
// n_contrib counts the entries walked before the stop (min(stop, count));
// last_contrib is 1 + the index of the last entry that contributed. These are
// the rows the backward kernel reads (OUT_ROWS layout of the JAX package).
//
// What bounds it on an H100: operations. Each (entry, pixel) pair costs ~16
// FP32 operations and one exp (the special-function unit runs at a quarter
// of the FP32 rate), while each entry's 40-byte row is read once per tile
// and shared by up to 1024 pixels, so the bytes are ~100x below the
// operation bound at the bench scene.
//
// What the design does about it: one block per tile, one thread per pixel
// (16 x tile_x <= 1024 threads). The block walks the tile's entries in
// batches of blockDim: each thread gathers one entry's row into shared
// memory (struct-of-arrays, so the stores are bank-conflict free and the
// reads are broadcasts), then every thread composites the batch in order for
// its pixel, in registers, with no per-pair memory traffic. A thread stops
// at its own saturation point; the block leaves the tile as soon as every
// pixel is done (__syncthreads_count), so saturated tails cost no batches.
// All arithmetic is float32, without fused multiply-adds; the alpha of an
// (entry, pixel) pair comes from composite_common.cuh, which K2 shares.

#include "composite_common.cuh"

namespace {

using namespace tinysplat;

__global__ void __launch_bounds__(1024)
composite_fwd_kernel(const float* __restrict__ table, int sentinel,
                     const int* __restrict__ entry_rank, long long n_entries,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ sx, const int* __restrict__ sy,
                     int tile_x, float* __restrict__ out) {
  extern __shared__ float batch[];  // kCols rows of blockDim.x floats
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float px = static_cast<float>(sx[t] + tid % tile_x);
  const float py = static_cast<float>(sy[t] + tid / tile_x);
  const int start = tile_starts[t];
  const int count = counts[t];

  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  int n_contrib = 0;
  int last_contrib = 0;
  int done = 0;

  for (int base = 0; base < count; base += nthreads) {
    // Barrier + vote: the previous batch is fully read before it is
    // overwritten, and a tile whose pixels are all done stops here.
    if (__syncthreads_count(done) == nthreads) break;
    const int e = base + tid;
    if (e < count) {
      // Out-of-range ids and slots read the zero sentinel (never a fault).
      const int row = table_row(entry_rank, n_entries, static_cast<long long>(start) + e,
                                sentinel);
      const float* src = table + static_cast<size_t>(row) * kCols;
#pragma unroll
      for (int k = 0; k < kCols; ++k) batch[k * nthreads + tid] = src[k];
    }
    __syncthreads();
    if (done) continue;
    const int nb = min(nthreads, count - base);
    for (int j = 0; j < nb; ++j) {
      const float dx = px - batch[0 * nthreads + j];
      const float dy = py - batch[1 * nthreads + j];
      const EntryAlpha ea = entry_alpha(dx, dy, batch[2 * nthreads + j],
                                        batch[3 * nthreads + j], batch[4 * nthreads + j],
                                        batch[5 * nthreads + j]);
      if (ea.keep) {
        const float alpha = ea.alpha;
        const float next_T = mul_rn(T, 1.0f - alpha);
        if (next_T <= kTEps) {
          done = 1;
          break;
        }
        const float w = mul_rn(alpha, T);
        c0 = add_rn(c0, mul_rn(w, batch[6 * nthreads + j]));
        c1 = add_rn(c1, mul_rn(w, batch[7 * nthreads + j]));
        c2 = add_rn(c2, mul_rn(w, batch[8 * nthreads + j]));
        c3 = add_rn(c3, mul_rn(w, batch[9 * nthreads + j]));
        T = next_T;
        last_contrib = base + j + 1;
      }
      n_contrib = base + j + 1;
    }
  }

  const size_t p = static_cast<size_t>(nthreads);
  float* o = out + static_cast<size_t>(t) * kOutRows * p + tid;
  o[0 * p] = c0;
  o[1 * p] = c1;
  o[2 * p] = c2;
  o[3 * p] = c3;
  o[4 * p] = T;
  o[5 * p] = static_cast<float>(n_contrib);
  o[6 * p] = static_cast<float>(last_contrib);
  o[7 * p] = 0.0f;
}

}  // namespace

// table (n_rows, 10) f32 with the zero sentinel as its last row;
// entry_rank (n_entries,) int32; tile_starts, counts, sx, sy (num_tiles,) int32;
// out (num_tiles, 8, 16 * tile_x) f32. Returns cudaGetLastError().
extern "C" int composite_fwd(const float* table, int n_rows, const int* entry_rank,
                             long long n_entries, const int* tile_starts, const int* counts,
                             const int* sx, const int* sy, int num_tiles,
                             int tile_x, float* out, void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const int threads = tinysplat::kTileH * tile_x;
  const size_t smem = static_cast<size_t>(tinysplat::kCols) * threads * sizeof(float);
  composite_fwd_kernel<<<num_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, n_rows - 1, entry_rank, n_entries, tile_starts, counts, sx, sy, tile_x, out);
  return static_cast<int>(cudaGetLastError());
}
