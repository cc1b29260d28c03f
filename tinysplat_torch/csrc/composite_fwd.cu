// K1: front-to-back alpha compositing of depth-sorted tile entries.
//
// Replaces tinysplat_tpu/ops/rasterize_pallas.py:_fwd_kernel (the Pallas TPU
// forward compositing kernel). What it computes, per tile t of tile_h x
// tile_x pixels and per pixel (px, py) = (sx[t] + lx, sy[t] + ly):
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
// What bounds it on an H100: issue slots. Each (entry, pixel) pair costs ~15
// FP32 instructions and an expf (~11 slots), every product and sum rounded
// on its own so that the result is bit-equal to the plain version; each
// entry's 40-byte row is read once per block and broadcast to its pixels,
// so bytes are ~100x below that. When a block was a whole tile and every
// warp evaluated every entry, three things kept it from that bound: the
// deepest tiles (3,393 entries against a mean of ~395 at the bench frame)
// each ran on one SM while the others idled; most (entry, warp) pairs were
// evaluated for pixels far outside the splat; ten scalar shared-memory reads
// per entry and warp.
//
// What the design does about it:
// - One block per 16 x 16 sub-tile (256 threads, one per pixel, warps on 8 x
//   4 patches), so a deep tile spreads over its ceil(tile_h / 16) x
//   ceil(tile_x / 16) sub-tiles' SMs, a warp's pixels saturate together, and
//   the early exit (__syncthreads_count) votes per sub-tile. Blocks take the
//   sub-tiles in the order the wrapper passes, deepest tile first, so the
//   shallow ones fill the tail.
// - Other tile heights than 16 (the JAX package's tile_size): a tile that is
//   not a multiple of 16 x 16 has a ragged last row or column of sub-tiles,
//   whose threads past the tile's edge start done (so they vote for the early
//   exit and their warps skip the walk) and write nothing. Every pixel in
//   the tile walks the same entries in the same order as at 16 px, so the
//   output stays bit-equal to the plain version. The cost is idle threads:
//   an 8 x 8 tile fills a quarter of its block and a 12 x 12 one 56%; a
//   block still stages every entry of its tile. Packing several small tiles
//   into a block is not done.
// - The block stages a batch of 256 entry rows in shared memory, 12 floats a
//   row: the row and a box around the splat outside which alpha < 1/255
//   (composite_common.cuh: entry_extent). A warp ballots which entries' boxes
//   meet its patch and walks only those, reading each row back as two float4
//   broadcasts (three where the pair contributes). A skipped pair is one the
//   alpha test would have skipped, so the output is unchanged, bit for bit.
// All arithmetic of a pair is float32 without fused multiply-adds; its alpha
// comes from composite_common.cuh, which K2 shares.

#include "composite_common.cuh"

namespace {

using namespace tinysplat;

__global__ void __launch_bounds__(kSubThreads, 4)
composite_fwd_kernel(const float* __restrict__ table, int sentinel,
                     const int* __restrict__ entry_rank, long long n_entries,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ sx, const int* __restrict__ sy,
                     int tile_h, int tile_x, int n_sub, int n_sub_x,
                     const int* __restrict__ order, float* __restrict__ out) {
  __shared__ __align__(16) float batch[kSubThreads * kRowStride];
  const float4* rows = reinterpret_cast<const float4*>(batch);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const SubTilePixel me = sub_tile_pixel(order, n_sub, n_sub_x, sx, sy, tile_h, tile_x);
  const int start = tile_starts[me.t];
  const int count = counts[me.t];

  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  int n_contrib = 0;
  int last_contrib = 0;
  int done = me.inside ? 0 : 1;  // a pixel past the tile's edge takes no part

  for (int base = 0; base < count; base += kSubThreads) {
    // Barrier + vote: the previous batch is fully read before it is
    // overwritten, and a sub-tile whose pixels are all done stops here.
    if (__syncthreads_count(done) == kSubThreads) break;
    if (base + tid < count) {
      // Out-of-range ids and slots read the zero sentinel (never a fault).
      stage_row(table, entry_rank, n_entries, static_cast<long long>(start) + base + tid,
                sentinel, batch + tid * kRowStride);
    }
    __syncthreads();
    const int nb = min(kSubThreads, count - base);
    // The warp walks, front to back, only the entries whose box meets its
    // patch (a ballot over 32 entries at a time); a lane that is done idles.
    for (int w0 = 0; w0 < nb; w0 += 32) {
      if (__all_sync(kFull, done)) break;
      const int e = w0 + lane;
      unsigned todo = __ballot_sync(kFull, e < nb && !misses_patch(rows[3 * e], me.wx0, me.wy0));
      while (todo != 0u && !done) {
        const int j = w0 + __ffs(todo) - 1;
        todo &= todo - 1u;
        const float4 r0 = rows[3 * j];
        const float4 r1 = rows[3 * j + 1];
        const EntryAlpha ea = entry_alpha(me.px - r0.x, me.py - r0.y, r1.x, r1.y, r1.z, r1.w);
        if (ea.keep) {
          const float alpha = ea.alpha;
          const float next_T = mul_rn(T, 1.0f - alpha);
          if (next_T <= kTEps) {
            done = 1;
            n_contrib = base + j;
            break;
          }
          const float4 r2 = rows[3 * j + 2];
          const float w = mul_rn(alpha, T);
          c0 = add_rn(c0, mul_rn(w, r2.x));
          c1 = add_rn(c1, mul_rn(w, r2.y));
          c2 = add_rn(c2, mul_rn(w, r2.z));
          c3 = add_rn(c3, mul_rn(w, r2.w));
          T = next_T;
          last_contrib = base + j + 1;
        }
      }
    }
    if (!done) n_contrib = base + nb;
  }

  if (!me.inside) return;
  const size_t p = static_cast<size_t>(tile_h) * tile_x;
  float* o = out + static_cast<size_t>(me.t) * kOutRows * p + me.pix;
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
// tiles of tile_h x tile_x pixels (both > 0); sub_x: the sub-tile width the
// caller sized `order` for (kSubX, else cudaErrorInvalidValue); with n_sub =
// ceil(tile_h / 16) * ceil(tile_x / sub_x) sub-tiles per tile: order
// (num_tiles * n_sub,) int32, the sub-tile work items (tile * n_sub + sub), in
// the order blocks take them; out (num_tiles, 8, tile_h * tile_x) f32.
// Returns cudaGetLastError().
extern "C" int composite_fwd(const float* table, int n_rows, const int* entry_rank,
                             long long n_entries, const int* tile_starts, const int* counts,
                             const int* sx, const int* sy, int num_tiles, int tile_h,
                             int tile_x, int sub_x, const int* order, float* out,
                             void* stream) {
  if (sub_x != tinysplat::kSubX || tile_h <= 0 || tile_x <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  int n_sub_x, n_sub;
  tinysplat::sub_tile_grid(tile_h, tile_x, &n_sub_x, &n_sub);
  composite_fwd_kernel<<<num_tiles * n_sub, tinysplat::kSubThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, n_rows - 1, entry_rank, n_entries, tile_starts, counts, sx, sy, tile_h, tile_x,
      n_sub, n_sub_x, order, out);
  return static_cast<int>(cudaGetLastError());
}
