// K2: the analytic backward of K1's front-to-back compositing.
//
// Replaces tinysplat_tpu/ops/rasterize_pallas.py:_bwd_kernel with
// _bwd_window (the Pallas TPU backward compositing kernel). What it computes,
// per tile t and per entry e of the tile's live prefix, summed over the
// tile's tile_h x tile_x pixels:
//
//   grads[tile_starts[t] + e] = [dx, dy, d conic a, b, c, d opacity, d c0..c3]
//
// from the forward's rows T_final, n_contrib, last_contrib and the cotangent
// rows g_c0..g_c3, g_T of K1's output. Per pixel, back to front over the
// entries e < n_contrib that K1 kept (sigma >= 0, alpha >= 1/255):
//
//   r        = 1 / (1 - alpha)  (correctly rounded)
//   T_before = T_after r        (T_after starts at T_final)
//   w        = alpha T_before;   q = sum_c color_c g_c
//   dsigma   = alpha r S - q w   where the clamp did not bind
//              (op exp(-sigma) < 0.999), else 0; S = suffix sum of q w,
//              seeded with g_T T_final
//   d color_c += g_c w;   d opacity += dsigma (then -sum / opacity)
//   d x += -(a dx + b dy) dsigma;   d y += -(b dx + c dy) dsigma
//   d a += dsigma dx^2 / 2;  d b += dsigma dx dy;  d c += dsigma dy^2 / 2
//
// Entries past the tile's live prefix (the max last_contrib of its pixels)
// are not visited: the wrapper zeroes the output first.
//
// What bounds it on an H100: issue slots. Each (entry, pixel) pair walked
// costs K1's ~26 slots to rebuild alpha; a pair kept by the alpha test costs
// ~51 more (a reciprocal, the T and S updates, ten gradient terms), and each
// (entry, warp) with a kept pixel a reduction of 10 sums over the warp. Each
// entry's 40-byte row is read once per block and its 40-byte gradient row
// written once, so bytes are far below that.
//
// What the design does about it:
// - One block per 16 x 16 sub-tile (256 threads, one per pixel), not per
//   tile. A block walks its own live prefix (the wrapper's sub_live: the max
//   last_contrib of its pixels, exact since no pixel keeps an entry at or
//   past its last_contrib), shorter than the tile's, and a deep tile spreads
//   over its ceil(tile_h / 16) x ceil(tile_x / 16) sub-tiles' SMs. Blocks
//   take the sub-tiles deepest first (the wrapper's order), so the shallow
//   ones fill the tail.
// - A warp covers an 8 x 4 patch. Each staged entry carries a box outside
//   which alpha < 1/255 (composite_common.cuh: entry_extent); a warp ballots
//   which entries' boxes meet its patch and walks only those, back to front,
//   and of those reduces only the ones a pixel kept (__any_sync). A small
//   splat meets fewer 8 x 4 patches than 32 x 1 strips. A skipped pair is one
//   the alpha test would have skipped: the result does not change.
// - The warp reduction is a reduce-scatter: at each of the 5 shuffle stages
//   a lane sends the half of its values that its partner keeps, so 10 values
//   fall to one column sum per lane pair in 12 shuffles (a butterfly over
//   all 10 takes 50; the card issues one shuffle per clock per SM).
// - One reciprocal per kept pair where two divisions were.
// - Entries are staged 64 at a time (rows as float4 broadcasts); per batch
//   the warps' partials [warp][entry][10] of the entries each warp kept are
//   summed over the 8 warps in a fixed order, one thread per (entry, column).
// - With several sub-tiles per tile, each block writes its partial rows
//   into scratch[sub] and the tile's last block to finish (a per-tile
//   counter) folds them in sub-tile order (row by row). No float atomics:
//   two launches on the same inputs give the same bytes.
// - Other tile heights than 16 (the JAX package's tile_size): a tile that is
//   not a multiple of 16 x 16 has a ragged last row or column of sub-tiles.
//   A thread whose pixel lies past the tile's edge keeps nothing (its walk
//   is empty) and adds zeros to its warp's sums; a warp whose whole patch
//   lies past it walks nothing. The bound is the same issue slots, over the
//   pixels in the tile; the cost is idle threads (an 8 x 8 tile fills a
//   quarter of its block) and, for tiles above 16 x 16, the scratch and the
//   fold over more sub-tiles (a 32 x 64 tile has 8). Packing several small
//   tiles into a block is not done.
// The alpha comes from composite_common.cuh (K1's code, no fused
// multiply-adds), so the keep and clamp masks are K1's bit for bit; T, S, w
// and q are rounded op by op as in the plain version; only the gradient
// terms may contract to fused multiply-adds. So K2 and its plain version
// differ in the order of the pixel sums and in those terms' roundings.
//
// Not carried over from the TPU kernel: the pixel-moment MXU expansion, the
// log-space cumulative product, the written-slot mask (TPU window stores
// overlapped; here each entry row is written exactly once) and the
// environment switches.

#include "composite_common.cuh"

namespace {

using namespace tinysplat;

constexpr int kBatch = 64;  // entries staged and reduced per block barrier
constexpr int kWords = kBatch / 32;  // ballot words per batch
constexpr int kWarps = kSubThreads / 32;

// The 10 values v of the warp's 32 lanes, summed over the warp and scattered:
// lane l returns the sum of column reduce_col(l) (both lanes of a pair hold
// it; -1: no column). Stage by stage a lane keeps the first half of its
// values where its bit is clear and the second where it is set, and sends
// its partner the other half: 10 -> 5 -> 3 or 2 -> 2 or 1 -> 1, then one
// butterfly step. 12 shuffles.
__device__ __forceinline__ float warp_reduce_scatter(const float (&v)[kCols], int lane) {
  float u[5];
  const bool b4 = lane & 16;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float send = b4 ? v[k] : v[k + 5];
    u[k] = add_rn(b4 ? v[k + 5] : v[k], __shfl_xor_sync(kFull, send, 16));
  }
  float w[3];
  const bool b3 = lane & 8;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float hi = k < 2 ? u[k + 3] : 0.0f;
    w[k] = add_rn(b3 ? hi : u[k], __shfl_xor_sync(kFull, b3 ? u[k] : hi, 8));
  }
  float x[2];
  const bool b2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float hi = k < 1 ? w[k + 2] : 0.0f;
    x[k] = add_rn(b2 ? hi : w[k], __shfl_xor_sync(kFull, b2 ? w[k] : hi, 4));
  }
  const bool b1 = lane & 2;
  const float y = add_rn(b1 ? x[1] : x[0], __shfl_xor_sync(kFull, b1 ? x[0] : x[1], 2));
  return add_rn(y, __shfl_xor_sync(kFull, y, 1));
}

// d opacity from the tile's sum of dsigma: -sum / max(opacity, 1e-30), with
// a NaN opacity giving NaN as torch.clamp does (fmaxf would drop it).
__device__ __forceinline__ float opacity_grad(float dsigma_sum, float opacity) {
  return -div_rn(dsigma_sum, opacity < 1e-30f ? 1e-30f : opacity);
}

// The column whose warp sum warp_reduce_scatter leaves in lane `lane`.
__device__ __forceinline__ int reduce_col(int lane) {
  const int b1 = (lane >> 1) & 1, b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1;
  const int idx = !b2 ? (b3 ? 3 + b1 : b1) : ((!b3 && !b1) ? 2 : -1);
  return idx < 0 ? -1 : 5 * ((lane >> 4) & 1) + idx;
}

__global__ void __launch_bounds__(kSubThreads, 4)
composite_bwd_kernel(const float* __restrict__ table, int sentinel,
                     const int* __restrict__ entry_rank, long long n_entries,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ sx, const int* __restrict__ sy,
                     int tile_h, int tile_x, int n_sub, int n_sub_x,
                     const float* __restrict__ fwd_out,
                     const float* __restrict__ gout, const int* __restrict__ sub_live,
                     const int* __restrict__ order, float* scratch, int* tile_done,
                     float* grads) {
  __shared__ __align__(16) float ent[kBatch * kRowStride];
  __shared__ float part[kWarps][kBatch][kCols];
  __shared__ unsigned s_hit[kWarps][kWords];
  __shared__ int s_last;
  const float4* rows = reinterpret_cast<const float4*>(ent);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const SubTilePixel me = sub_tile_pixel(order, n_sub, n_sub_x, sx, sy, tile_h, tile_x);
  const long long start = tile_starts[me.t];
  const int live = sub_live[me.item];
  const int my_col = (lane & 1) ? -1 : reduce_col(lane);

  const size_t p = static_cast<size_t>(tile_h) * tile_x;
  const float* fo = fwd_out + static_cast<size_t>(me.t) * kOutRows * p + me.pix;
  const float* go = gout + static_cast<size_t>(me.t) * kOutRows * p + me.pix;
  float T = fo[4 * p];
  // A pixel past the tile's edge (me.pix 0: its reads are the tile's first
  // pixel's) walks nothing.
  const int n_contrib = me.inside ? static_cast<int>(fo[5 * p]) : 0;
  const float g0 = go[0 * p], g1 = go[1 * p], g2 = go[2 * p], g3 = go[3 * p];
  float S = mul_rn(go[4 * p], T);
  // One sub-tile writes the final rows; several write partial rows for the fold.
  float* dst = n_sub == 1 ? grads
                          : scratch + static_cast<size_t>(me.item % n_sub) * n_entries * kCols;

  for (int top = live; top > 0; top -= kBatch) {
    const int lo = max(0, top - kBatch);
    const int nb = top - lo;
    // The previous batch's partials and rows are fully read.
    __syncthreads();
    if (tid < nb) {
      stage_row(table, entry_rank, n_entries, start + lo + tid, sentinel,
                ent + tid * kRowStride);
    }
    __syncthreads();
    // The warp walks, back to front, only the entries whose box meets its
    // patch (a ballot per 32 entries); `hit` marks those it kept.
#pragma unroll 1
    for (int h = kWords - 1; h >= 0; --h) {
      const int e = 32 * h + lane;
      unsigned todo = __ballot_sync(
          kFull, me.warp_inside && e < nb && !misses_patch(rows[3 * e], me.wx0, me.wy0));
      unsigned hit = 0u;
      while (todo != 0u) {
        const int bit = 31 - __clz(todo);
        todo &= ~(1u << bit);
        const int j = 32 * h + bit;
        float v[kCols];
#pragma unroll
        for (int k = 0; k < kCols; ++k) v[k] = 0.0f;
        bool kept = false;
        if (lo + j < n_contrib) {
          const float4 r0 = rows[3 * j];
          const float4 r1 = rows[3 * j + 1];
          const float dx = me.px - r0.x;
          const float dy = me.py - r0.y;
          const float a = r1.x, b = r1.y, c = r1.z;
          const EntryAlpha ea = entry_alpha(dx, dy, a, b, c, r1.w);
          if (ea.keep) {
            kept = true;
            const float4 r2 = rows[3 * j + 2];
            const float r = __frcp_rn(1.0f - ea.alpha);
            const float t_before = mul_rn(T, r);
            const float w = mul_rn(ea.alpha, t_before);
            const float q = add_rn(add_rn(add_rn(mul_rn(r2.x, g0), mul_rn(r2.y, g1)),
                                          mul_rn(r2.z, g2)),
                                   mul_rn(r2.w, g3));
            const float qw = mul_rn(q, w);
            // From here on only the gradient terms: contraction allowed.
            const float dsig = ea.raw < kAlphaMax ? mul_rn(ea.alpha, r) * S - qw : 0.0f;
            S = add_rn(S, qw);
            T = t_before;
            v[0] = -(a * dx + b * dy) * dsig;
            v[1] = -(b * dx + c * dy) * dsig;
            v[2] = 0.5f * dsig * dx * dx;
            v[3] = dsig * dx * dy;
            v[4] = 0.5f * dsig * dy * dy;
            v[5] = dsig;
            v[6] = g0 * w;
            v[7] = g1 * w;
            v[8] = g2 * w;
            v[9] = g3 * w;
          }
        }
        if (__any_sync(kFull, kept)) {
          const float sum = warp_reduce_scatter(v, lane);
          if (my_col >= 0) part[warp][j][my_col] = sum;
          hit |= 1u << bit;
        }
      }
      if (lane == 0) s_hit[warp][h] = hit;
    }
    __syncthreads();
    // One thread per (entry, column) of the batch: the sum over warps, in
    // warp order. Column 5 becomes d opacity = -sum dsigma / opacity once
    // the tile's sum is complete.
    for (int i = tid; i < nb * kCols; i += kSubThreads) {
      const int j = i / kCols, k = i % kCols;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if ((s_hit[w][j >> 5] >> (j & 31)) & 1u) s = add_rn(s, part[w][j][k]);
      }
      if (n_sub == 1 && k == 5) s = opacity_grad(s, ent[j * kRowStride + 7]);
      dst[static_cast<size_t>(start + lo + j) * kCols + k] = s;
    }
  }
  if (n_sub == 1) return;

  // The tile's last block folds the sub-tiles' partial rows, sub 0 first.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tile_done[me.t], 1) == n_sub - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int* lives = sub_live + static_cast<size_t>(me.t) * n_sub;
  int tile_live = 0;
  for (int u = 0; u < n_sub; ++u) tile_live = max(tile_live, lives[u]);
  for (int i = tid; i < tile_live * kCols; i += kSubThreads) {
    const int e = i / kCols, k = i % kCols;
    const size_t at = static_cast<size_t>(start + e) * kCols + k;
    float s = 0.0f;
    for (int u = 0; u < n_sub; ++u) {
      if (e < lives[u]) s = add_rn(s, __ldcg(scratch + static_cast<size_t>(u) * n_entries * kCols + at));
    }
    if (k == 5) {
      const int row = table_row(entry_rank, n_entries, start + e, sentinel);
      s = opacity_grad(s, table[static_cast<size_t>(row) * kCols + 5]);
    }
    grads[at] = s;
  }
}

}  // namespace

// table (n_rows, 10) f32 with the zero sentinel as its last row;
// entry_rank (n_entries,) int32; tile_starts, sx, sy (num_tiles,) int32;
// tiles of tile_h x tile_x pixels (both > 0); fwd_out and gout (num_tiles,
// 8, tile_h * tile_x) f32: K1's output and its cotangent; sub_x: the
// sub-tile width the caller sized sub_live, order and scratch for (kSubX,
// else cudaErrorInvalidValue); with n_sub = ceil(tile_h / 16) *
// ceil(tile_x / sub_x) sub-tiles per tile, row by row: sub_live
// (num_tiles * n_sub,) int32 each sub-tile's live prefix; order (same size)
// the work items, deepest first; scratch (n_sub, n_entries, 10) f32 (unused
// when n_sub is 1); tile_done (num_tiles,) int32 zeroed; grads (n_entries,
// 10) f32 zeroed (rows past each tile's live prefix are not written).
// Returns cudaGetLastError().
extern "C" int composite_bwd(const float* table, int n_rows, const int* entry_rank,
                             long long n_entries, const int* tile_starts, const int* sx,
                             const int* sy, int num_tiles, int tile_h, int tile_x,
                             const float* fwd_out, const float* gout, int sub_x,
                             const int* sub_live, const int* order, float* scratch,
                             int* tile_done, float* grads, void* stream) {
  if (sub_x != tinysplat::kSubX || tile_h <= 0 || tile_x <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  int n_sub_x, n_sub;
  tinysplat::sub_tile_grid(tile_h, tile_x, &n_sub_x, &n_sub);
  composite_bwd_kernel<<<num_tiles * n_sub, tinysplat::kSubThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, n_rows - 1, entry_rank, n_entries, tile_starts, sx, sy, tile_h, tile_x, n_sub,
      n_sub_x, fwd_out, gout, sub_live, order, scratch, tile_done, grads);
  return static_cast<int>(cudaGetLastError());
}
