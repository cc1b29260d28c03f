// K2: the analytic backward of K1's front-to-back compositing.
//
// Replaces tinysplat_tpu/ops/rasterize_pallas.py:_bwd_kernel with
// _bwd_window (the Pallas TPU backward compositing kernel). What it computes,
// per tile t and per entry e of the tile's live prefix, summed over the
// tile's 16 x tile_x pixels:
//
//   grads[tile_starts[t] + e] = [dx, dy, d conic a, b, c, d opacity, d c0..c3]
//
// from the forward's rows T_final, n_contrib, last_contrib and the cotangent
// rows g_c0..g_c3, g_T of K1's output. Per pixel, back to front over the
// entries e < n_contrib that K1 kept (sigma >= 0, alpha >= 1/255):
//
//   T_before = T_after / (1 - alpha)      (T_after starts at T_final)
//   w        = alpha T_before;   q = sum_c color_c g_c
//   dsigma   = alpha / (1 - alpha) S - q w   where the clamp did not bind
//              (op exp(-sigma) < 0.999), else 0; S = suffix sum of q w,
//              seeded with g_T T_final
//   d color_c += g_c w;   d opacity += dsigma (then -sum / opacity)
//   d x += -(a dx + b dy) dsigma;   d y += -(b dx + c dy) dsigma
//   d a += dsigma dx^2 / 2;  d b += dsigma dx dy;  d c += dsigma dy^2 / 2
//
// Entries past the tile's live prefix (the block max of last_contrib) are
// not visited: the wrapper zeroes the output first.
//
// What bounds it on an H100: operations. Each (entry, pixel) pair walked
// costs K1's ~16 FP32 operations and an exp to rebuild alpha, ~30 more where
// the pair contributes, and a reduction of 10 sums over the tile's pixels;
// each entry's 40-byte row is read once per tile and its 40-byte gradient
// row written once, so bytes are far below the operation bound.
//
// What the design does about it: as K1, one block per tile and one thread
// per pixel, T and S in registers, rows staged in shared memory as
// struct-of-arrays (broadcast reads). Entries are walked back to front in
// batches of kBatch (32). For each entry, each warp reduces its 32 pixels'
// 10 terms with shuffles, and skips the shuffles when none of its pixels
// kept the entry (__any_sync), which is most warps of a wide tile. The warp
// partials go to shared memory as [warp][entry][10]; once per batch the
// block sums them over warps in a fixed order and writes each entry's row
// once: deterministic, no atomics. The batch is 32 entries, not blockDim as
// in K1, because the partials of 1024 entries x 32 warps would not fit in
// shared memory. All arithmetic is float32 without fused multiply-adds, and
// alpha comes from composite_common.cuh (K1's code), so the keep and clamp
// masks are K1's bit for bit and only the order of the pixel sums differs
// from the plain version.
//
// Not carried over from the TPU kernel: the pixel-moment MXU expansion, the
// log-space cumulative product, the written-slot mask (TPU window stores
// overlapped; here each entry row is written exactly once) and the
// environment switches.

#include "composite_common.cuh"

namespace {

using namespace tinysplat;

constexpr int kBatch = 32;      // entries staged and reduced per block barrier
constexpr int kMaxWarps = 32;   // 1024 threads
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(1024)
composite_bwd_kernel(const float* __restrict__ table, int sentinel,
                     const int* __restrict__ entry_rank, long long n_entries,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ sx, const int* __restrict__ sy,
                     int tile_x, const float* __restrict__ fwd_out,
                     const float* __restrict__ gout, float* __restrict__ grads) {
  __shared__ float ent[kCols][kBatch];
  __shared__ float part[kMaxWarps * kBatch * kCols];
  __shared__ int s_live;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float px = static_cast<float>(sx[t] + tid % tile_x);
  const float py = static_cast<float>(sy[t] + tid / tile_x);
  const int start = tile_starts[t];
  const int count = counts[t];

  const size_t p = static_cast<size_t>(nthreads);
  const float* fo = fwd_out + static_cast<size_t>(t) * kOutRows * p + tid;
  const float* go = gout + static_cast<size_t>(t) * kOutRows * p + tid;
  float T = fo[4 * p];
  const int n_contrib = static_cast<int>(fo[5 * p]);
  const int last_contrib = static_cast<int>(fo[6 * p]);
  const float g0 = go[0 * p], g1 = go[1 * p], g2 = go[2 * p], g3 = go[3 * p];
  float S = mul_rn(go[4 * p], T);

  // The tile's live prefix: the block max of last_contrib.
  if (tid == 0) s_live = 0;
  __syncthreads();
  const unsigned wmax = __reduce_max_sync(kFull, static_cast<unsigned>(last_contrib));
  if (lane == 0) atomicMax(&s_live, static_cast<int>(wmax));
  __syncthreads();
  const int live = min(s_live, count);

  for (int top = live; top > 0; top -= kBatch) {
    const int lo = max(0, top - kBatch);
    const int nb = top - lo;
    // The previous batch's partials and rows are fully read.
    __syncthreads();
    for (int i = tid; i < nb * kCols; i += nthreads) {
      const int j = i / kCols, k = i % kCols;
      const int row = table_row(entry_rank, n_entries, static_cast<long long>(start) + lo + j,
                                sentinel);
      ent[k][j] = table[static_cast<size_t>(row) * kCols + k];
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      float v[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) v[k] = 0.0f;
      bool kept = false;
      if (lo + j < n_contrib) {
        const float dx = px - ent[0][j];
        const float dy = py - ent[1][j];
        const float a = ent[2][j], b = ent[3][j], c = ent[4][j];
        const EntryAlpha ea = entry_alpha(dx, dy, a, b, c, ent[5][j]);
        if (ea.keep) {
          kept = true;
          const float om = 1.0f - ea.alpha;
          const float t_before = div_rn(T, om);
          const float w = mul_rn(ea.alpha, t_before);
          const float q = add_rn(add_rn(add_rn(mul_rn(ent[6][j], g0), mul_rn(ent[7][j], g1)),
                                        mul_rn(ent[8][j], g2)),
                                 mul_rn(ent[9][j], g3));
          const float qw = mul_rn(q, w);
          const float dsig =
              ea.raw < kAlphaMax ? sub_rn(mul_rn(div_rn(ea.alpha, om), S), qw) : 0.0f;
          S = add_rn(S, qw);
          T = t_before;
          v[0] = mul_rn(-add_rn(mul_rn(a, dx), mul_rn(b, dy)), dsig);
          v[1] = mul_rn(-add_rn(mul_rn(b, dx), mul_rn(c, dy)), dsig);
          v[2] = mul_rn(mul_rn(mul_rn(0.5f, dsig), dx), dx);
          v[3] = mul_rn(mul_rn(dsig, dx), dy);
          v[4] = mul_rn(mul_rn(mul_rn(0.5f, dsig), dy), dy);
          v[5] = dsig;
          v[6] = mul_rn(g0, w);
          v[7] = mul_rn(g1, w);
          v[8] = mul_rn(g2, w);
          v[9] = mul_rn(g3, w);
        }
      }
      float mine = 0.0f;
      if (__any_sync(kFull, kept)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int k = 0; k < kCols; ++k) v[k] = add_rn(v[k], __shfl_xor_sync(kFull, v[k], off));
        }
        mine = v[0];
#pragma unroll
        for (int k = 1; k < kCols; ++k) mine = lane == k ? v[k] : mine;
      }
      if (lane < kCols) part[(warp * kBatch + j) * kCols + lane] = mine;
    }
    __syncthreads();
    // One thread per (entry, column) of the batch: the sum over warps, in
    // warp order. Column 5 becomes d opacity = -sum dsigma / opacity.
    for (int i = tid; i < nb * kCols; i += nthreads) {
      const int j = i / kCols, k = i % kCols;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s = add_rn(s, part[w * kBatch * kCols + i]);
      if (k == 5) s = -div_rn(s, fmaxf(ent[5][j], 1e-30f));
      grads[(static_cast<size_t>(start) + lo + j) * kCols + k] = s;
    }
  }
}

}  // namespace

// table (n_rows, 10) f32 with the zero sentinel as its last row;
// entry_rank (n_entries,) int32; tile_starts, counts, sx, sy (num_tiles,) int32;
// fwd_out and gout (num_tiles, 8, 16 * tile_x) f32: K1's output and its
// cotangent; grads (n_entries, 10) f32, zeroed by the caller (rows past each
// tile's live prefix are not written). Returns cudaGetLastError().
extern "C" int composite_bwd(const float* table, int n_rows, const int* entry_rank,
                             long long n_entries, const int* tile_starts, const int* counts,
                             const int* sx, const int* sy, int num_tiles, int tile_x,
                             const float* fwd_out, const float* gout, float* grads,
                             void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const int threads = tinysplat::kTileH * tile_x;
  composite_bwd_kernel<<<num_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_rows - 1, entry_rank, n_entries, tile_starts, counts, sx, sy, tile_x, fwd_out,
      gout, grads);
  return static_cast<int>(cudaGetLastError());
}
