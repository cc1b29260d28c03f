// scatter_rows: per-entry gradient rows -> per-splat rows, the "scatter"
// reduction of the compositing backward.
//
// Replaces tinysplat_tpu/ops/rasterize_pallas.py:125 _scatter_bwd, XLA's
// per-index scatter-add (`dtable.at[ids].add(g)`), which the port first did
// with torch's index_add_ into an (n + 1, 10) buffer whose last row took
// every pad slot. What it computes: with rows (D, 10) in entry order, as K2
// writes them, and rank (D,) each slot's depth rank,
//
//   out[r] = sum of rows[s] over the slots s with rank[s] == r,  0 <= r < n
//   out[n] = 0   (the table's zero sentinel row; nothing is added to it)
//
// A slot whose rank is below 0 (a pad) or n or above is read for its rank
// alone and adds nothing. The adds are atomic, as index_add_'s are on the
// card, so the float sums come in an order that changes from launch to
// launch: a splat's row is a sum of its ~2 entries (at most one a tile), and
// two launches differ by the float32 rounding of those few adds. The card
// tests and chip_smoke.py hold each splat's row to that rounding in any
// order against a float64 sum of the same rows: with k entries,
//   |out[r] - exact| <= 1.001 (k - 1) 2^-24 sum |rows| + max(k, 1) 2^-126
// (the atomics flush subnormals to 0); the sentinel row must be 0. At the
// benchmark's 262k and 1M layouts the largest error came to 0.999 of that
// bound on an H100.
//
// What bounds it on an H100: bytes, all reads. Each slot's rank once (4 B),
// each live slot's row once (40 B), the output once (40 B a splat, zeroed by
// the wrapper and resolved in L2 by the reductions): 4 D + 40 E + 40 (n + 1)
// bytes for D slots and E live ones, ~162 MB (~0.048 ms at 3.35 TB/s) at
// the 1M cell's 8,000,000 slots and 2.24M entries. index_add_ took 12.6 ms
// there: it sent each of the ~5.8M pad slots' ten floats to the one sink row,
// where the atomics queue one after another (~2.2 ns a pad slot).
//
// What the design does about it. A warp takes 32 consecutive slots: one
// coalesced 128-byte load of their ranks and a ballot of the live ones. A
// warp of pads (most of the budget lies past the live entries) exits there.
// Otherwise the warp's 32 rows are 160 consecutive 8-byte pieces (rows are
// 40 B, so every piece is 8-byte aligned), taken in 5 rounds of 32: lane l of
// round k takes piece 32 k + l, so each round's loads are one contiguous
// 256-byte range, and a piece of a live slot is added into its splat's row
// with one vector float reduction (atomicAdd on float2, sm_90: `red.global.
// add.v2.f32`). Within a tile a splat appears at most once, so the adds into
// one row come from ~2 tiles and hardly contend.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 10;
constexpr int kPieces = kCols / 2;  // 8-byte pieces of a row
constexpr int kThreads = 256;
constexpr int kWarp = 32;

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float2* __restrict__ rows, const int* __restrict__ rank,
                    long long n_slots, int n, float2* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const long long s0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp
                       * kWarp;
  if (s0 >= n_slots) return;  // the whole warp: s0 is the warp's
  const int r = s0 + lane < n_slots ? __ldg(rank + s0 + lane) : -1;
  const unsigned live = __ballot_sync(0xffffffffu, r >= 0 && r < n);
  if (live == 0) return;
  const float2* src = rows + s0 * kPieces;
  float2 v[kPieces];
  int dst[kPieces];  // the piece's splat row, or -1
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const int p = k * kWarp + lane;  // piece of the warp's 32 rows
    const int j = p / kPieces;       // its slot in the warp
    const int rj = __shfl_sync(0xffffffffu, r, j);
    dst[k] = (live >> j) & 1u ? rj : -1;
    v[k] = dst[k] >= 0 ? __ldg(src + p) : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    if (dst[k] < 0) continue;
    const int c = (k * kWarp + lane) % kPieces;
    atomicAdd(out + static_cast<long long>(dst[k]) * kPieces + c, v[k]);
  }
}

}  // namespace

// rows (n_slots, 10) f32, 8-byte aligned; rank (n_slots,) int32; out
// (n + 1, 10) f32, zeroed by the caller, 8-byte aligned. Returns
// cudaGetLastError().
extern "C" int scatter_rows(const float* rows, const int* rank, long long n_slots, int n,
                            float* out, void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_slots + kThreads - 1) / kThreads;
  scatter_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(rows), rank, n_slots, n, reinterpret_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
