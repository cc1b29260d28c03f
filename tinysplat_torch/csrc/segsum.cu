// K3: segment sums of id-sorted per-entry gradient rows into per-splat rows.
//
// Replaces tinysplat_tpu/ops/rasterize_pallas.py:_segsum_kernel (the Pallas
// TPU kernel behind grad_reduce="mxu", driven by _mxu_bwd). What it
// computes: with the per-entry gradient rows gathered in id-sorted order and
// bounds[i] = the first sorted position of splat id i,
//
//   out[i] = sum of rows[bounds[i] : bounds[i + 1]]      (i < num_segments)
//
// The sort, the gather and the bounds (torch.searchsorted) are plain torch
// ops around the kernel, as the JAX package computes them outside its kernel
// too. The caller passes the bounds of the real splat ids only, so the run
// of pad entries (the zero sentinel row's) is never summed.
//
// What bounds it on an H100: bytes. Each row is 10 floats read once, each
// output row 10 floats written once, one add per input float: ~40 MB at the
// bench scene, ~12 us at 3.35 TB/s, and 1/4 flop per byte.
//
// What the design does about it: one thread per splat sums its contiguous
// run in sorted order with 10 register accumulators, so every row is read
// once, every output row written once, and the result is deterministic and
// equal bit for bit to the plain version (which adds in the same order), with
// no atomics. Neighbouring threads read neighbouring runs, so a warp's loads
// stay within a few cache lines while runs are short (most splats touch a
// few tiles). The 128-id one-hot MXU blocks of the TPU kernel are not
// carried over: they existed to put the sum on the matrix unit.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 10;

__global__ void segsum_kernel(const float* __restrict__ rows, int n_rows,
                              const int* __restrict__ bounds, int num_segments,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_segments) return;
  // Bounds are clamped to the rows, so no bound can read out of range.
  const int lo = min(max(bounds[i], 0), n_rows);
  const int hi = max(min(bounds[i + 1], n_rows), lo);
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  for (int e = lo; e < hi; ++e) {
    const float* r = rows + static_cast<size_t>(e) * kCols;
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = __fadd_rn(acc[k], r[k]);
  }
  float* o = out + static_cast<size_t>(i) * kCols;
#pragma unroll
  for (int k = 0; k < kCols; ++k) o[k] = acc[k];
}

}  // namespace

// rows (n_rows, 10) f32 in id-sorted order; bounds (num_segments + 1,) int32,
// nondecreasing; out (num_segments, 10) f32. Returns cudaGetLastError().
extern "C" int segsum(const float* rows, int n_rows, const int* bounds, int num_segments,
                      float* out, void* stream) {
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int blocks = (num_segments + threads - 1) / threads;
  segsum_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, bounds, num_segments, out);
  return static_cast<int>(cudaGetLastError());
}
