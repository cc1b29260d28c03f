// K3: per-entry gradient rows -> per-splat rows, a segment sum over the rows
// gathered in splat-id order.
//
// Replaces tinysplat_tpu/ops/rasterize_pallas.py:_segsum_kernel (the Pallas
// TPU kernel behind grad_reduce="mxu", driven by _mxu_bwd). What it
// computes: with rows (D, 10) in entry order, exactly as K2 writes them,
// perm (D,) the stable id-sorted order of the entries and bounds[i] the
// first sorted position of splat id i,
//
//   out[i] = sum of rows[perm[p]] over p in [bounds[i], bounds[i + 1])
//
// added in increasing p. The JAX package gathers rows[perm] into a sorted
// copy outside its kernel (a TPU workaround, _row_gather_i16); here the
// gather is an indexed load inside the kernel, so no sorted copy is written
// and read back. The sort and the bounds stay plain torch ops around it.
//
// What bounds it on an H100: bytes. Each summed row is read once (40 B) with
// its perm entry (4 B), each bound once, each output row written once: at
// S summed rows and M splats, S x 44 + (M + 1) x 4 + M x 40 bytes (~50 MB,
// ~15 us at 3.35 TB/s at the bench scene's first training step); one add
// per input float, far below the FP32 rate. The rows are scattered in entry
// order, so each 40-byte row costs two 32-byte sectors however it is read.
//
// What the design does about it. A block owns kThreads consecutive splat
// ids, as the TPU kernel owns 128 output rows per grid step, and thread t
// sums splat i0 + t's run: a warp's 32 runs are neighbours in the sorted
// order, so its perm loads are coalesced. Each step loads kUnroll perm
// entries and then their rows' 8-byte pieces (rows are 8-byte aligned), so
// up to 32 x kUnroll rows of a warp are in flight at once, and a warp steps
// as long as its longest run (runs are short: at most 8 rows at the bench
// scene). The ten accumulators start at zero and add the run's rows in
// sorted order with __fadd_rn: the plain version (segsum_plain) adds the same
// values in the same order, so the two agree bit for bit, and with no
// atomics two launches give the same bytes. The block's 256 x 10 output
// floats go out through shared memory as one contiguous range of 16-byte
// stores, which measured faster than each lane storing its own row.
// Empty and dead splats write zeros; bounds are clamped to [0, D] and perm
// entries to [0, D), so nothing is read out of range.
//
// Measured against a design that staged each block's rows through shared
// memory with cp.async (double-buffered chunks of 128-512 rows): that one was
// slower at every chunk size, since the rows are scattered anyway and its
// block-wide barriers cost more than they saved (PERF.md, section 6).

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 10;
constexpr int kPieces = kCols / 2;  // 8-byte pieces of a row
constexpr int kThreads = 256;       // splat ids per block
constexpr int kUnroll = 2;          // rows of a run in flight per step

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float2* __restrict__ rows, int n_rows, const int* __restrict__ perm,
              const int* __restrict__ bounds, int num_segments, float* __restrict__ out) {
  __shared__ __align__(16) float staged[kThreads * kCols];
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  int lo = 0, hi = 0;
  if (i < num_segments) {
    lo = min(max(bounds[i], 0), n_rows);
    hi = max(min(bounds[i + 1], n_rows), lo);
  }
  const int len = hi - lo;
  const int longest = __reduce_max_sync(0xffffffffu, len);  // the warp's trip count
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  for (int k0 = 0; k0 < longest; k0 += kUnroll) {
    int e[kUnroll];  // -1 past the run
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      e[u] = k0 + u < len ? min(max(__ldg(perm + lo + k0 + u), 0), n_rows - 1) : -1;
    float2 v[kUnroll][kPieces];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < kPieces; ++k)
        v[u][k] = e[u] >= 0 ? __ldg(rows + static_cast<size_t>(e[u]) * kPieces + k)
                            : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e[u] < 0) continue;
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        acc[2 * k] = __fadd_rn(acc[2 * k], v[u][k].x);
        acc[2 * k + 1] = __fadd_rn(acc[2 * k + 1], v[u][k].y);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kCols; ++k) staged[threadIdx.x * kCols + k] = acc[k];
  __syncthreads();
  const int n_out = min(kThreads, num_segments - i0) * kCols;
  float* dst = out + static_cast<size_t>(i0) * kCols;  // i0 * 40 bytes: 16-byte aligned
  const int n4 = n_out / 4;
  for (int q = threadIdx.x; q < n4; q += kThreads)
    reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(staged)[q];
  for (int q = n4 * 4 + threadIdx.x; q < n_out; q += kThreads) dst[q] = staged[q];
}

}  // namespace

// rows (n_rows, 10) f32 in entry order, 8-byte aligned; perm (n_rows,)
// int32; bounds (num_segments + 1,) int32, nondecreasing; out
// (num_segments, 10) f32, 16-byte aligned. Returns cudaGetLastError().
extern "C" int segsum(const float* rows, int n_rows, const int* perm, const int* bounds,
                      int num_segments, float* out, void* stream) {
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (num_segments + kThreads - 1) / kThreads;
  segsum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(rows), n_rows, perm, bounds, num_segments, out);
  return static_cast<int>(cudaGetLastError());
}
