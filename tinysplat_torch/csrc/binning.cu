// B1-B4: tile binning (splats -> (tile, depth)-sorted entries) with no host
// sync.
//
// Replaces the XLA binning of the JAX package's bin_splats_dense
// (tinysplat_tpu/ops/binning.py:88-418 _sorted_intersections, :495-561),
// which works in fixed-capacity buffers and returns its counters as device
// scalars. Its plain version is tinysplat_torch/ops/binning.py
// (bin_splats_dense_plain, and the per-stage plain functions of
// ops/binning_cuda.py), which sizes its expansions on the host.
//
// - B1 bin_count: one thread per depth rank r. It reads splat order[r] and
//   computes its tile rectangle, the alpha-ellipse cull and the band map,
//   then walks its rows: the row count and the sum of the rows' clipped
//   span lengths (its entries).
// - B2 bin_emit: one thread per depth rank, with the inclusive scans of
//   B1's two counts (torch.cumsum, as JAX uses jnp.cumsum). It writes its
//   kept entries' (tile id, depth rank) at its entry offset: spans past
//   span_capacity and entries past dup_capacity are dropped, mid-splat and
//   mid-span where the cuts fall. The thread at the span cut (or the last
//   thread) writes the counters [num_entries, total, dup_overflow].
// - B3 radix_hist / B4 radix_scatter: one 8-bit digit pass of a stable LSD
//   radix sort of the kept entries by tile id. Entries come in depth order,
//   so the stable sort leaves every tile's entries front to back. B3
//   counts a block's digits (shared-memory atomics: counts do not depend
//   on the order); on the first pass it also counts whole tile ids into
//   full_counts (a block's counts in shared memory, its non-zero ones then
//   added to device memory; on grids past kSmemTiles, device-memory
//   atomics: order-free again). The digit-major counts' scan gives every
//   (digit, block) its first output slot; B4 ranks a block's items within
//   each digit in input order by warp ballots and per-warp counts, never
//   by racing atomics, so two runs give the same bytes.
//
// Bound: bytes. B1 and B2 read ~30 bytes of a splat (order, xys, radius,
// valid, conic, opacity) through the depth order and write 8 bytes a rank
// (B1) or 8 an entry (B2); a pass of B3 + B4 reads 8 bytes an entry twice
// and writes 8. The float work (a log and a few square roots a splat, a
// few dozen FP32 operations a row) is far below the memory's rate.
//
// Arithmetic: op for op with the plain version on the card, so that every
// floor lands on the same side. Each product, sum and quotient is its own
// round-to-nearest intrinsic (__fmul_rn ...), which the compiler never
// fuses, as torch's ops each round on their own (and the source builds with
// -fmad=false, ops/_build.py EXTRA_FLAGS); logf equals torch.log on
// the card (16.7M inputs). torch divides by a host scalar on the card as a
// product with its reciprocal taken in double and rounded to float32 (255.0
// for 1/255, where the float32 reciprocal would move a splat's ellipse by a
// row): those reciprocals come from the wrapper. NaN propagates through min
// / max as torch.minimum / maximum / clamp propagate it; float -> int casts
// are CUDA's saturating ones, as torch's on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 8;
constexpr int kSortTile = kSortThreads * kItems;  // entries a sort block takes
constexpr int kDigits = 256;
// Tile grids up to this many tiles count whole tile ids in shared memory:
// the dynamic counters and B3's static digit histogram within the 48 KB a
// block gets without opting in. Larger grids (8x8 tiles at 1024x768: 12,288;
// at 1066x1600: 26,800) count in device memory.
constexpr int kSmemTiles = (48 * 1024 - kDigits * (int)sizeof(int)) / (int)sizeof(int);
static_assert(kSmemTiles == 12032, "binning_cuda.SMEM_TILES mirrors kSmemTiles");

struct Geom {
  int n, tiles_x, tiles_y, tiles_y_glob, row_stride, row_offset;
  float ts_h, ts_x, inv_ts_h, inv_ts_x, inv_alpha_eps;
};

struct Splats {
  const int* order;
  const float* xys;
  const int* radii;
  const uint8_t* valid;
  const float* conics;     // null: no ellipse cull
  const float* opacities;  // null with conics
};

__device__ __forceinline__ bool isnan_(float v) { return v != v; }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.maximum / torch.minimum / clamp: NaN in, NaN out.
__device__ __forceinline__ float maxn(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minn(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }
// torch's float -> int32 cast of a floored value on the card, and + 1 with
// int32 wrap.
__device__ __forceinline__ int floor_i(float v) { return (int)floorf(v); }
__device__ __forceinline__ int plus_one(int v) { return (int)((unsigned)v + 1u); }
// int32 a - b with wrap, as torch's int32 tensors subtract.
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
// max(a - b, 0) without wrap (binning.splat_rects takes it in int64).
__device__ __forceinline__ int span_or_0(int a, int b) {
  const long long d = (long long)a - (long long)b;
  return d > 0 ? (int)d : 0;
}
// Python's floor division of ints.
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Rect {
  int bx0, width, by0, rows;
  // _ellipse_constants (pixels)
  float dymax, dxg, p1, k1, k2, inva, dystar, cx, cy;
};

// binning.splat_rects for splat i.
__device__ Rect splat_rect(const Splats& s, const Geom& g, int i) {
  Rect q;
  const float x = s.xys[2 * i], y = s.xys[2 * i + 1];
  const int rad = s.radii[i];
  const float r = (float)rad;
  // projection.tile_ranges on the global rows.
  int bx0 = clampi(floor_i(mul(sub(x, r), g.inv_ts_x)), 0, g.tiles_x);
  int bx1 = clampi(plus_one(floor_i(mul(add(x, r), g.inv_ts_x))), 0, g.tiles_x);
  int by0 = clampi(floor_i(mul(sub(y, r), g.inv_ts_h)), 0, g.tiles_y_glob);
  int by1 = clampi(plus_one(floor_i(mul(add(y, r), g.inv_ts_h))), 0, g.tiles_y_glob);
  if (rad <= 0) {
    bx1 = bx0;
    by1 = by0;
  }
  bool alive = s.valid[i] != 0;
  q.cx = x;
  q.cy = y;
  if (s.conics) {
    const float A = maxn(s.conics[3 * i], 1e-12f);
    const float B = s.conics[3 * i + 1];
    const float C = maxn(s.conics[3 * i + 2], 1e-12f);
    const float op = s.opacities[i];
    const float t_s = logf(mul(maxn(op, 1e-30f), g.inv_alpha_eps));
    const float det = maxn(sub(mul(A, C), mul(B, B)), 1e-20f);
    const float t2 = mul(2.0f, maxn(t_s, 0.0f));
    q.dymax = __fsqrt_rn(dvd(mul(t2, A), det));
    q.dxg = __fsqrt_rn(dvd(mul(t2, C), det));
    q.p1 = dvd(-B, A);
    q.k1 = -det;
    q.k2 = mul(t2, A);
    q.inva = dvd(1.0f, A);
    q.dystar = mul(-B, __fsqrt_rn(dvd(t2, mul(C, det))));
    bx0 = max(bx0, floor_i(mul(sub(x, q.dxg), g.inv_ts_x)));
    bx1 = min(bx1, plus_one(floor_i(mul(add(x, q.dxg), g.inv_ts_x))));
    by0 = max(by0, floor_i(mul(sub(y, q.dymax), g.inv_ts_h)));
    by1 = min(by1, plus_one(floor_i(mul(add(y, q.dymax), g.inv_ts_h))));
    alive = alive && (t_s > 0.0f);
  }
  if (g.row_stride != 1) {  // global rows -> the band's local rows
    by0 = clampi(-floordiv(wrap_sub(g.row_offset, by0), g.row_stride), 0, g.tiles_y);
    by1 = clampi(plus_one(floordiv(wrap_sub(wrap_sub(by1, 1), g.row_offset), g.row_stride)),
                 0, g.tiles_y);
  }
  q.bx0 = bx0;
  q.width = span_or_0(bx1, bx0);
  q.by0 = by0;
  q.rows = (alive && q.width > 0) ? span_or_0(by1, by0) : 0;
  return q;
}

// The ellipse's x half-extent at offset dy, and its max over [lo, hi].
__device__ __forceinline__ float f_of(const Rect& q, float dy) {
  return add(mul(q.p1, dy), mul(q.inva, __fsqrt_rn(maxn(add(mul(mul(q.k1, dy), dy), q.k2), 0.0f))));
}
__device__ __forceinline__ float band_max(const Rect& q, float lo, float hi) {
  const float lo_c = minn(maxn(lo, -q.dymax), q.dymax);
  const float hi_c = minn(maxn(hi, -q.dymax), q.dymax);
  const bool inside = (q.dystar >= lo_c) && (q.dystar <= hi_c);
  return inside ? q.dxg : maxn(f_of(q, lo_c), f_of(q, hi_c));
}

// Row j of the splat's rectangle: its span's first tile id and length
// (binning.expand_spans / _span_extent).
__device__ __forceinline__ void span_of(const Rect& q, const Geom& g, bool clip, int j,
                                        long long& base, long long& len) {
  const float tile_row = add((float)q.by0, (float)j);
  const float bx0f = (float)q.bx0, widthf = (float)q.width;
  float tx0 = bx0f, lenf = widthf;
  if (clip) {
    const float row_g = g.row_stride != 1
                            ? add(mul(tile_row, (float)g.row_stride), (float)g.row_offset)
                            : tile_row;
    const float dy0 = sub(mul(row_g, g.ts_h), q.cy);
    const float dy1 = add(dy0, sub(g.ts_h, 1.0f));
    const float dx_hi = band_max(q, dy0, dy1);
    const float dx_lo = -band_max(q, -dy1, -dy0);
    const float x_last = sub(add(bx0f, widthf), 1.0f);
    tx0 = minn(maxn(floorf(mul(add(q.cx, dx_lo), g.inv_ts_x)), bx0f), x_last);
    const float tx1 = minn(maxn(floorf(mul(add(q.cx, dx_hi), g.inv_ts_x)), tx0), x_last);
    lenf = add(sub(tx1, tx0), 1.0f);
  }
  len = (long long)lenf;
  base = (long long)add(mul(tile_row, (float)g.tiles_x), tx0);
}

__global__ void __launch_bounds__(kBlock)
    bin_count_kernel(Splats s, Geom g, int* rows_out, int* ents_out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= g.n) return;
  const Rect q = splat_rect(s, g, s.order[r]);
  const bool clip = s.conics != nullptr;
  long long ents = 0;
  for (int j = 0; j < q.rows; ++j) {
    long long base, len;
    span_of(q, g, clip, j, base, len);
    ents += len;
  }
  rows_out[r] = q.rows;
  ents_out[r] = (int)ents;
}

struct Emit {
  const int *rows, *ents;
  const long long *rows_incl, *ents_incl;
  long long dup_capacity, span_capacity;
  int* tile_of;
  int* rank_of;
  int* counters;  // [num_entries, total_intersections, dup_overflow]
};

__device__ void write_counters(const Emit& e, long long total, long long total_spans) {
  long long span_over = total_spans - e.span_capacity;
  span_over = span_over > 0 ? span_over : 0;
  if (span_over > 0) {
    const long long kept_spans = total_spans < e.span_capacity ? total_spans : e.span_capacity;
    const long long mean_w = kept_spans > 0 ? (total + kept_spans - 1) / kept_spans : 1;
    span_over *= mean_w > 1 ? mean_w : 1;
  }
  const long long dup_over = total > e.dup_capacity ? total - e.dup_capacity : 0;
  e.counters[0] = (int)(total < e.dup_capacity ? total : e.dup_capacity);
  e.counters[1] = (int)total;
  e.counters[2] = (int)(dup_over + span_over);
}

__global__ void __launch_bounds__(kBlock) bin_emit_kernel(Splats s, Geom g, Emit e) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= g.n) return;
  const int rows = e.rows[r];
  const long long span0 = e.rows_incl[r] - rows;      // this splat's first span
  const long long entry0 = e.ents_incl[r] - e.ents[r];  // and first entry
  const long long total_spans = e.rows_incl[g.n - 1];
  const bool cut_here = total_spans > e.span_capacity && span0 < e.span_capacity &&
                        e.span_capacity <= span0 + rows;
  if (total_spans <= e.span_capacity && r == g.n - 1)
    write_counters(e, e.ents_incl[g.n - 1], total_spans);
  if (rows == 0 || span0 >= e.span_capacity || (entry0 >= e.dup_capacity && !cut_here)) return;
  const long long room = e.span_capacity - span0;
  const int kept_rows = room < rows ? (int)room : rows;
  const Rect q = splat_rect(s, g, s.order[r]);
  const bool clip = s.conics != nullptr;
  long long pos = entry0;
  for (int j = 0; j < kept_rows; ++j) {
    long long base, len;
    span_of(q, g, clip, j, base, len);
    for (long long k = 0; k < len && pos + k < e.dup_capacity; ++k) {
      e.tile_of[pos + k] = (int)(base + k);
      e.rank_of[pos + k] = r;
    }
    pos += len;
  }
  if (cut_here) write_counters(e, pos, total_spans);
}

__global__ void __launch_bounds__(kSortThreads)
    radix_hist_kernel(const int* keys, const int* counters, int shift, int blocks, int* hist,
                      int* full_counts, int num_tiles) {
  __shared__ int h[kDigits];
  extern __shared__ int tile_h[];  // num_tiles counters where the grid fits
  const int t = threadIdx.x;
  const bool smem_tiles = full_counts != nullptr && num_tiles <= kSmemTiles;
  h[t] = 0;
  if (smem_tiles)
    for (int b = t; b < num_tiles; b += kSortThreads) tile_h[b] = 0;
  __syncthreads();
  const int n = counters[0];
  const int base = blockIdx.x * kSortTile;
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kSortThreads + t;
    if (i >= n) break;
    const int key = keys[i];
    atomicAdd(&h[(key >> shift) & (kDigits - 1)], 1);
    if (smem_tiles)
      atomicAdd(&tile_h[key], 1);
    else if (full_counts)
      atomicAdd(&full_counts[key], 1);
  }
  __syncthreads();
  hist[t * blocks + blockIdx.x] = h[t];
  if (smem_tiles && base < n)
    for (int b = t; b < num_tiles; b += kSortThreads)
      if (tile_h[b]) atomicAdd(&full_counts[b], tile_h[b]);
}

__global__ void __launch_bounds__(kSortThreads)
    radix_scatter_kernel(const int* keys, const int* vals, const int* hist, const int* incl,
                         const int* counters, int shift, int blocks, int* out_keys,
                         int* out_vals) {
  __shared__ int run[kDigits];              // next output slot of each digit
  __shared__ int wslot[kSortWarps][kDigits];  // a round's per-warp counts, then slots
  const int n = counters[0];
  const int base = blockIdx.x * kSortTile;
  if (base >= n) return;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const unsigned lower = (1u << lane) - 1u;
  run[t] = incl[t * blocks + blockIdx.x] - hist[t * blocks + blockIdx.x];
  for (int k = 0; k < kItems && base + k * kSortThreads < n; ++k) {
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) wslot[w][t] = 0;
    __syncthreads();
    const int i = base + k * kSortThreads + t;
    const bool ok = i < n;
    const int key = ok ? keys[i] : 0;
    const int val = ok ? vals[i] : 0;
    const int d = (key >> shift) & (kDigits - 1);
    // Lanes holding the same digit: eight ballots, one a digit bit.
    unsigned peers = __ballot_sync(0xffffffffu, ok);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const bool bit = (d >> b) & 1;
      const unsigned m = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? m : ~m;
    }
    const int rank = __popc(peers & lower);
    if (ok && rank == 0) wslot[warp][d] = __popc(peers);
    __syncthreads();
    // Digit t: each warp's first slot, warps in order.
    int acc = run[t];
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = wslot[w][t];
      wslot[w][t] = acc;
      acc += c;
    }
    run[t] = acc;
    __syncthreads();
    if (ok) {
      const int pos = wslot[warp][d] + rank;
      if (out_keys) out_keys[pos] = key;
      out_vals[pos] = val;
    }
    __syncthreads();
  }
}

Geom make_geom(int n, int tiles_x, int tiles_y, int row_stride, int row_offset, float ts_h,
               float ts_x, float inv_ts_h, float inv_ts_x, float inv_alpha_eps) {
  return Geom{n, tiles_x, tiles_y, tiles_y * row_stride, row_stride, row_offset,
              ts_h, ts_x, inv_ts_h, inv_ts_x, inv_alpha_eps};
}

}  // namespace

extern "C" int bin_count(const int* order, const float* xys, const int* radii,
                         const uint8_t* valid, const float* conics, const float* opacities,
                         int n, int tiles_x, int tiles_y, int row_stride, int row_offset,
                         float ts_h, float ts_x, float inv_ts_h, float inv_ts_x,
                         float inv_alpha_eps, int* rows, int* ents, cudaStream_t stream) {
  if (row_stride < 1 || (conics == nullptr) != (opacities == nullptr))
    return (int)cudaErrorInvalidValue;
  const Splats s{order, xys, radii, valid, conics, opacities};
  const Geom g = make_geom(n, tiles_x, tiles_y, row_stride, row_offset, ts_h, ts_x, inv_ts_h,
                           inv_ts_x, inv_alpha_eps);
  if (n > 0) bin_count_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(s, g, rows, ents);
  return (int)cudaGetLastError();
}

extern "C" int bin_emit(const int* order, const float* xys, const int* radii,
                        const uint8_t* valid, const float* conics, const float* opacities,
                        int n, int tiles_x, int tiles_y, int row_stride, int row_offset,
                        float ts_h, float ts_x, float inv_ts_h, float inv_ts_x,
                        float inv_alpha_eps, const int* rows, const int* ents,
                        const long long* rows_incl, const long long* ents_incl,
                        long long dup_capacity, long long span_capacity, int* tile_of,
                        int* rank_of, int* counters, cudaStream_t stream) {
  if (row_stride < 1 || (conics == nullptr) != (opacities == nullptr) || span_capacity < 1)
    return (int)cudaErrorInvalidValue;
  const Splats s{order, xys, radii, valid, conics, opacities};
  const Geom g = make_geom(n, tiles_x, tiles_y, row_stride, row_offset, ts_h, ts_x, inv_ts_h,
                           inv_ts_x, inv_alpha_eps);
  const Emit e{rows, ents, rows_incl, ents_incl, dup_capacity, span_capacity,
               tile_of, rank_of, counters};
  if (n > 0) bin_emit_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(s, g, e);
  return (int)cudaGetLastError();
}

extern "C" int radix_hist(const int* keys, const int* counters, int shift, int blocks,
                          int* hist, int* full_counts, int num_tiles, cudaStream_t stream) {
  if (shift < 0 || shift > 24 || num_tiles < 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      full_counts != nullptr && num_tiles <= kSmemTiles ? (size_t)num_tiles * sizeof(int) : 0;
  if (blocks > 0)
    radix_hist_kernel<<<blocks, kSortThreads, smem, stream>>>(keys, counters, shift, blocks,
                                                              hist, full_counts, num_tiles);
  return (int)cudaGetLastError();
}

extern "C" int radix_scatter(const int* keys, const int* vals, const int* hist,
                             const int* incl, const int* counters, int shift, int blocks,
                             int* out_keys, int* out_vals, cudaStream_t stream) {
  if (shift < 0 || shift > 24) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    radix_scatter_kernel<<<blocks, kSortThreads, 0, stream>>>(keys, vals, hist, incl, counters,
                                                              shift, blocks, out_keys,
                                                              out_vals);
  return (int)cudaGetLastError();
}
