// P1: f32 rebuilt from bf16/u16 lane pairs, and back; a u16 window copied
// from a dynamic row offset through shared memory with cp.async.
//
// Replaces scripts/probe_bf16_bitcast.py: _kernel_a ... _kernel_e and kern_f
// (the Pallas TPU lowering probe). The question it answers here: can an
// entry table carry each f32 as two 16-bit halves (and colours as bf16) and
// get every bit back? That is the byte cut a half-width table (64 B -> 32 B a
// row) would give the compositing kernels K1 and K2. Every variant moves the
// bits as integers (uint16_t / uint32_t loads, shifts and ors,
// __uint_as_float): no float conversion touches them, so no NaN pattern can
// be quieted on the way.
//
//   variant 0, A: (S, 2L) u16 interleaved (lo, hi) pairs -> (S, L) f32, each
//                 pair read as one 32-bit word (the pair is the f32's
//                 little-endian bytes).
//   variant 1, B: the same pairs taken apart as two u16, (hi << 16) | lo.
//   variant 2, C: (S, 2L) u16 halves, lanes [0, L) = lo, [L, 2L) = hi.
//   variant 3, D: C, plus the hi lanes written out again as bf16 colours.
//   variant 4, E: (S, L) f32 -> (S, 2L) u16 halves (the reverse pack).
//   variant 5, F: (N, W) u16 source; window k = rows [off_k, off_k + CH)
//                 copied with cp.async into shared memory, then written out
//                 to (K, CH, W).
//
// What bounds it on an H100: bytes. Each variant reads its input once and
// writes its output once, with one or two integer ops per 4 bytes: at the
// bench frame's entry budget (760,000 rows x 16 f32 lanes) ~97 MB, ~29 us
// at 3.35 TB/s.
//
// What the design does about it: every access is 16 bytes wide (A, B: 4
// f32 a thread; C, D, E: 8 lanes of a row a thread, so 16-byte u16 loads
// and two 16-byte f32 stores), and neighbouring threads touch neighbouring
// 16-byte chunks, so every warp access is coalesced. The wrapper holds the
// shapes to a multiple of 8 f32 lanes and the pointers to 16-byte
// boundaries, so no thread has a tail. F moves 16 bytes per cp.async, one
// block per window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 8;  // f32 lanes a thread on C, D and E

__device__ __forceinline__ float from_halves(uint32_t lo, uint32_t hi) {
  return __uint_as_float((hi << 16) | lo);
}

__device__ __forceinline__ long long first_index() {
  return blockIdx.x * (long long)blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long stride() { return (long long)gridDim.x * blockDim.x; }

// A: each (lo, hi) pair read as one word; 4 words a 16-byte load.
__global__ void pairs_word(const uint4* __restrict__ in, float4* __restrict__ out,
                           long long n4) {
  for (long long i = first_index(); i < n4; i += stride()) {
    const uint4 w = in[i];
    out[i] = make_float4(__uint_as_float(w.x), __uint_as_float(w.y), __uint_as_float(w.z),
                         __uint_as_float(w.w));
  }
}

// B: the same pairs taken apart as two u16 and joined with a shift and an or.
__global__ void pairs_strided(const uint4* __restrict__ in, float4* __restrict__ out,
                              long long n4) {
  for (long long i = first_index(); i < n4; i += stride()) {
    const uint4 w = in[i];
    out[i] = make_float4(
        from_halves(w.x & 0xFFFFu, w.x >> 16), from_halves(w.y & 0xFFFFu, w.y >> 16),
        from_halves(w.z & 0xFFFFu, w.z >> 16), from_halves(w.w & 0xFFFFu, w.w >> 16));
  }
}

// C (colours == nullptr) and D: 8 lo and 8 hi halves of a row a thread.
__global__ void halves(const uint16_t* __restrict__ in, float* __restrict__ out,
                       uint16_t* __restrict__ colours, long long rows, int lanes) {
  const int groups = lanes / V;
  for (long long g = first_index(); g < rows * groups; g += stride()) {
    const long long r = g / groups;
    const int c = static_cast<int>(g - r * groups) * V;
    const uint16_t* row = in + r * 2 * lanes;
    const uint4 lo = *reinterpret_cast<const uint4*>(row + c);
    const uint4 hi = *reinterpret_cast<const uint4*>(row + lanes + c);
    float4* o = reinterpret_cast<float4*>(out + r * lanes + c);
    o[0] = make_float4(from_halves(lo.x & 0xFFFFu, hi.x & 0xFFFFu),
                       from_halves(lo.x >> 16, hi.x >> 16),
                       from_halves(lo.y & 0xFFFFu, hi.y & 0xFFFFu),
                       from_halves(lo.y >> 16, hi.y >> 16));
    o[1] = make_float4(from_halves(lo.z & 0xFFFFu, hi.z & 0xFFFFu),
                       from_halves(lo.z >> 16, hi.z >> 16),
                       from_halves(lo.w & 0xFFFFu, hi.w & 0xFFFFu),
                       from_halves(lo.w >> 16, hi.w >> 16));
    if (colours) *reinterpret_cast<uint4*>(colours + r * lanes + c) = hi;
  }
}

// E: 8 words of a row a thread, split into one 16-byte store of lo halves
// and one of hi halves.
__global__ void pack_halves(const uint32_t* __restrict__ in, uint16_t* __restrict__ out,
                            long long rows, int lanes) {
  const int groups = lanes / V;
  for (long long g = first_index(); g < rows * groups; g += stride()) {
    const long long r = g / groups;
    const int c = static_cast<int>(g - r * groups) * V;
    const uint4 a = *reinterpret_cast<const uint4*>(in + r * lanes + c);
    const uint4 b = *reinterpret_cast<const uint4*>(in + r * lanes + c + 4);
    uint16_t* row = out + r * 2 * lanes;
    *reinterpret_cast<uint4*>(row + c) = make_uint4(
        (a.x & 0xFFFFu) | (a.y << 16), (a.z & 0xFFFFu) | (a.w << 16),
        (b.x & 0xFFFFu) | (b.y << 16), (b.z & 0xFFFFu) | (b.w << 16));
    *reinterpret_cast<uint4*>(row + lanes + c) = make_uint4(
        (a.x >> 16) | (a.y & 0xFFFF0000u), (a.z >> 16) | (a.w & 0xFFFF0000u),
        (b.x >> 16) | (b.y & 0xFFFF0000u), (b.z >> 16) | (b.w & 0xFFFF0000u));
  }
}

// One block per window: 16-byte cp.async chunks into shared memory, wait,
// then write the window out.
__global__ void window_copy(const uint16_t* __restrict__ src, long long src_rows, int width,
                            const int* __restrict__ offsets, int window_rows,
                            uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) uint16_t buf[];
  const int k = blockIdx.x;
  const long long off = min(max((long long)offsets[k], 0LL), src_rows - window_rows);
  const int chunks = window_rows * width / 8;  // 8 u16 = 16 bytes
  const uint16_t* from = src + off * width;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(buf + 8 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(from + 8 * c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  uint4* to = reinterpret_cast<uint4*>(out + (long long)k * window_rows * width);
  const uint4* from_smem = reinterpret_cast<const uint4*>(buf);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) to[c] = from_smem[c];
}

// One thread per work item, up to 2^30 blocks (then the loops stride).
int blocks_for(long long items, int threads) {
  const long long b = (items + threads - 1) / threads;
  return static_cast<int>(b < (1LL << 30) ? (b > 0 ? b : 1) : (1LL << 30));
}

}  // namespace

// variant 0-4: `in` and `out` as listed above for (rows, lanes) = (S, L)
// f32 lanes, lanes % 8 == 0; `out2` the bf16 colours of D (else unused).
// Every pointer on a 16-byte boundary.
// variant 5: `in` the (rows, lanes) u16 source, `offsets` (n_windows,)
// int32, `out` (n_windows, window_rows, lanes) u16; lanes % 8 == 0.
// Returns cudaGetLastError().
extern "C" int probe_bitcast(int variant, const void* in, void* out, void* out2,
                             long long rows, int lanes, const int* offsets, int n_windows,
                             int window_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long n = rows * lanes;
  if (variant != 5 && n == 0) return static_cast<int>(cudaSuccess);
  switch (variant) {
    case 0:
      pairs_word<<<blocks_for(n / 4, threads), threads, 0, s>>>(
          static_cast<const uint4*>(in), static_cast<float4*>(out), n / 4);
      break;
    case 1:
      pairs_strided<<<blocks_for(n / 4, threads), threads, 0, s>>>(
          static_cast<const uint4*>(in), static_cast<float4*>(out), n / 4);
      break;
    case 2:
    case 3:
      halves<<<blocks_for(n / V, threads), threads, 0, s>>>(
          static_cast<const uint16_t*>(in), static_cast<float*>(out),
          variant == 3 ? static_cast<uint16_t*>(out2) : nullptr, rows, lanes);
      break;
    case 4:
      pack_halves<<<blocks_for(n / V, threads), threads, 0, s>>>(
          static_cast<const uint32_t*>(in), static_cast<uint16_t*>(out), rows, lanes);
      break;
    case 5: {
      if (n_windows == 0) return static_cast<int>(cudaSuccess);
      const size_t smem = static_cast<size_t>(window_rows) * lanes * sizeof(uint16_t);
      window_copy<<<n_windows, threads, smem, s>>>(static_cast<const uint16_t*>(in), rows,
                                                   lanes, offsets, window_rows,
                                                   static_cast<uint16_t*>(out));
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
