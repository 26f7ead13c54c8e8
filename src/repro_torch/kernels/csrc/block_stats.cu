// Block statistics for token blocks: per block, [nonpad, matches, mass].
//
// Replaces the TPU kernels in src/repro/kernels/block_stats.py:
//   block_stats_kernel / block_stats_pallas                  (one (N, L) block)
//   block_stats_batched_kernel / block_stats_batched_pallas  (nb blocks, ragged)
// nonpad is the count of tokens != 0, matches the count of contiguous
// occurrences of a token pattern (a pattern longer than a row never matches),
// mass the sum of token ids.  Rows at or past a block's length are left out,
// whatever they hold; a length above R means all R rows, 0 or less none.
//
// Design.  The Pallas grid runs in order and revisits a (3,) accumulator;
// Hopper's CTAs run in parallel and in no order.  So the grid is 2-D over
// (row tile, block) with no host padding: each CTA reads its block's length,
// skips its rows past it, reduces its tile with warp shuffles and shared
// memory, and adds its three partial sums to a per-block int64 accumulator
// with one atomic per statistic.  A second small kernel casts the exact
// integer sums to float32.  The reference sums mass in float32, which is
// inexact past 2**24; here mass is the exact sum rounded once to float32.
//
// Bound on an H100: bytes.  The kernel reads nb * R_valid * L * 4 bytes of
// tokens once and does a few integer operations per token, far below the
// card's operation rate, so the least time is those bytes over 3.35 TB/s.
//
// Left for later: 16-byte vector loads (each thread loads one int32 at a
// time here), and one persistent CTA per SM walking many tiles in place of
// one CTA per tile.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
block_stats_kernel(const int* __restrict__ tokens,
                   const int* __restrict__ lengths,
                   const int* __restrict__ pattern, int p, int nb, int rows,
                   int len, int tile_rows,
                   unsigned long long* __restrict__ acc) {
  __shared__ long long partial[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = __ldg(pattern);
  // blockDim.x tokens further on: step_r rows and step_c columns
  const int step_r = kThreads / len;
  const int step_c = kThreads - step_r * len;

  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    int valid = rows;
    if (lengths != nullptr) valid = min(max(__ldg(lengths + b), 0), rows);
    const int r0 = blockIdx.x * tile_rows;
    const int r1 = min(r0 + tile_rows, valid);
    if (r0 >= r1) continue;  // uniform across the CTA

    const int* tile = tokens + (static_cast<long long>(b) * rows + r0) * len;
    const long long n = static_cast<long long>(r1 - r0) * len;
    long long nonpad = 0, matches = 0, mass = 0;
    int r = threadIdx.x / len;
    int c = threadIdx.x - r * len;
    for (long long e = threadIdx.x; e < n; e += kThreads) {
      const int t = __ldg(tile + e);
      nonpad += (t != 0);
      mass += t;
      if (t == first && c <= len - p) {
        const int* row = tile + static_cast<long long>(r) * len + c;
        bool hit = true;
        for (int j = 1; j < p && hit; ++j) {
          hit = __ldg(row + j) == __ldg(pattern + j);
        }
        matches += hit;
      }
      c += step_c;
      r += step_r;
      if (c >= len) {
        c -= len;
        r += 1;
      }
    }

    nonpad = warp_sum(nonpad);
    matches = warp_sum(matches);
    mass = warp_sum(mass);
    if (lane == 0) {
      partial[0][warp] = nonpad;
      partial[1][warp] = matches;
      partial[2][warp] = mass;
    }
    __syncthreads();
    if (warp == 0) {
      nonpad = lane < kWarps ? partial[0][lane] : 0;
      matches = lane < kWarps ? partial[1][lane] : 0;
      mass = lane < kWarps ? partial[2][lane] : 0;
      nonpad = warp_sum(nonpad);
      matches = warp_sum(matches);
      mass = warp_sum(mass);
      if (lane == 0) {
        // two's-complement addition: a negative partial mass adds correctly
        atomicAdd(acc + 3 * b + 0, static_cast<unsigned long long>(nonpad));
        atomicAdd(acc + 3 * b + 1, static_cast<unsigned long long>(matches));
        atomicAdd(acc + 3 * b + 2, static_cast<unsigned long long>(mass));
      }
    }
    __syncthreads();  // partial[] is reused for the next block
  }
}

__global__ void cast_kernel(const unsigned long long* __restrict__ acc,
                            float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ll2float_rn(static_cast<long long>(acc[i]));
}

}  // namespace

// tokens: (nb, rows, len) int32, contiguous, on the device.
// lengths: (nb,) int32 valid-row counts, or null for all rows.
// pattern: (p,) int32 with p >= 1.  acc: (nb, 3) uint64 scratch.
// out: (nb, 3) float32.  Returns cudaGetLastError() after the launches.
extern "C" int block_stats_launch(const void* tokens, const void* lengths,
                                  const void* pattern, int p, int nb,
                                  int rows, int len, int tile_rows, void* acc,
                                  void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* acc64 = static_cast<unsigned long long*>(acc);
  cudaError_t err = cudaMemsetAsync(
      acc64, 0, sizeof(unsigned long long) * 3 * static_cast<size_t>(nb), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + tile_rows - 1) / tile_rows, nb < 65535 ? nb : 65535);
  block_stats_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(tokens), static_cast<const int*>(lengths),
      static_cast<const int*>(pattern), p, nb, rows, len, tile_rows, acc64);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 3 * nb;
  cast_kernel<<<(n + 255) / 256, 256, 0, s>>>(acc64, static_cast<float*>(out),
                                              n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
