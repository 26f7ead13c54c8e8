// Block statistics for token blocks: per block, [nonpad, matches, mass].
//
// Replaces the TPU kernels in src/repro/kernels/block_stats.py:
//   block_stats_kernel / block_stats_pallas                  (one (N, L) block)
//   block_stats_batched_kernel / block_stats_batched_pallas  (nb blocks, ragged)
// nonpad is the count of tokens != 0, matches the count of contiguous
// occurrences of a token pattern within a row (a pattern longer than a row
// never matches), mass the sum of token ids.  Rows at or past a block's length
// are left out, whatever they hold; a length above R means all R rows, 0 or
// less none.  The reference sums mass in float32, which is inexact past 2**24;
// here mass is the exact int64 sum rounded once to float32.
//
// Bound on an H100: bytes.  The kernel reads the valid rows' tokens once
// (nb * R_valid * L * 4 bytes) and does a few integer operations per token,
// far below the card's operation rate, so the least time is those bytes over
// 3.35 TB/s.  Reaching it takes about 25 KB in flight on every SM (3.35 TB/s
// times about 1 us of loaded latency, over 132 SMs).
//
// Design: one device kernel a call, no scratch, no memset, no atomics.
//  * Each block's valid rows are one contiguous run of tokens.  The C CTAs of
//    a thread-block cluster split a block's run into C contiguous spans, cut
//    at 16-byte boundaries; the grid is persistent, each cluster walking the
//    blocks b = cluster, cluster + clusters, ...
//  * In a CTA one producer thread streams the 16-byte-aligned interior of
//    its span through a ring of kStages x 16 KiB of shared memory with 1-D
//    bulk copies (cp.async.bulk, completing on a "full" mbarrier; no tensor
//    map), the first stages before the CTA's own set-up is done, while 16
//    consumer warps read int4s from the stages, count nonpad, sum mass into
//    int64, test the pattern and release each stage on an "empty" mbarrier.
//    One thread keeps up to 64 KiB in flight a CTA without spending
//    registers on it.  A token's column is (flat index mod L), so any L
//    works; each thread carries its column from one int4 to its next.  The
//    unaligned head and tail of a span (under 4 tokens each) go through
//    plain loads.
//  * The pattern test is a filter, then a careful path: a window can start
//    only where a token is the pattern's first and the next its second (the
//    token after an int4 comes from the next lane by a shuffle), and only
//    such candidates read the rest of their window, from the stage or, past
//    it, with __ldg (a window never leaves its row, so it stays in valid
//    memory).  Testing every first token in full cost more than the rest of
//    the count on the main path's data.
//  * A block's partials go from the warps to warp 0 of the CTA (a barrier
//    of the consumer warps), which stores the CTA's three int64 sums into
//    rank 0's shared memory (distributed shared memory), one slot a block
//    and rank.  Rank 0 adds the ranks' sums and writes __ll2float_rn of the
//    exact totals into the float32 output (every row, a block of 0 valid
//    rows too) after every kSlots blocks and after the last: before the
//    last, once the cluster has passed a barrier; after it, once every CTA
//    has arrived on rank 0's "ready" mbarrier, and the other CTAs are done
//    (no CTA ever reads another's shared memory, so none has to outlive a
//    reader).  The slots alternate between two halves, so a CTA that runs
//    ahead into the next group never overwrites what rank 0 is reading.
//  * The host picks C and the number of clusters (block_stats.py:
//    launch_shape); lengths arrive as int32 or int64 and are clamped here.
//
// Left for later: fusing the sampled-row gather (pipeline/stream.py) into the
// kernel, so that the estimator reads the sampled rows of the full blocks in
// place (the reference gathers first too); and spreading one block over more
// than one cluster: at most 16 CTAs share a block, so a single block is read
// by 16 of the card's 132 SMs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;        // + one producer warp
constexpr int kStages = 4;
constexpr int kStageTokens = 4096;               // 16 KiB of int32
constexpr int kStageBytes = 4 * kStageTokens;
constexpr int kSweep = 4 * kConsumers;           // tokens the consumers take at once
constexpr int kPer = kStageTokens / kSweep;      // int4s a consumer takes a stage
static_assert(kStageTokens % kSweep == 0, "a stage is whole sweeps");
constexpr int kMaxCluster = 16;
constexpr int kSlots = 16;                       // blocks between cluster flushes
constexpr int kPatternSmem = 256;                // pattern tokens kept in shared memory
// shared memory: the ring, then [2][kSlots][kMaxCluster][3] int64 block
// totals (rank 0's are read), [2][kConsumerWarps][3] int64 warp partials,
// the pattern's first tokens, the ring's mbarriers and rank 0's `ready`
constexpr int kTotals = 2 * kSlots * kMaxCluster * 3;
constexpr int kParts = 2 * kConsumerWarps * 3;
constexpr int kSmemBytes = kStages * kStageBytes + 8 * (kTotals + kParts)
                           + 4 * kPatternSmem + (2 * kStages + 1) * 8;
constexpr int kMaxDevices = 64;

struct Params {
  const int* tokens;
  const void* lengths;      // (nb,) int32 or int64, or null: every row
  const int* pattern;       // (p,) int32, p >= 1
  float* out;               // (nb, 3)
  long long rows;
  int len;
  int nb;
  int p;
  int lengths_is64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of `bar` with this parity has completed; a wait of
// over ~10 s traps, so a fault in the ring surfaces as a launch error
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// arrive on the mbarrier at `bar` in the shared memory of cluster rank
// `rank`, releasing this thread's earlier writes to the cluster
__device__ __forceinline__ void remote_arrive(uint32_t bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// wait for a phase of `bar` that other CTAs of the cluster complete, and
// acquire their writes
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar,
                                                      uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait_cluster(bar, parity)) {
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global memory into this CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the two halves of a cluster barrier (every thread of the cluster arrives;
// each thread alternates arrive and wait).  The arrive orders nothing: the
// few threads that write or read another CTA's shared memory fence first
// (fence_cluster), and the wait acquires.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a barrier over the consumer warps only (the producer never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// 1 if x != 0, else 0, in one instruction
__device__ __forceinline__ unsigned nonzero(int x) {
  unsigned r;
  asm("min.u32 %0, %1, 1;" : "=r"(r) : "r"(x));
  return r;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Token indices g whose address tokens + g is 16-byte aligned satisfy
// (g + mis) % 4 == 0, with mis = (address of tokens / 4) % 4.
__device__ __forceinline__ long long align_up(long long g, int mis) {
  return ((g + mis + 3) & ~3LL) - mis;
}
__device__ __forceinline__ long long align_down(long long g, int mis) {
  return ((g + mis) & ~3LL) - mis;
}

// One CTA's share of one block: tokens [s0, s1), its aligned interior
// [lo, hi) (a multiple of 4 tokens) and the head [s0, lo) and tail [hi, s1).
struct Span {
  long long base, s0, s1, lo, hi;   // base: the block's first token
};

__device__ __forceinline__ Span span_of(const Params& p, int b, int rank,
                                        int cluster, int shift, int mis) {
  long long valid = p.rows;
  if (p.lengths != nullptr) {
    const long long n = p.lengths_is64
        ? __ldg(static_cast<const long long*>(p.lengths) + b)
        : static_cast<long long>(__ldg(static_cast<const int*>(p.lengths) + b));
    valid = n < 0 ? 0 : (n > p.rows ? p.rows : n);
  }
  const long long base = static_cast<long long>(b) * p.rows * p.len;
  const long long n = valid * p.len;
  const long long end = base + n;
  auto cut = [&](int q) -> long long {
    if (q == 0) return base;
    if (q == cluster) return end;
    const long long g = align_up(base + ((n * q) >> shift), mis);
    return g < end ? g : end;
  };
  Span s;
  s.base = base;
  s.s0 = cut(rank);
  s.s1 = cut(rank + 1);
  const long long up = align_up(s.s0, mis);
  s.lo = up < s.s1 ? up : s.s1;
  const long long down = align_down(s.s1, mis);
  s.hi = down > s.lo ? down : s.lo;
  return s;
}

// Whether pattern[1:] follows at row[1:] (the caller checked row[0] and that
// the window lies in the row).  `at(j)` reads the j-th token of the window.
template <typename At>
__device__ __forceinline__ bool window_matches(const Params& p,
                                               const int* s_pat, At at) {
  for (int j = 1; j < p.p; ++j) {
    const int want = j < kPatternSmem ? s_pat[j] : __ldg(p.pattern + j);
    if (at(j) != want) return false;
  }
  return true;
}

// (g - base) % len for a token g of the block that starts at base, in 32-bit
// arithmetic where the block allows it
__device__ __forceinline__ int column(long long g, long long base, int len,
                                      bool small) {
  return small ? static_cast<int>(static_cast<unsigned>(g - base) %
                                  static_cast<unsigned>(len))
               : static_cast<int>((g - base) % len);
}

__global__ void __launch_bounds__(kThreads, 2)
block_stats_kernel(const Params p, int csize, int clusters) {
  extern __shared__ int4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_raw);
  int* stage0 = reinterpret_cast<int*>(smem);
  long long* totals =                 // [2][kSlots][kMaxCluster][3]
      reinterpret_cast<long long*>(smem + kStages * kStageBytes);
  long long* parts = totals + kTotals;   // [2][kConsumerWarps][3]
  int* s_pat = reinterpret_cast<int*>(parts + kParts);
  const uint32_t full = smem_u32(s_pat + kPatternSmem);   // [kStages]
  const uint32_t empty = full + 8 * kStages;              // [kStages]
  const uint32_t ready = empty + 8 * kStages;   // rank 0: the last group is in

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int shift = __ffs(csize) - 1;
  const int cid = blockIdx.x >> shift;
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(p.tokens) >> 2) & 3);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the producer's lane 0 issues every copy of this CTA's spans, in order:
  // chunks of sp from `next` on, while fewer than `limit` have been issued
  int n = 0;           // chunks issued (producer) or consumed (consumers)
  Span sp;
  long long next = 0;
  auto issue = [&](int limit) {
    for (; next < sp.hi && n < limit; next += kStageTokens, ++n) {
      const long long end = next + kStageTokens < sp.hi ? next + kStageTokens
                                                        : sp.hi;
      const int st = n % kStages;
      if (n >= kStages) mbar_wait(empty + 8 * st, (n / kStages - 1) & 1);
      const uint32_t bytes = static_cast<uint32_t>(4 * (end - next));
      mbar_expect_tx(full + 8 * st, bytes);
      bulk_load(smem_u32(stage0 + st * kStageTokens), p.tokens + next, bytes,
                full + 8 * st);
    }
  };
  if (threadIdx.x == kConsumers) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    mbar_init(ready, csize);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first stages go out before anything else is ready
    if (cid < p.nb) {
      sp = span_of(p, cid, rank, csize, shift, mis);
      next = sp.lo;
      issue(kStages);
    }
  }
  for (int j = threadIdx.x; j < p.p && j < kPatternSmem; j += kThreads) {
    s_pat[j] = __ldg(p.pattern + j);
  }
  __syncthreads();
  // Every CTA of the cluster has started once this barrier completes; the
  // first write into rank 0's shared memory waits for it (a cluster of one
  // writes only into itself).  A wait on a cluster barrier also passes a
  // barrier of the whole CTA, so every warp waits at the same points: after
  // block 0, and at every flush but the last.
  if (csize > 1) cluster_arrive_relaxed();

  // the blocks of this cluster are b = cid + i * clusters; blocks i of one
  // group (i / kSlots) are added up by rank 0 after the group's last block
  auto last = [&](int i) { return cid + (i + 1) * clusters >= p.nb; };
  auto flush_after = [&](int i) { return i % kSlots == kSlots - 1 || last(i); };

  if (warp == kConsumerWarps) {
    for (int i = 0; cid + i * clusters < p.nb; ++i) {
      if (lane == 0) {
        if (i > 0) {
          sp = span_of(p, cid + i * clusters, rank, csize, shift, mis);
          next = sp.lo;
        }
        issue(INT_MAX);
      }
      __syncwarp();
      if (i == 0 && csize > 1) cluster_wait();
      if (flush_after(i) && !last(i)) {
        cluster_arrive_relaxed();
        cluster_wait();
      }
    }
    return;
  }

  // the consumers
  const int t = threadIdx.x;
  const int len = p.len;
  const bool small = p.rows * p.len < (1LL << 31);   // columns in 32 bits
  const int step_c = kSweep % len;   // a sweep moves a thread's column by this
  const int step_stage = kStageTokens % len;
  const int first = s_pat[0];
  const bool one = p.p == 1;
  const int second = one ? 0 : s_pat[1];
  const int lim = len - p.p;         // a window may start at column <= lim
  // Whether a window may start in the int4 v: a token is the pattern's first
  // and the next its second.  nx is the token after v.w, or unknown (edge):
  // then a first token in v.w alone is enough.  The careful path then tests
  // each candidate in full.  (A pattern of one token: any first token.)
  auto starts = [&](const int4 v, int nx, bool edge) {
    if (one) {
      return (v.x == first) | (v.y == first) | (v.z == first) |
             (v.w == first);
    }
    return ((v.x == first) & (v.y == second)) |
           ((v.y == first) & (v.z == second)) |
           ((v.z == first) & (v.w == second)) |
           ((v.w == first) & (edge | (nx == second)));
  };
  int i0 = 0;                        // first block of the current group
  for (int i = 0; cid + i * clusters < p.nb; ++i) {
    const Span s = span_of(p, cid + i * clusters, rank, csize, shift, mis);
    unsigned nonpad = 0, matches = 0;
    long long mass = 0;

    // head and tail: under 4 tokens each, plain loads
    const int n_head = static_cast<int>(s.lo - s.s0);
    const int n_tail = static_cast<int>(s.s1 - s.hi);
    if (t < n_head + n_tail) {
      const long long g = t < n_head ? s.s0 + t : s.hi + (t - n_head);
      const int tok = __ldg(p.tokens + g);
      nonpad += tok != 0;
      mass += tok;
      if (tok == first && column(g, s.base, len, small) <= lim) {
        const int* w = p.tokens + g;
        matches += window_matches(p, s_pat, [&](int j) { return __ldg(w + j); });
      }
    }

    // the aligned interior, chunk by chunk through the ring
    int col = column(s.lo + 4 * t, s.base, len, small);
    for (long long c0 = s.lo; c0 < s.hi; c0 += kStageTokens, ++n) {
      const int ntok = static_cast<int>(
          (c0 + kStageTokens < s.hi ? c0 + kStageTokens : s.hi) - c0);
      const int st = n % kStages;
      const int* stage = stage0 + st * kStageTokens;
      const int4* stage4 = reinterpret_cast<const int4*>(stage);
      mbar_wait(full + 8 * st, (n / kStages) & 1);
      // matches that start in the int4 v at stage[e], column c
      auto careful = [&](const int4 v, int e, int c) -> unsigned {
        const int tok[4] = {v.x, v.y, v.z, v.w};
        unsigned m = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          int ck = c + k;
          while (ck >= len) ck -= len;
          if (tok[k] != first || ck > lim) continue;
          const int at = e + k;
          const int* g = p.tokens + c0 + at;
          m += window_matches(p, s_pat, [&](int j) {
            return at + j < ntok ? stage[at + j] : __ldg(g + j);
          });
        }
        return m;
      };
      auto count = [&](const int4 v) {
        nonpad += (nonzero(v.x) + nonzero(v.y)) +
                  (nonzero(v.z) + nonzero(v.w));
        mass += (static_cast<long long>(v.x) + v.y) +
                (static_cast<long long>(v.z) + v.w);
      };
      if (ntok == kStageTokens) {
        // a full stage: kPer int4s a thread, loaded together
        // (all lanes take part, so the token after v.w comes from the next
        // lane; lane 31's lies in another warp)
        int4 v[kPer];
        int nx[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) v[u] = stage4[t + u * kConsumers];
        bool any = false;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          count(v[u]);
          nx[u] = __shfl_down_sync(0xffffffffu, v[u].x, 1);
          any |= starts(v[u], nx[u], lane == 31);
        }
        if (any) {
          int c = col;
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            if (starts(v[u], nx[u], lane == 31)) {
              matches += careful(v[u], 4 * (t + u * kConsumers), c);
            }
            c += step_c;
            if (c >= len) c -= len;
          }
        }
        col += step_stage;
        if (col >= len) col -= len;
      } else {
        for (int e = 4 * t; e < ntok; e += kSweep) {
          const int4 v = stage4[e / 4];
          count(v);
          if (starts(v, 0, true)) matches += careful(v, e, col);
          col += step_c;
          if (col >= len) col -= len;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    // the block's partials: warps -> warp 0 -> rank 0's totals
    const long long nonpad_w = warp_sum(static_cast<long long>(nonpad));
    const long long matches_w = warp_sum(static_cast<long long>(matches));
    const long long mass_w = warp_sum(mass);
    long long* part = parts + (i & 1) * kConsumerWarps * 3;
    if (lane == 0) {
      part[3 * warp + 0] = nonpad_w;
      part[3 * warp + 1] = matches_w;
      part[3 * warp + 2] = mass_w;
    }
    if (i == 0 && csize > 1) {
      __syncwarp();
      cluster_wait();   // rank 0 has started
    }
    consumers_sync();
    if (warp == 0) {
      // part[] alternates between blocks: a warp writes this half again two
      // blocks on, after the consumers_sync that warp 0 reaches only when
      // it is done reading it here
      long long sum[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        sum[j] = warp_sum(lane < kConsumerWarps ? part[3 * lane + j] : 0);
      }
      if (lane == 0) {
        long long* dst = cluster.map_shared_rank(
            totals + (((i / kSlots) & 1) * kSlots + i % kSlots) * kMaxCluster * 3
                + 3 * rank,
            0);
        dst[0] = sum[0];
        dst[1] = sum[1];
        dst[2] = sum[2];
      }
    }
    if (flush_after(i)) {
      // The group's totals are in rank 0 once every CTA has passed this
      // point.  Before the last group every thread passes a cluster barrier
      // (a CTA writes the other half of totals in the next group, and this
      // half again only after the next flush, which rank 0 reaches after
      // reading); after the last, each CTA's storing thread arrives on rank
      // 0's `ready` mbarrier, rank 0 waits for all of them, and the others
      // are done: nothing reads their shared memory.
      if (!last(i)) {
        if (t == 0) fence_cluster();   // the stores into rank 0, above
        __syncwarp();
        cluster_arrive_relaxed();
        cluster_wait();
      } else {
        if (t == 0) remote_arrive(ready, 0);
        if (rank == 0) mbar_wait_cluster(ready, 0);
      }
      if (rank == 0) {
        // (block, statistic) pairs: block i0 + pair / 3, statistic pair % 3;
        // a pair takes csize lanes, lane r reading rank r's sum, and the
        // lanes' exact sums meet in the group's first lane, which rounds
        // once and writes the output
        const long long* half = totals + ((i / kSlots) & 1) * kSlots *
                                             kMaxCluster * 3;
        const int pairs = 3 * (i - i0 + 1);
        const int per_warp = 32 >> shift;
        const int r = lane & (csize - 1);
        for (int at = warp * per_warp; at < pairs;
             at += kConsumerWarps * per_warp) {
          const int pair = at + (lane >> shift);
          const int ii = i0 + pair / 3;
          long long sum = pair < pairs
              ? half[((ii % kSlots) * kMaxCluster + r) * 3 + pair % 3] : 0;
          for (int off = csize / 2; off > 0; off >>= 1) {
            sum += __shfl_down_sync(0xffffffffu, sum, off);
          }
          if (r == 0 && pair < pairs) {
            p.out[3LL * (cid + ii * clusters) + pair % 3] = __ll2float_rn(sum);
          }
        }
        if (!last(i)) fence_cluster();   // these reads before the next flush
      }
      i0 = i + 1;
    }
  }
}

std::atomic<bool> g_ready[kMaxDevices];

// Raise the kernel's dynamic shared-memory limit and allow clusters of 16 on
// the current device, once.
cudaError_t prepare_device() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && g_ready[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(block_stats_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(block_stats_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < kMaxDevices) g_ready[dev].store(true);
  return err;
}

cudaLaunchConfig_t launch_config(int cluster, int clusters, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster * clusters));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;   // a CTA is a cluster of one anyway
  return cfg;
}

}  // namespace

// tokens: (nb, rows, len) int32, contiguous, on the device, any 4-byte
// alignment.  lengths: (nb,) valid-row counts, int64 if lengths_is64 else
// int32, or null for all rows.  pattern: (p,) int32 with p >= 1.  out: (nb, 3)
// float32, every element written.  cluster in {1, 2, 4, 8, 16}; the grid is
// cluster * clusters CTAs.  Returns cudaGetLastError() after the launch.
extern "C" int block_stats_launch(const void* tokens, const void* lengths,
                                  int lengths_is64, const void* pattern, int p,
                                  int nb, long long rows, int len, int cluster,
                                  int clusters, void* out, void* stream) {
  cudaError_t err = prepare_device();
  if (err != cudaSuccess) return static_cast<int>(err);
  Params prm;
  prm.tokens = static_cast<const int*>(tokens);
  prm.lengths = lengths;
  prm.pattern = static_cast<const int*>(pattern);
  prm.out = static_cast<float*>(out);
  prm.rows = rows;
  prm.len = len;
  prm.nb = nb;
  prm.p = p;
  prm.lengths_is64 = lengths_is64;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      cluster, clusters, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, block_stats_kernel, prm, cluster, clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = threads a CTA, dynamic shared memory a CTA (bytes), CTAs an SM
// at once, and clusters of `cluster` CTAs the card holds at once (0 if it
// cannot launch that size) on the current device.  Returns 0 or a cudaError_t.
extern "C" int block_stats_occupancy(int cluster, int* out) {
  cudaError_t err = prepare_device();
  if (err != cudaSuccess) return static_cast<int>(err);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, block_stats_kernel,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, 1, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, block_stats_kernel, &cfg) !=
      cudaSuccess) {
    clusters = 0;
    cudaGetLastError();   // not sticky: leave no error for the next launch
  }
  out[0] = kThreads;
  out[1] = kSmemBytes;
  out[2] = ctas;
  out[3] = clusters;
  return 0;
}

extern "C" const char* block_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
