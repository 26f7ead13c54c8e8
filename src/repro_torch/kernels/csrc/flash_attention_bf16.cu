// Flash attention forward in bfloat16 on Hopper's tensor cores.
//
// Replaces, for bfloat16 inputs, the TPU kernel in
// src/repro/kernels/flash_attention.py: flash_attention_kernel /
// flash_attention_pallas.  q (B, Hq, S, D) and k, v (B, Hkv, S, D) give
// o (B, Hq, S, D) in bfloat16; q head h reads kv head h / (Hq / Hkv).  Scores
// are scaled by 1/sqrt(D) and masked (causal: key <= query; window w > 0:
// key > query - w; keys past S).  The online softmax keeps its running max,
// denominator and accumulator in float32.  The running max starts at the
// TPU kernel's finite -1e30 and masked scores weigh 0 (see online_softmax:
// the output is the TPU kernel's).  o = acc / max(l, 1e-30).
//
// Bound on an H100.  4 * D operations a visible (query, key) pair against
// 2 bytes an element of q, k, v and o: at the serving shape (8, 16, 1024,
// 128) causal that is 34.4 GFLOP against 134 MB, so at the 989 TFLOP/s of
// bf16 tensor-core math the bytes bound it (0.040 ms at 3.35 TB/s), and the
// float32 units (67 TFLOP/s, 0.51 ms) could never approach it.
//
// Design.  A work item is a 128-row q tile of one (batch, q head) and the
// 128-key kv tiles the mask lets it reach (as the TPU kernel's `needed` test
// skips the rest).  The grid is persistent: one CTA an SM takes items until
// none is left, the first one by its index and the rest from a counter in
// device memory (one a stream, zeroed by each launch's last CTA), in an
// order that keeps an L2-sized group of heads together and puts each
// group's heavy (late) causal tiles first.  In a CTA, warpgroups 0 and 1
// each own 64 rows of the item and compute; one thread of warpgroup 2
// loads.
//  - Loads: TMA, through 4-D tensor maps (D, S, H, B) over the strides the
//    caller hands in (the model's transposed views are not copied), into
//    128-byte-swizzled boxes (64 and 32 bytes at D = 32 and 16; D = 128 is
//    two boxes of 64 columns).  Q is loaded once an item, as soon as both
//    warpgroups' last S of the previous item has read it; K and V go
//    through a 2-stage ring, each tile completing on its own mbarrier and
//    each stage released by one arrival of each consumer warpgroup, so the
//    next tiles' copies (across items too) overlap the current math and the
//    previous item's epilogue.  TMA zero-fills rows past S.
//  - S = Q K^T: wgmma m64n128k16, Q and K both K-major from shared memory,
//    float32 accumulators in registers.
//  - Mask (only on tiles that cross the diagonal, the window's edge or S)
//    and the online softmax in registers: one FMA scales a score into the
//    log2 domain and subtracts the max, one ex2 takes its power; a row's
//    max is reduced over the 4 lanes that share it, its sum once at the
//    end.
//  - O += P V: P is rounded to bf16 in registers and fed to wgmma as the A
//    operand straight from S's accumulator layout; V is read MN-major from
//    shared memory (the B descriptor's transpose bit).  O stays float32 in
//    registers.
//  - The two warpgroups take turns issuing their products (named barriers),
//    so one's softmax overlaps the other's S or P V on the tensor cores.
//  - setmaxnreg gives the loader's registers to the consumers (24 / 240).
//    ptxas still keeps each thread within the 168 registers of 384 threads:
//    issuing tile i+1's S beside tile i's P V (64 + 32 + 64 live registers)
//    spilled and ran slower, so each warpgroup waits on each product.
//  - Epilogue: scale by 1 / max(l, 1e-30) (one division a row), round to
//    bf16 once into a staging tile in TMA's swizzled layout, and store each
//    warpgroup's 64 rows with one TMA store through o's tensor map (which
//    drops rows past S); the consumers go on to the next item meanwhile.
//    (A division per element and 4-byte stores from registers were a large
//    share of a short item's time.)
// Shared memory at D = 128: Q 32 KiB + 2 stages x (K 32 + V 32) KiB + the
// output's staging tile 32 KiB = 192 KiB, one CTA an SM.  A wait on an
// mbarrier that lasts over ~10 s traps, so a fault in the pipeline surfaces
// as a launch error instead of a hang.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <map>
#include <mutex>
#include <utility>

#include "flash_attention_host.cuh"

namespace {

constexpr int kBQ = 128;       // query rows a CTA owns (2 warpgroups x 64)
constexpr int kBK = 128;       // keys a kv tile holds (S is m64n128)
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // warpgroups 0, 1 compute; warpgroup 2 loads
constexpr float kNegInf = -1e30f;

static_assert(kBQ == kBK, "Q, K and V tiles share one TMA box and layout");

// a tile of 128 rows x D bf16 as TMA leaves it: kBlocks boxes, each 128 rows
// of kRowBytes, swizzled over kRowBytes
template <int D>
struct Tile {
  static constexpr int kRowBytes = (D < 64 ? D : 64) * 2;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBlocks = D / kBoxCols;
  static constexpr int kBlockBytes = kBK * kRowBytes;
  static constexpr int kBytes = kBlocks * kBlockBytes;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
};

// Q, the K and V stages, the output's staging tile, the mbarriers and the
// item slot, and slack to align to 1024 B
template <int D>
constexpr int smem_bytes() {
  return (2 + 2 * kStages) * Tile<D>::kBytes + 128 + 1024;
}

struct Params {
  int hq, hkv, s, causal, window;
  int group;     // (batch, head) pairs a group of work items holds
  int n_items;   // (batch, q head, q tile) work items
  int* next;     // [0] items handed out beyond the first gridDim.x, [1]
                 // CTAs done; zero at the launch, zeroed by the last CTA
  float scale_log2;   // log2(e) / sqrt(D)
};

// One work item: a 128-row q tile of one (batch, q head) and the kv tiles
// the mask lets it reach.  Items are numbered by (batch, head) group of
// p.group pairs, then heaviest (latest) causal q tile first, then pair: a
// group's K and V stay in L2 while its items run, and the light tiles come
// last.
struct Work {
  int b, h, q0, t_lo, n_tiles;
};

__device__ __forceinline__ Work work_item(const Params& p, int item) {
  const int n_q = (p.s + kBQ - 1) / kBQ;
  const int n_bh = p.n_items / n_q;
  const int per = p.group * n_q;
  const int g = item / per;
  const int r = item % per;
  const int size = min(p.group, n_bh - g * p.group);
  const int bh = g * p.group + r % size;
  Work w;
  w.b = bh / p.hq;
  w.h = bh % p.hq;
  w.q0 = (n_q - 1 - r / size) * kBQ;
  const int k_lo = p.window > 0 ? max(0, w.q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.s - 1, w.q0 + kBQ - 1) : p.s - 1;
  w.t_lo = k_lo / kBK;
  w.n_tiles = k_hi / kBK - w.t_lo + 1;
  return w;
}

// heads a group holds: as many as keep their K and V within 16 MiB of L2
int head_group(int n_bh, int s, int d, int item) {
  const long long kv = 2LL * s * d * item;
  const long long g = (16LL << 20) / (kv > 0 ? kv : 1);
  return static_cast<int>(g < 1 ? 1 : g > n_bh ? n_bh : g);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// a box of shared memory -> global memory through the tensor map; tracked in
// this thread's bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// named barriers 1 and 2 over the 256 consumer threads: sync waits until
// the other warpgroup has arrived
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// named barrier 3 + wg over one warpgroup's 128 threads
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// m64nNk16, f32 += bf16 * bf16: S from two shared-memory descriptors (both
// K-major); O with A in registers and B MN-major (transposed).  d holds the
// accumulator fragment: element i of a thread of warp w, lane l sits at row
// 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 16) {
    wgmma_rs_n16(o, a, b, 1);
  } else if constexpr (D == 32) {
    wgmma_rs_n32(o, a, b, 1);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(o, a, b, 1);
  } else {
    wgmma_rs_n128(o, a, b, 1);
  }
}

// byte offset of (row, col) in a tile as TMA lays it out: the box of 64 (or
// D) columns, then the row, then the 16-byte chunk XOR-swizzled by the row
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  using T = Tile<D>;
  const int c = col % T::kBoxCols;
  const int swz = T::kRowBytes == 128  ? row % 8
                  : T::kRowBytes == 64 ? (row / 2) % 4
                                       : (row / 4) % 2;
  return (col / T::kBoxCols) * T::kBlockBytes + row * T::kRowBytes +
         (((c * 2) / 16) ^ swz) * 16 + (c * 2) % 16;
}

// S = Q K^T for one warpgroup's 64 rows and a 128-key tile, issued (not
// waited for): D / 16 wgmma steps along D, both operands K-major
template <int D>
__device__ __forceinline__ void scores(float (&s)[kBK / 2], uint32_t q,
                                       uint32_t k) {
  using T = Tile<D>;
  const uint64_t qd = gmma_desc(q, 16, 8 * T::kRowBytes, T::kLayout);
  const uint64_t kd = gmma_desc(k, 16, 8 * T::kRowBytes, T::kLayout);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // a step along D moves the start address (16-byte units) only
    const uint32_t off = (kk * 16 / T::kBoxCols) * T::kBlockBytes +
                         (kk * 32) % T::kRowBytes;
    wgmma_ss_n128(s, qd + (off >> 4), kd + (off >> 4), kk > 0);
  }
}

// O += P V for one warpgroup: kBK / 16 wgmma steps along the keys, P from
// registers, V MN-major (its rows are keys, D contiguous)
template <int D>
__device__ __forceinline__ void values(float (&o)[D / 2],
                                       const uint32_t (&pa)[kBK / 16][4],
                                       uint32_t v) {
  using T = Tile<D>;
  const uint64_t vd = gmma_desc(v, T::kBlockBytes, 8 * T::kRowBytes, T::kLayout);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    wgmma_pv<D>(o, pa[kk], vd + ((kk * 16 * T::kRowBytes) >> 4));
  }
}

// S's accumulator fragment for keys 16 kk .. 16 kk + 15 is the A fragment of
// P for the same keys: round it to bf16 pairs
__device__ __forceinline__ void to_bf16(uint32_t (&pa)[kBK / 16][4],
                                        const float (&s)[kBK / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    }
  }
}

// 2^x on the special-function unit; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fold one tile's raw scores into the running max m (log2 domain) and this
// thread's part of the row sums l; leave the probabilities in s and the
// accumulator's rescale factors in alpha.  A masked score never enters the
// max and weighs 0.  A row that has seen no real key keeps m = -1e30 and
// gathers nothing; the TPU kernel's finite -1e30 gathers weights there that
// the first real key multiplies by alpha = 0, so the output is the same.
__device__ __forceinline__ void online_softmax(float (&s)[kBK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const Params& p, int k0,
                                               int row0, int col0, int qmin) {
  const bool edge = k0 + kBK > p.s || (p.causal && k0 + kBK - 1 > qmin) ||
                    (p.window > 0 && k0 <= qmin + 63 - p.window);
  if (edge) {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const int qi = row0 + 8 * ((e / 2) % 2);
      const int kj = k0 + 8 * (e / 4) + col0 + e % 2;
      bool ok = kj < p.s;
      if (p.causal) ok = ok && kj <= qi;
      if (p.window > 0) ok = ok && kj > qi - p.window;
      if (!ok) s[e] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // row r's scores: s[4 j + 2 r + c], j < kBK / 8, c < 2
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // scaling by a positive number keeps the max: scale once
    const float m_new = fmaxf(m[r], mx * p.scale_log2);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * r + c];
        x = exp2_approx(fmaf(x, p.scale_log2, -m_new));
        rs += x;
      }
    }
    l[r] = l[r] * alpha[r] + rs;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to, const Params p) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;    // swizzle atoms: 1 KiB aligned
  const uint32_t sk = sq + T::kBytes;              // stage st at + st * kBytes
  const uint32_t sv = sk + kStages * T::kBytes;
  const uint32_t so = sv + kStages * T::kBytes;    // the output, staged
  const uint32_t full_q = so + T::kBytes;          // 8-byte mbarriers
  const uint32_t empty_q = full_q + 8;
  const uint32_t full_k = empty_q + 8;                 // [kStages]
  const uint32_t full_v = full_k + 8 * kStages;        // [kStages]
  const uint32_t empty = full_v + 8 * kStages;         // [kStages]
  // the item whose Q full_q announces
  volatile int* slot = reinterpret_cast<volatile int*>(
      smem_raw + (empty + 8 * kStages - raw));

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 2);   // one arrival per consumer warpgroup
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the loader: one thread takes the items and issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int item = blockIdx.x;
      int n = 0;   // kv tiles loaded so far, over all items
      for (int k = 0;; ++k) {
        if (k > 0) mbar_wait(empty_q, (k - 1) & 1);   // Q is free
        *slot = item;
        if (item >= p.n_items) {
          mbar_arrive(full_q);   // no more work
          // every CTA has taken its last item once all have counted
          // themselves done: the last one zeroes the counters for the next
          // launch on the stream
          __threadfence();
          if (atomicAdd(p.next + 1, 1) == static_cast<int>(gridDim.x) - 1) {
            atomicExch(p.next, 0);
            atomicExch(p.next + 1, 0);
          }
          break;
        }
        const Work w = work_item(p, item);
        const int hk = w.h / (p.hq / p.hkv);
        mbar_expect_tx(full_q, T::kBytes);
        for (int cb = 0; cb < T::kBlocks; ++cb) {
          tma_load_4d(sq + cb * T::kBlockBytes, &tq, full_q, cb * T::kBoxCols,
                      w.q0, w.h, w.b);
        }
        for (int i = 0; i < w.n_tiles; ++i, ++n) {
          const int st = n % kStages;
          if (n >= kStages) mbar_wait(empty + 8 * st, (n / kStages - 1) & 1);
          const int k0 = (w.t_lo + i) * kBK;
          const uint32_t kdst = sk + st * T::kBytes;
          const uint32_t vdst = sv + st * T::kBytes;
          mbar_expect_tx(full_k + 8 * st, T::kBytes);
          for (int cb = 0; cb < T::kBlocks; ++cb) {
            tma_load_4d(kdst + cb * T::kBlockBytes, &tk, full_k + 8 * st,
                        cb * T::kBoxCols, k0, hk, w.b);
          }
          mbar_expect_tx(full_v + 8 * st, T::kBytes);
          for (int cb = 0; cb < T::kBlocks; ++cb) {
            tma_load_4d(vdst + cb * T::kBlockBytes, &tv, full_v + 8 * st,
                        cb * T::kBoxCols, k0, hk, w.b);
          }
        }
        item = gridDim.x + atomicAdd(p.next, 1);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_wg = sq + wg * 64 * T::kRowBytes;
    const int other = 1 - wg;
    float o[D / 2];
    float m[2], l[2];          // running max; this thread's part of the sums
    float s[kBK / 2];          // scores, then probabilities, of one tile
    uint32_t pa[kBK / 16][4];  // P, bf16, as wgmma A fragments
    float alpha[2];

    // The two warpgroups take turns issuing their products (named barriers
    // 1 and 2, "ping-pong"): one's softmax runs while the other's S or P V
    // keeps the tensor cores busy.  Warpgroup 0 goes first.
    if (wg == 1) named_arrive(1);
    int n = 0;   // kv tiles consumed so far, over all items
    for (int k = 0;; ++k) {
      mbar_wait(full_q, k & 1);
      const int item = *slot;
      if (item >= p.n_items) break;
      const Work w = work_item(p, item);
      const int qmin = w.q0 + wg * 64;            // this warpgroup's rows
      const int row0 = qmin + (t / 32) * 16 + lane / 4;   // and row0 + 8
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      for (int i = 0; i < w.n_tiles; ++i, ++n) {
        const int st = n % kStages;
        const uint32_t ph = (n / kStages) & 1;
        mbar_wait(full_k + 8 * st, ph);
        named_sync(1 + wg);
        wgmma_fence();
        scores<D>(s, q_wg, sk + st * T::kBytes);
        wgmma_commit();
        named_arrive(1 + other);
        wgmma_wait<0>();
        // the item's last S has read Q: the loader may bring the next one
        if (i + 1 == w.n_tiles && t == 0) mbar_arrive(empty_q);
        online_softmax(s, m, l, alpha, p, (w.t_lo + i) * kBK, row0, col0,
                       qmin);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e / 2) % 2];
        to_bf16(pa, s);
        mbar_wait(full_v + 8 * st, ph);
        named_sync(1 + wg);
        wgmma_fence();
        values<D>(o, pa, sv + st * T::kBytes);
        wgmma_commit();
        named_arrive(1 + other);
        wgmma_wait<0>();
        if (t == 0) mbar_arrive(empty + 8 * st);
      }

      // Epilogue: the rows, scaled and rounded once, go to the staging tile
      // in TMA's swizzled layout, and one thread stores the warpgroup's 64
      // rows with TMA (which drops rows past S).  The staging rows must
      // first be free of the previous item's store.
      if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(wg);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float den = l[r];
        den += __shfl_xor_sync(0xffffffffu, den, 1);
        den += __shfl_xor_sync(0xffffffffu, den, 2);
        // one division a row: o * (1 / den) is within an ulp of o / den,
        // far below the bf16 rounding that follows
        const float inv = 1.f / fmaxf(den, 1e-30f);
        const int row = row0 - w.q0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           so + tile_offset<D>(row + 8 * r, 8 * j + col0)),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(wg);
      if (t == 0) {
        for (int cb = 0; cb < T::kBlocks; ++cb) {
          tma_store_4d(&to, so + cb * T::kBlockBytes + wg * 64 * T::kRowBytes,
                       cb * T::kBoxCols, qmin, w.h, w.b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    // the last stores must finish reading shared memory before the CTA ends
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    // warpgroup 1's last hand-back has no turn after it: take it
    if (wg == 0) named_sync(1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// a map over (D, S, H, B) with these element strides; boxes of `rows` rows
// by min(D, 64) columns, swizzled over the box's row bytes; loads read zeros
// past S and stores drop rows past S
int encode(CUtensorMap* map, const void* ptr, int d, int s, int h, int b,
           long long ss, long long sh, long long sb, int rows = kBK) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int box_cols = d < 64 ? d : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0
                           : flash_host::kEncodeError + static_cast<int>(r);
}

// the dynamic shared-memory limit, raised once per instantiation and device
template <int D>
cudaError_t allow_smem() {
  static std::atomic<bool> done[flash_host::kMaxDevices];
  return flash_host::allow_smem(
      reinterpret_cast<const void*>(&flash_bf16_kernel<D>), smem_bytes<D>(),
      done);
}

// The work counters (Params::next) of one stream on one device.  Launches
// on a stream run one after another and each one's last CTA zeroes its
// counters, so a stream's pair is allocated and zeroed once and reused by
// every launch on it; launches on other streams, which may overlap, get
// their own pair.  The pairs (8 bytes a stream) live as long as the library.
cudaError_t stream_counters(int dev, cudaStream_t stream, int** out) {
  static std::mutex mu;
  static std::map<std::pair<int, cudaStream_t>, int*> pairs;
  std::lock_guard<std::mutex> lock(mu);
  int*& c = pairs[{dev, stream}];
  if (c == nullptr) {
    int* fresh = nullptr;
    cudaError_t err = cudaMalloc(reinterpret_cast<void**>(&fresh),
                                 2 * sizeof(int));
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(fresh, 0, 2 * sizeof(int), stream);
    if (err != cudaSuccess) {
      cudaFree(fresh);
      return err;
    }
    c = fresh;
  }
  *out = c;
  return cudaSuccess;
}

template <int D>
int launch(const CUtensorMap* maps, Params p, cudaStream_t stream) {
  cudaError_t err = allow_smem<D>();
  int dev = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) err = stream_counters(dev, stream, &p.next);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one CTA an SM (its registers and shared memory allow no
  // more), each taking items until none is left
  const dim3 grid(p.n_items < n_sm ? p.n_items : n_sm);
  flash_bf16_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

bool tma_ready(const void* ptr, long long sb, long long sh, long long ss) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb > 0 && sh > 0 &&
         ss > 0 && sb % 8 == 0 && sh % 8 == 0 && ss % 8 == 0;
}

template <int D>
int occupancy(int* out) {
  const cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return flash_host::occupancy(
      reinterpret_cast<const void*>(&flash_bf16_kernel<D>), kThreads,
      smem_bytes<D>(), out);
}

}  // namespace

// q, k, v, o: device pointers to bfloat16 tensors, each addressed as
// base + b*s_b + h*s_h + s*s_s + d (strides in elements; D contiguous).
// q, k and v are read by TMA: their bases must be 16-byte aligned and their
// strides positive multiples of 8 elements.  q and o have hq heads, k and v
// hkv, hq % hkv == 0; d in {16, 32, 64, 128}; window <= 0 means no sliding
// window.  Launches on `stream`; returns 0, a cudaError_t, or 1000 + the
// CUresult of a failed tensor-map encoding.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int s, int d, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 ||
      static_cast<long long>(batch) * hq * ((s + kBQ - 1) / kBQ) > INT_MAX ||
      !tma_ready(q, q_sb, q_sh, q_ss) || !tma_ready(k, k_sb, k_sh, k_ss) ||
      !tma_ready(v, v_sb, v_sh, v_ss) || !tma_ready(o, o_sb, o_sh, o_ss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[4];
  int err = encode(&maps[0], q, d, s, hq, batch, q_ss, q_sh, q_sb);
  if (err == 0) err = encode(&maps[1], k, d, s, hkv, batch, k_ss, k_sh, k_sb);
  if (err == 0) err = encode(&maps[2], v, d, s, hkv, batch, v_ss, v_sh, v_sb);
  // each warpgroup stores its 64 rows
  if (err == 0) err = encode(&maps[3], o, d, s, hq, batch, o_ss, o_sh, o_sb, 64);
  if (err != 0) return err;
  const int n_items = batch * hq * ((s + kBQ - 1) / kBQ);
  Params p{hq, hkv, s, causal, window, head_group(batch * hq, s, d, 2),
           n_items, nullptr, 0.f};
  // log2(e)/sqrt(D) in double, rounded once
  p.scale_log2 = static_cast<float>(1.4426950408889634 /
                                    std::sqrt(static_cast<double>(d)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(maps, p, st);
    case 32: return launch<32>(maps, p, st);
    case 64: return launch<64>(maps, p, st);
    case 128: return launch<128>(maps, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the kernel for head dim d as the runtime sees it: out[0..2] = threads a
// CTA, dynamic shared memory a CTA (bytes), CTAs an SM at once.  Returns 0
// or a cudaError_t.
extern "C" int flash_attention_occupancy(int d, int* out) {
  switch (d) {
    case 16: return occupancy<16>(out);
    case 32: return occupancy<32>(out);
    case 64: return occupancy<64>(out);
    case 128: return occupancy<128>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
