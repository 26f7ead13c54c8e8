// Mamba-2 SSD chunk scan, backward: the gradients of ssd_scan.cu's function.
//
// No TPU kernel: the reference takes this gradient with jax.grad of its
// plain chunked scan (src/repro/models/mamba2.py:_ssd_chunked); this is the
// gradient of the function that src/repro/kernels/ssd_scan.py:27 computes.
// For each (batch b, head h), group g = h / (H / G), A = -exp(a_log[h]),
// chunks of L = 32 rows (the gradient is of the function, so the chunk is
// this kernel's own choice), and in a chunk
//
//   a_t = dt_t A, seg = the inclusive cumsum of a, u_j = dt_j x_j,
//   E_ij = exp(seg_i - seg_j) for j <= i (0 above the diagonal),
//   h_{c-1} the state entering chunk c, dh_c the cotangent of the state
//   leaving it (dstate, or 0, after the last chunk):
//
//   dh_{c-1} = exp(seg_last) dh_c + sum_i exp(seg_i) dy_i (x) C_i
//   du_j = sum_{i>=j} (C_i.B_j) E_ij dy_i + exp(seg_last - seg_j) dh_c B_j
//   dx_j = dt_j du_j,  ddt_j = x_j . du_j + A d a_j
//   dC_i = sum_{j<=i} E_ij (dy_i.u_j) B_j + exp(seg_i) h_{c-1}^T dy_i
//   dB_j = sum_{i>=j} E_ij (dy_i.u_j) C_i + exp(seg_last - seg_j) dh_c^T u_j
//   d seg: every exponent's cotangent; d a its reverse cumsum in the chunk;
//   da_log = A sum_{b,t} dt_t d a_t; dB, dC summed over the group's heads.
//
// Inputs x, B, C and dy float32 or bfloat16 (one type; dt, a_log and dstate
// float32); every sum in float32, as the reference's _ssd_chunked upcasts;
// dx, dB and dC in the input type, ddt and da_log float32.
//
// Bound on an H100 (launch/ssd_bwd_timing.py:bound).  An exact backward
// takes, a (token, head), five products the size of the state at 2 P N
// operations each: the state entering the chunk again, its cotangent, and
// the inter-chunk terms of dC, du and dB; a chunk of L rows adds 4 P N / L
// and (L + 1)(2 P + 3 N) for its causal pairs.  At P = 64, N = 128 the
// least is at L = 8: 11.0625 P N = 90,624 FLOP a (token, head), bound by
// operations at the 67 TFLOP/s float32 rate (bytes: x, dy, dx, B, C, dB,
// dC at 4 or 2 bytes).  This design does 1.17 times that count
// (ssd_scan.py:bwd_fmas): per (32-row chunk, head) C B^T and dy x^T as
// whole 32 x 32 products, du, dC and dB's causal parts over their triangle
// in 4-row steps, and the five state-sized products.
//
// Design, three kernels a call on the caller's stream, no atomics: every
// sum runs in one fixed order and two calls give the same bits.
//  1. ssd_bwd_states_kernel, one CTA per (batch, head, slice of min(P, 64)
//     head-dim columns): the states entering each chunk, forward over the
//     chunks, then the cotangents leaving each chunk, backward; both into
//     float32 scratch (B, H, nc, P, N).  A thread keeps a 4 x 8 tile of the
//     state in registers (three 16-byte shared loads a row feed 32 FMAs);
//     the next chunk's rows are in flight (cp.async for float32, registers
//     for bfloat16) while the current one updates the state.
//  2. ssd_bwd_chunk_kernel, one CTA per (batch, chunk, head), the heads of
//     a group in clusters of `cs` CTAs (the largest of 8, 4, 2, 1 dividing
//     H / G).  It stages x, dy, B, C, dt and dh_c in float32 shared memory
//     (rows padded to a multiple of 4 floats plus 4, so 16-byte loads stay
//     aligned), and h_{c-1} through a three-stage ring of 8 rows
//     (cp.async), at 112,544 bytes at P = 64, N = 128: two CTAs an SM.  Every product
//     is a register tile (2 x 2, 2 x 4 or 4 x 4) fed 4 k at a time by
//     16-byte loads (mma below), whichever way its operands lie.  Each
//     head's dC and dB end in its own shared memory; the cluster then sums
//     them over its heads through distributed shared memory (rank r takes
//     rows r L / cs.., summing ranks 0..cs-1 in order) into float32 partial
//     sums (B, S, H / cs, N).
//  3. ssd_bwd_reduce_kernel: dB and dC over each group's partial sums, and
//     da_log over batch and chunks, each in a fixed order.
// A last chunk shorter than 32 rows is zero-filled with dt = 0, as in the
// forward, and its padded rows are not stored.  x, dy, dt, B and C are read
// through their strides (x, dy, B and C with the last dim contiguous and
// base and strides multiples of 16 bytes); the outputs and scratch are
// contiguous.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kL = 32;        // rows a chunk holds: one a lane
constexpr int kLd = kL + 4;   // row of an L x L matrix in shared memory
constexpr int kPSlice = 64;   // head-dim columns of a states CTA, at most
constexpr int kRing = 8;      // rows of h_{c-1} a ring stage holds
constexpr int kStages = 3;    // ring stages in flight
constexpr int kMaxN = 128;
constexpr int kRed = 32;      // partial sums a row, at most (N / 4)
constexpr int kMaxCluster = 8;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kThreads >= (kPSlice / 4) * (kMaxN / 8), "a state tile a thread");
static_assert(kThreads >= (kL / 4) * (kMaxN / 4), "a 4 x 4 dC tile a thread");

struct Params {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const void* dy;
  const float* dstate;   // (B, H, P, N) or null (zero)
  void* dx;              // (B, S, H, P)
  float* ddt;            // (B, S, H)
  float* da_log;         // (H,)
  void* db;              // (B, S, G, N)
  void* dc;              // (B, S, G, N)
  float* hs;             // (B, H, nc, P, N) scratch: state entering chunk c
  float* dhs;            // (B, H, nc, P, N) scratch: cotangent leaving it
  float* dbp;            // (B, S, H / cs, N) scratch: dB over a cluster
  float* dcp;            // (B, S, H / cs, N) scratch: dC over a cluster
  float* part;           // (B, nc, H) scratch: A sum_t dt_t d a_t a chunk
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dy_sb, dy_ss, dy_sh;
  int batch, h, g, s, p, n, nc;
  int ps, nps;   // slice width of a states CTA, slices a head
  int cs;        // CTAs (heads) of a cluster
};

// floats of each kernel's dynamic shared memory
__host__ __device__ inline int states_stage_floats(int ps, int n) {
  return kL * (ps + n) + kL;
}
__host__ __device__ inline int states_smem_floats(int ps, int n) {
  return 2 * states_stage_floats(ps, n) + kL + 4;
}
// partial sums a row of red1: G's column sums (kL / 2) and x . du (P / 4)
__host__ __device__ inline int red1_width(int p) {
  return p / 4 > kL / 2 ? p / 4 : kL / 2;
}
__host__ __device__ inline int chunk_smem_floats(int p, int n) {
  const int ldp = p + 4, ldn = n + 4;
  return 2 * kL * ldp + 2 * kL * ldn + p * n + kStages * kRing * n
       + 2 * kL * kLd + kL * kRed + kL * red1_width(p) + 7 * kL
       + kThreads / 32;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// dh_c is kept with the float4 at column k of row r at column k ^ swz(r):
// the rows a warp reads at one k in du's product (4 apart) then fall on
// distinct banks.  `mask` (N / 4 - 1, at most 7) keeps it inside the row.
__device__ __forceinline__ int swz(int row, int mask) {
  return ((row >> 2) & mask) << 2;
}
// the 128-byte line at p into L2, ahead of its cp.async
__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
#endif
}
__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// TM contiguous floats at p (16- or 8-byte aligned) into v[0..TM-1]
template <int TM>
__device__ __forceinline__ void load_run(const float* p, float (&v)[TM]);
template <>
__device__ __forceinline__ void load_run<4>(const float* p, float (&v)[4]) {
  const float4 t = load4(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
template <>
__device__ __forceinline__ void load_run<2>(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
}

// acc[r][c] += sum_{k0 <= k < k1} A(m0 + r, k) B(k, n0 + c), k in order.
// A(m, k) is a[m * lda + k], or a[k * lda + m] when AT; B(k, n) is
// b[k * ldb + n], or b[n * ldb + k] when BT, its stored row (k, or n when
// BT; counted from brow) swizzled by swz(row, bmask).  Four k a step, every
// operand read 16 (or 8) bytes at a time along whichever of its dims is
// contiguous: k0, k1, lda and ldb multiples of 4, m0 of TM and n0 of TN.
template <int TM, int TN, bool AT, bool BT>
__device__ __forceinline__ void mma(float (&acc)[TM][TN], const float* a,
                                    int lda, const float* b, int ldb, int m0,
                                    int n0, int k0, int k1, int bmask = 0,
                                    int brow = 0) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float av[TM][4], bv[4][TN];
    if (AT) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float v[TM];
        load_run<TM>(a + (k + kk) * lda + m0, v);
#pragma unroll
        for (int r = 0; r < TM; ++r) av[r][kk] = v[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        float v[4];
        load_run<4>(a + (m0 + r) * lda + k, v);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) av[r][kk] = v[kk];
      }
    }
    if (BT) {
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int row = n0 + c;
        float v[4];
        load_run<4>(b + row * ldb + (k ^ swz(brow + row, bmask)), v);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) bv[kk][c] = v[kk];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int row = k + kk;
        load_run<TN>(b + row * ldb + (n0 ^ swz(brow + row, bmask)), bv[kk]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          acc[r][c] = fmaf(av[r][kk], bv[kk][c], acc[r][c]);
        }
      }
    }
  }
}

// Tile t of an rg x cg grid of register tiles: its row and column.  Where
// cg >= 8 a warp's 32 tiles are 4 rows by 8 columns (rg a multiple of 4),
// so that its loads of A broadcast and its loads of B are one wavefront.
__device__ __forceinline__ void tile_at(int t, int rg, int cg, int& tr,
                                        int& tc) {
  if (cg >= 8) {
    const int w = t >> 5, l = t & 31, wc = cg >> 3;
    tr = (w / wc) * 4 + (l >> 3);
    tc = (w % wc) * 8 + (l & 7);
  } else {
    tr = t / cg;
    tc = t - (t / cg) * cg;
  }
}

// the sum of v over the warp, one fixed order, given to every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return __shfl_sync(kAll, v, 0);
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !in
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool in) {
  __pipeline_memcpy_async(dst, src, 16, in ? 0 : 16);
}
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  __pipeline_memcpy_async(dst, src, 4, in ? 0 : 4);
}

// Rows s0 .. s0 + kL - 1 of a [S][width] view of T (row stride `rs`
// elements) into float32 `dst` [kL][ld], zeros past S.  issue() starts the
// copy; land() finishes it.  Float32 goes by cp.async (land() does nothing;
// the caller commits and waits); bfloat16 is loaded 16 bytes at a time into
// registers by issue() and converted and stored by land().
template <class T>
struct Rows;

template <>
struct Rows<float> {
  __device__ __forceinline__ void issue(const float* src, long long rs,
                                        int width, int s0, int s, float* dst,
                                        int ld) {
    const int per_row = width >> 2, pieces = kL * per_row;
    for (int e = threadIdx.x; e < pieces; e += kThreads) {
      const int j = e / per_row, k = (e - j * per_row) << 2;
      const bool in = s0 + j < s;
      copy16(dst + j * ld + k, src + (in ? (s0 + j) * rs + k : 0), in);
    }
  }
  __device__ __forceinline__ void land() {}
};

template <>
struct Rows<__nv_bfloat16> {
  static constexpr int kMax = kL * kMaxN / 8 / kThreads;
  uint4 v[kMax];
  float* dst;
  int ld, per_row, pieces;

  __device__ __forceinline__ void issue(const __nv_bfloat16* src,
                                        long long rs, int width, int s0,
                                        int s, float* to, int ld_) {
    dst = to;
    ld = ld_;
    per_row = width >> 3;
    pieces = kL * per_row;
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int j = e / per_row, k = (e - j * per_row) << 3;
      v[i] = e < pieces && s0 + j < s
          ? *reinterpret_cast<const uint4*>(src + (s0 + j) * rs + k)
          : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void land() {
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < pieces) {
        const int j = e / per_row, k = (e - j * per_row) << 3;
        float* d = dst + j * ld + k;
        store4(d, make_float4(lo_bf16(v[i].x), hi_bf16(v[i].x),
                              lo_bf16(v[i].y), hi_bf16(v[i].y)));
        store4(d + 4, make_float4(lo_bf16(v[i].z), hi_bf16(v[i].z),
                                  lo_bf16(v[i].w), hi_bf16(v[i].w)));
      }
    }
  }
};

// dt of chunk rows s0.. into dst[kL] (cp.async, zeros past S)
__device__ __forceinline__ void issue_dt(const float* dtg, long long dt_ss,
                                         int s0, int s, float* dst) {
  const int j = threadIdx.x;
  if (j < kL) {
    const bool in = s0 + j < s;
    copy4(dst + j, dtg + (in ? (s0 + j) * dt_ss : 0), in);
  }
}

// The states entering each chunk (forward) and the cotangents leaving each
// chunk (backward), of one (batch, head, column slice).  A thread keeps the
// state at rows 4 tp .. 4 tp + 3 of the slice and columns 4 tn .. 4 tn + 3
// and N / 2 + 4 tn .. N / 2 + 4 tn + 3 (tn < N / 8).
template <class T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(const Params q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = q.n, ps = q.ps, P = q.p, half = q.n / 2;
  const int stage = states_stage_floats(ps, N);
  float* wv = smem + 2 * stage;   // [kL] weight of each row; [kL] the decay

  const int tid = threadIdx.x;
  const int slice = blockIdx.x % q.nps;
  const int bh = blockIdx.x / q.nps;
  const int b = bh / q.h, h = bh % q.h;
  const int g = h / (q.h / q.g);
  const int p0 = slice * ps;
  const float a = -expf(q.a_log[h]);
  const T* xg = static_cast<const T*>(q.x) + b * q.x_sb + h * q.x_sh + p0;
  const T* dyg = static_cast<const T*>(q.dy) + b * q.dy_sb + h * q.dy_sh + p0;
  const T* bg = static_cast<const T*>(q.b) + b * q.b_sb + g * q.b_sg;
  const T* cg_ = static_cast<const T*>(q.c) + b * q.c_sb + g * q.c_sg;
  const float* dtg = q.dt + b * q.dt_sb + h * q.dt_sh;

  const int ntn = N >> 3, tn = tid % ntn, tp = tid / ntn;
  const bool mine = tp < (ps >> 2);
  const long long chunk_floats = static_cast<long long>(P) * N;
  // row 4 tp of this thread's slice in chunk 0's state
  const long long base = static_cast<long long>(b * q.h + h) * q.nc
                       * chunk_floats + static_cast<long long>(p0 + 4 * tp) * N;
  float st[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) st[i][c] = 0.f;
  }
  Rows<T> rows_in, cols_in;

  // chunk c's rows of `rg` (ps wide), of `colg` (N wide) and dt into
  // stage buffer `buf`
  auto issue = [&](const T* rg, long long rs, const T* colg, long long cs,
                   int c, int buf) {
    float* at = smem + buf * stage;
    const int s0 = c * kL;
    rows_in.issue(rg, rs, ps, s0, q.s, at, ps);
    cols_in.issue(colg, cs, N, s0, q.s, at + kL * ps, N);
    issue_dt(dtg, q.dt_ss, s0, q.s, at + kL * (ps + N));
    __pipeline_commit();
  };
  auto land = [&]() {
    rows_in.land();
    cols_in.land();
  };
  // st = decay st + sum_j wv_j rows_j (x) cols_j over stage buffer `buf`
  auto update = [&](int buf) {
    const float decay = wv[kL];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) st[i][c] *= decay;
    }
    if (!mine) return;
    const float* rows = smem + buf * stage;
    const float* cols = rows + kL * ps;
#pragma unroll 4
    for (int j = 0; j < kL; ++j) {
      const float w = wv[j];
      const float4 xv = load4(rows + j * ps + 4 * tp);
      const float4 c0 = load4(cols + j * N + 4 * tn);
      const float4 c1 = load4(cols + j * N + half + 4 * tn);
      const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) st[i][c] = fmaf(xw[i], cv[c], st[i][c]);
      }
    }
  };
  auto store = [&](float* scratch, int c) {
    if (!mine) return;
    float* out = scratch + base + c * chunk_floats;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      store4(out + i * N + 4 * tn,
             make_float4(st[i][0], st[i][1], st[i][2], st[i][3]));
      store4(out + i * N + half + 4 * tn,
             make_float4(st[i][4], st[i][5], st[i][6], st[i][7]));
    }
  };
  // seg of stage buffer `buf`'s dt by warp 0 (lane = row); wv the rows'
  // weights (forward: exp(seg_last - seg_j) dt_j; backward: exp(seg_i)),
  // wv[kL] exp(seg_last)
  auto weights = [&](int buf, bool forward) {
    if (tid >= 32) return;
    const float d = (smem + buf * stage)[kL * (ps + N) + tid];
    float sg = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kAll, sg, off);
      if (tid >= off) sg += v;
    }
    const float last = __shfl_sync(kAll, sg, kL - 1);
    wv[tid] = forward ? expf(last - sg) * d : expf(sg);
    if (tid == 0) wv[kL] = expf(last);
  };

  // forward: the state entering chunk c, then chunk c's update
  issue(xg, q.x_ss, bg, q.b_ss, 0, 0);
  land();
  for (int c = 0; c < q.nc; ++c) {
    const int buf = c & 1;
    __pipeline_wait_prior(0);
    __syncthreads();   // chunk c staged; the other buffer free
    if (c + 1 < q.nc) issue(xg, q.x_ss, bg, q.b_ss, c + 1, buf ^ 1);
    weights(buf, true);
    __syncthreads();
    store(q.hs, c);
    update(buf);
    if (c + 1 < q.nc) land();
  }
  __syncthreads();   // every thread done with the buffers and wv

  if (mine && q.dstate != nullptr) {
    const float* d = q.dstate + (static_cast<long long>(b * q.h + h) * P
                                 + p0 + 4 * tp) * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 d0 = load4(d + i * N + 4 * tn);
      const float4 d1 = load4(d + i * N + half + 4 * tn);
      const float v[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) st[i][c] = v[c];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) st[i][c] = 0.f;
    }
  }
  // backward: the cotangent leaving chunk c, then chunk c's share of the
  // one leaving chunk c - 1
  issue(dyg, q.dy_ss, cg_, q.c_ss, q.nc - 1, 0);
  land();
  for (int k = 0; k < q.nc; ++k) {
    const int c = q.nc - 1 - k, buf = k & 1;
    __pipeline_wait_prior(0);
    __syncthreads();
    if (c > 0) issue(dyg, q.dy_ss, cg_, q.c_ss, c - 1, buf ^ 1);
    weights(buf, false);
    __syncthreads();
    store(q.dhs, c);
    update(buf);
    if (c > 0) land();
  }
}

// Every gradient of one (batch, chunk, head), then dC and dB summed over
// the cluster's heads.
template <class T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_kernel(const Params q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = q.p, N = q.n, ldp = P + 4, ldn = N + 4;
  float* xs = smem;                  // [kL][ldp]
  float* dys = xs + kL * ldp;        // [kL][ldp]
  float* bs = dys + kL * ldp;        // [kL][ldn]  B, at the end this dC
  float* cs = bs + kL * ldn;         // [kL][ldn]  C, at the end this dB
  float* dhm = cs + kL * ldn;        // [P][N]     dh_c, swizzled (swz)
  float* ring = dhm + P * N;         // [kStages][kRing][N]  rows of h_{c-1}
  float* km = ring + kStages * kRing * N;   // [kL][kLd]  K = (C B^T) E
  float* wm = km + kL * kLd;         // [kL][kLd]  W = E (dy . u)
  const int rw1 = red1_width(P);
  float* red0 = wm + kL * kLd;       // [kL][kRed] partial row sums
  float* red1 = red0 + kL * kRed;    // [kL][rw1]
  float* dtv = red1 + kL * rw1;      // [kL]
  float* seg = dtv + kL;             // [kL]
  float* es = seg + kL;              // [kL]  exp(seg_i)
  float* tail = es + kL;             // [kL]  exp(seg_last - seg_j)
  float* dseg = tail + kL;           // [kL]
  float* sj = dseg + kL;             // [kL]  dt_j x_j . (tail_j dh_c B_j)
  float* ddir = sj + kL;             // [kL]  x_j . du_j
  float* wsum = ddir + kL;           // [kThreads / 32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % q.h;
  const int bc = blockIdx.x / q.h;
  const int chunk = bc % q.nc, b = bc / q.nc;
  const int g = h / (q.h / q.g);
  const int s0 = chunk * kL, S = q.s;
  const float a = -expf(q.a_log[h]);
  const long long state_off =
      (static_cast<long long>(b * q.h + h) * q.nc + chunk) * P * N;
  const float* hprev = q.hs + state_off;   // [P][N]
  const float* dh = q.dhs + state_off;     // [P][N]
  const int stages = P / kRing;
  const int mask = (N >> 2) - 1 < 7 ? (N >> 2) - 1 : 7;
  for (int e = tid * 32; e < P * N; e += kThreads * 32) prefetch_l2(hprev + e);

  // x, dy, B, C, dt and dh_c (one group), then two stages of h_{c-1}
  {
    Rows<T> in;
    in.issue(static_cast<const T*>(q.x) + b * q.x_sb + h * q.x_sh, q.x_ss, P,
             s0, S, xs, ldp);
    in.land();
    in.issue(static_cast<const T*>(q.dy) + b * q.dy_sb + h * q.dy_sh,
             q.dy_ss, P, s0, S, dys, ldp);
    in.land();
    in.issue(static_cast<const T*>(q.b) + b * q.b_sb + g * q.b_sg, q.b_ss, N,
             s0, S, bs, ldn);
    in.land();
    in.issue(static_cast<const T*>(q.c) + b * q.c_sb + g * q.c_sg, q.c_ss, N,
             s0, S, cs, ldn);
    in.land();
  }
  issue_dt(q.dt + b * q.dt_sb + h * q.dt_sh, q.dt_ss, s0, S, dtv);
  {
    const int per_row = N >> 2;
    for (int e = tid; e < P * per_row; e += kThreads) {
      const int r = e / per_row, k = (e - r * per_row) << 2;
      copy16(dhm + r * N + (k ^ swz(r, mask)), dh + r * N + k, true);
    }
  }
  __pipeline_commit();
  // stage st of h_{c-1} (rows st kRing ..) into ring buffer st % kStages;
  // one commit a call, empty past the last stage
  auto issue_ring = [&](int st) {
    if (st < stages) {
      float* to = ring + (st % kStages) * kRing * N;
      const float* from = hprev + st * kRing * N;
      for (int e = tid * 4; e < kRing * N; e += kThreads * 4) {
        copy16(to + e, from + e, true);
      }
    }
    __pipeline_commit();
  };
  for (int st = 0; st < kStages; ++st) issue_ring(st);
  __pipeline_wait_prior(kStages);
  __syncthreads();

  if (warp == 0) {   // seg, by lane = row
    const float d = dtv[lane];
    float sg = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kAll, sg, off);
      if (lane >= off) sg += v;
    }
    const float last = __shfl_sync(kAll, sg, kL - 1);
    seg[lane] = sg;
    es[lane] = expf(sg);
    tail[lane] = expf(last - sg);
  }
  __syncthreads();

  // C B^T and dy x^T as 2 x 2 tiles: K, W and G = (C B^T) W, zero above the
  // diagonal (exp sees only seg_i - seg_j <= 0 there); G's row and column
  // sums into d seg
  {
    int tr, tc;
    tile_at(tid, kL / 2, kL / 2, tr, tc);
    const int i0 = 2 * tr, j0 = 2 * tc;
    float cb[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float yx[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if (j0 <= i0 + 1) {
      mma<2, 2, false, true>(cb, cs, ldn, bs, ldn, i0, j0, 0, N);
      mma<2, 2, false, true>(yx, dys, ldp, xs, ldp, i0, j0, 0, P);
    }
    float rows[2] = {0.f, 0.f}, cols[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + r, j = j0 + c;
        float k_ = 0.f, w_ = 0.f;
        if (j <= i) {
          const float e = expf(seg[i] - seg[j]);
          w_ = e * dtv[j] * yx[r][c];
          k_ = cb[r][c] * e;
          const float g_ = cb[r][c] * w_;
          rows[r] += g_;
          cols[c] += g_;
        }
        km[i * kLd + j] = k_;
        wm[i * kLd + j] = w_;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) red0[(i0 + r) * kRed + tc] = rows[r];
#pragma unroll
    for (int c = 0; c < 2; ++c) red1[(j0 + c) * rw1 + tr] = cols[c];
  }
  __syncthreads();
  if (tid < kL) {
    float rs = 0.f, cl = 0.f;
    for (int t = 0; t < kL / 2; ++t) {
      rs += red0[tid * kRed + t];
      cl += red1[tid * rw1 + t];
    }
    dseg[tid] = rs - cl;
  }
  __syncthreads();

  // du as 2 x 4 tiles: its state term tail_j dh_c B_j (s_j from it), then
  // K^T dy over i >= j; dx = dt du, and dt's direct share x . du
  {
    const int cgp = P >> 2, tiles = (kL / 2) * cgp;
    T* dxg = static_cast<T*>(q.dx)
        + (static_cast<long long>(b) * S * q.h + h) * P;
    for (int t = tid; t < tiles; t += kThreads) {
      int tr, tc;
      tile_at(t, kL / 2, cgp, tr, tc);
      const int j0 = 2 * tr, p0 = 4 * tc;
      float du[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      mma<2, 4, false, true>(du, bs, ldn, dhm, N, j0, p0, 0, N, mask);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float t_ = tail[j0 + r];
        const float4 xv = load4(xs + (j0 + r) * ldp + p0);
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) du[r][c] *= t_;
        part = xv.x * du[r][0] + xv.y * du[r][1] + xv.z * du[r][2]
             + xv.w * du[r][3];
        red0[(j0 + r) * kRed + tc] = part;
      }
      mma<2, 4, true, false>(du, km, kLd, dys, ldp, j0, p0, j0 & ~3, kL);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + r;
        const float d = dtv[j];
        const float4 xv = load4(xs + j * ldp + p0);
        red1[j * rw1 + tc] = xv.x * du[r][0] + xv.y * du[r][1]
                            + xv.z * du[r][2] + xv.w * du[r][3];
        if (s0 + j < S) {
          store4(dxg + static_cast<long long>(s0 + j) * q.h * P + p0,
                 make_float4(d * du[r][0], d * du[r][1], d * du[r][2],
                             d * du[r][3]));
        }
      }
    }
  }
  __syncthreads();
  if (tid < kL) {
    float su = 0.f, xd = 0.f;
    for (int t = 0; t < (P >> 2); ++t) {
      su += red0[tid * kRed + t];
      xd += red1[tid * rw1 + t];
    }
    sj[tid] = dtv[tid] * su;
    ddir[tid] = xd;
  }

  // dC and dB as 4 x 4 tiles, one a thread: the state terms over h_{c-1}'s
  // ring and dh_c, K = P in steps of kRing rows; <dh_c, h_{c-1}> beside
  const int ctiles = (kL / 4) * (N >> 2);
  const bool has = tid < ctiles;
  int tr = 0, tc = 0;
  if (has) tile_at(tid, kL / 4, N >> 2, tr, tc);
  const int i0 = 4 * tr, n0 = 4 * tc;
  float acc_c[4][4], acc_b[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_c[r][c] = acc_b[r][c] = 0.f;
  }
  float dot = 0.f;
  for (int st = 0; st < stages; ++st) {
    __pipeline_wait_prior(kStages - 1);
    __syncthreads();   // stage st of the ring in place
    const float* hr = ring + (st % kStages) * kRing * N;
    const int r0 = st * kRing;
    if (has) {
      mma<4, 4, false, false>(acc_c, dys + r0, ldp, hr, N, i0, n0, 0, kRing);
      mma<4, 4, false, false>(acc_b, xs + r0, ldp, dhm + r0 * N, N, i0, n0,
                              0, kRing, mask, r0);
    }
    for (int e = tid; e < kRing * N; e += kThreads) {
      const int r = e / N, k = e - r * N;
      dot = fmaf(dhm[(r0 + r) * N + (k ^ swz(r0 + r, mask))], hr[e], dot);
    }
    __syncthreads();   // every thread done with this ring buffer
    issue_ring(st + kStages);
  }
  if (has) {
    // dC's state term scaled by exp(seg_i); d seg_i takes C_i . it
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = es[i0 + r];
      const float4 cv = load4(cs + (i0 + r) * ldn + n0);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_c[r][c] *= e;
      red0[(i0 + r) * kRed + tc] = cv.x * acc_c[r][0] + cv.y * acc_c[r][1]
                                 + cv.z * acc_c[r][2] + cv.w * acc_c[r][3];
      const float w = tail[i0 + r] * dtv[i0 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_b[r][c] *= w;
    }
    // dC += W B over j <= i; dB += W^T C over i >= j
    mma<4, 4, false, false>(acc_c, wm, kLd, bs, ldn, i0, n0, 0, i0 + 4);
    mma<4, 4, true, false>(acc_b, wm, kLd, cs, ldn, i0, n0, i0, kL);
  }
  dot = warp_sum(dot);
  if (lane == 0) wsum[warp] = dot;
  __syncthreads();   // every read of B and C done
  if (has) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      store4(bs + (i0 + r) * ldn + n0, make_float4(acc_c[r][0], acc_c[r][1],
                                                   acc_c[r][2], acc_c[r][3]));
      store4(cs + (i0 + r) * ldn + n0, make_float4(acc_b[r][0], acc_b[r][1],
                                                   acc_b[r][2], acc_b[r][3]));
    }
  }
  if (warp == 0) {   // lane = row: d seg, then d a, ddt and da_log's share
    float cd = 0.f;
    for (int t = 0; t < (N >> 2); ++t) cd += red0[lane * kRed + t];
    float all = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) all += wsum[w];
    const float s_ = sj[lane];
    const float tails = warp_sum(s_);
    float d = dseg[lane] + cd - s_;
    if (lane == kL - 1) d += expf(seg[kL - 1]) * all + tails;
    // d a_t = sum_{k >= t} d seg_k
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(kAll, d, off);
      if (lane + off < 32) d += v;
    }
    if (s0 + lane < S) {
      q.ddt[(static_cast<long long>(b) * S + s0 + lane) * q.h + h] =
          ddir[lane] + a * d;
    }
    const float acc = warp_sum(dtv[lane] * d);
    if (lane == 0) {
      q.part[(static_cast<long long>(b) * q.nc + chunk) * q.h + h] = a * acc;
    }
  }

  // dC and dB over the cluster's heads, rank r taking rows r kL / cs ..,
  // ranks summed in order
  cg::cluster_group cluster = cg::this_cluster();
  int rank = 0;
  if (q.cs > 1) {
    cluster.sync();
    rank = static_cast<int>(cluster.block_rank());
  } else {
    __syncthreads();
  }
  {
    const int rows = kL / q.cs, per_row = N >> 2, pieces = rows * per_row;
    const int parts = q.h / q.cs;
    for (int e = tid; e < 2 * pieces; e += kThreads) {
      const int which = e / pieces, rem = e - which * pieces;
      const int i = rank * rows + rem / per_row;
      const int k = (rem % per_row) << 2;
      const float* src = (which ? cs : bs) + i * ldn + k;
      float4 v[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {   // all loads in flight
        if (r < q.cs) {
          v[r] = load4(q.cs > 1 ? cluster.map_shared_rank(src, r) : src);
        }
      }
      float4 sum = v[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        if (r < q.cs) {
          sum.x += v[r].x;
          sum.y += v[r].y;
          sum.z += v[r].z;
          sum.w += v[r].w;
        }
      }
      if (s0 + i < S) {
        float* out = which ? q.dbp : q.dcp;
        store4(out + ((static_cast<long long>(b) * S + s0 + i) * parts
                      + h / q.cs) * N + k, sum);
      }
    }
  }
  if (q.cs > 1) cluster.sync();   // no CTA leaves while others read it
}

// dB and dC over the partial sums of each group; the last CTA sums da_log.
template <class T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const Params q) {
  const int N = q.n, parts = q.h / q.cs, per_group = parts / q.g;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < q.h; h += kThreads) {
      float acc = 0.f;
      for (long long i = 0; i < static_cast<long long>(q.batch) * q.nc; ++i) {
        acc += q.part[i * q.h + h];
      }
      q.da_log[h] = acc;
    }
    return;
  }
  const long long total = static_cast<long long>(q.batch) * q.s * q.g * N;
  const long long stride = static_cast<long long>(gridDim.x - 1) * kThreads;
  T* db = static_cast<T*>(q.db);
  T* dc = static_cast<T*>(q.dc);
  for (long long e = blockIdx.x * static_cast<long long>(kThreads)
                     + threadIdx.x; e < total; e += stride) {
    const long long row = e / N;            // (b s) g
    const int nn = static_cast<int>(e - row * N);
    const long long bs = row / q.g;
    const int g = static_cast<int>(row - bs * q.g);
    const long long src = (bs * parts + static_cast<long long>(g) * per_group)
                        * N + nn;
    float sb = 0.f, sc = 0.f;
    for (int i = 0; i < per_group; ++i) {
      sb += q.dbp[src + static_cast<long long>(i) * N];
      sc += q.dcp[src + static_cast<long long>(i) * N];
    }
    store1(db + e, sb);
    store1(dc + e, sc);
  }
}

int bytes(int floats) { return static_cast<int>(sizeof(float)) * floats; }

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

template <class T>
cudaError_t allow_smem(int states_bytes, int chunk_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      states_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              chunk_bytes);
}

template <class T>
cudaError_t launch(const Params& q, cudaStream_t st) {
  const int states_bytes = bytes(states_smem_floats(q.ps, q.n));
  const int chunk_bytes = bytes(chunk_smem_floats(q.p, q.n));
  cudaError_t err = allow_smem<T>(states_bytes, chunk_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = st;
  cfg.gridDim = dim3(q.batch * q.h * q.nps, 1, 1);
  cfg.dynamicSmemBytes = states_bytes;
  err = cudaLaunchKernelEx(&cfg, ssd_bwd_states_kernel<T>, q);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = q.cs;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(q.batch * q.nc * q.h, 1, 1);
  cfg.dynamicSmemBytes = chunk_bytes;
  cfg.attrs = cluster;
  cfg.numAttrs = q.cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, ssd_bwd_chunk_kernel<T>, q);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outs = static_cast<long long>(q.batch) * q.s * q.g * q.n;
  long long blocks = (outs + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks) + 1, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  err = cudaLaunchKernelEx(&cfg, ssd_bwd_reduce_kernel<T>, q);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

template <class T>
int occupancy(int p, int n, int* out) {
  const int ps = p < kPSlice ? p : kPSlice;
  const int states_bytes = bytes(states_smem_floats(ps, n));
  const int chunk_bytes = bytes(chunk_smem_floats(p, n));
  cudaError_t err = allow_smem<T>(states_bytes, chunk_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int chunk_ctas = 0, states_ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &chunk_ctas, ssd_bwd_chunk_kernel<T>, kThreads, chunk_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &states_ctas, ssd_bwd_states_kernel<T>, kThreads, states_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = states_bytes;
  out[1] = chunk_bytes;
  out[2] = chunk_ctas;
  out[3] = states_ctas;
  return 0;
}

}  // namespace

// x, b, c, dy: device pointers to float32 (dtype 0) or bfloat16 (dtype 1);
// x and dy addressed as base + b*s_b + s*s_s + h*s_h + p, b and c as base +
// b*s_b + s*s_s + g*s_g + n (strides in elements, the last dim contiguous;
// bases and strides multiples of 16 bytes), dt (float32) as base + b*s_b +
// s*s_s + h*s_h; a_log (H,) float32 contiguous; dstate null or float32
// (B, H, P, N) contiguous.  Outputs dx (B, S, H, P), db and dc (B, S, G, N)
// in the input type, ddt (B, S, H) and da_log (H,) float32; scratch hs and
// dhs (B, H, nc, P, N), dbp and dcp (B, S, H / cs, N), part (B, nc, H),
// float32; all contiguous, nc = ceil(s / 32).  h % g == 0; p and n in {8,
// 16, 32, 64, 128}; cs in {1, 2, 4, 8} dividing h / g.  Launches three
// kernels on `stream` and returns the first error of cudaGetLastError()
// after each launch.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const float* dt, const float* a_log, const void* b,
    const void* c, const void* dy, const float* dstate, void* dx, float* ddt,
    float* da_log, void* db, void* dc, float* hs, float* dhs, float* dbp,
    float* dcp, float* part, int dtype, int batch, int s, int h, int g, int p,
    int n, int nc, int cs, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, long long dy_sb, long long dy_ss, long long dy_sh,
    void* stream) {
  const int lp = log2_of(p), ln = log2_of(n);
  if (batch <= 0 || s <= 0 || h <= 0 || g <= 0 || h % g != 0 || lp < 3 ||
      lp > 7 || ln < 3 || ln > 7 || nc != (s + kL - 1) / kL ||
      (cs != 1 && cs != 2 && cs != 4 && cs != 8) || (h / g) % cs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ps = p < kPSlice ? p : kPSlice;
  Params q{x,     dt,    a_log, b,     c,     dy,    dstate, dx,    ddt,
           da_log, db,   dc,    hs,    dhs,   dbp,   dcp,    part,  x_sb,
           x_ss,  x_sh,  dt_sb, dt_ss, dt_sh, b_sb,  b_ss,   b_sg,  c_sb,
           c_ss,  c_sg,  dy_sb, dy_ss, dy_sh, batch, h,      g,     s,
           p,     n,     nc,    ps,    p / ps, cs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// out[0..3]: dynamic shared memory (bytes) of the states kernel and of the
// chunk kernel, and CTAs an SM of the chunk kernel and of the states
// kernel, for inputs of `dtype`, head dim p and state dim n on the current
// device.  Returns 0 or a cudaError_t.
extern "C" int ssd_scan_bwd_occupancy(int dtype, int p, int n, int* out) {
  const int lp = log2_of(p), ln = log2_of(n);
  if (lp < 3 || lp > 7 || ln < 3 || ln > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return occupancy<float>(p, n, out);
  if (dtype == 1) return occupancy<__nv_bfloat16>(p, n, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
