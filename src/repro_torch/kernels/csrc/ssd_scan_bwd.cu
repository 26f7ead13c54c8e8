// Mamba-2 SSD chunk scan, backward: the gradients of ssd_scan.cu's function.
//
// No TPU kernel: the reference takes this gradient with jax.grad of its
// plain chunked scan (src/repro/models/mamba2.py:_ssd_chunked); this is the
// gradient of the function that src/repro/kernels/ssd_scan.py:27 computes.
// For each (batch b, head h), group g = h / (H / G), A = -exp(a_log[h]),
// chunks of 64 rows, and in a chunk
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
// Float32 only (the training path's type); the wrapper refuses bfloat16.
//
// Bound on an H100 (launch/ssd_bwd_timing.py:flops_per_token_head).  An
// exact backward takes, a (token, head), five products the size of the
// state at 2 P N operations each: the state entering the chunk again, its
// cotangent, and the inter-chunk terms of dC, du and dB; a chunk of L rows
// adds 4 P N / L (the two decays and <dh_c, h_{c-1}> once a chunk) and
// (L + 1)(2 P + 3 N) for its causal pairs.  At P = 64, N = 128 the least is
// at L = 8: 11.0625 P N = 90,624 FLOP against 808 bytes read and written
// (x, dy and dx, 256 each; dt and ddt; 1/H of B, C, dB and dC): bound by
// operations at the 67 TFLOP/s float32 rate.  The chunked form below does more: per (chunk,
// head) 64 * 64 * (N + P) FMAs for C B^T and dy x^T, 64 * 64 * P for du,
// 2 * 64 * 64 * N for dB and dC, 3 * 64 * P * N for the state terms, and
// 2 * 64 * P * N a chunk for the state pass.
//
// Design: a simple kernel that is right first.  Three kernels a call, on
// the caller's stream, with no atomics, so that every sum runs in one
// fixed order and two calls give the same bits:
//  1. ssd_bwd_states_kernel, one CTA per (batch, head, slice of min(P, 64)
//     head-dim columns): the states entering each chunk, forward over the
//     chunks, then the cotangents leaving each chunk, backward; both into
//     float32 scratch (B, H, nc, P, N) that the caller allocates.  (The
//     backward recomputes them; the forward kernel writes no more than the
//     final state, so serving is untouched.)  A thread keeps a 4 x 8 tile
//     of the state in registers: three 16-byte shared loads a row feed its
//     32 FMAs.
//  2. ssd_bwd_chunk_kernel, one CTA per (batch, head, chunk): stages x, dy,
//     B and C of the chunk in shared memory (rows padded by one float, so
//     that a warp reading a column hits distinct banks), forms K = (C B^T)
//     E, W = E (dy . u) and G = (C B^T) W, then each product above as a
//     4 x 4 register tile a thread (gemm), reading the chunk's h_{c-1} and
//     dh_c from the scratch; row sums take four threads a row.  It writes
//     dx, ddt and each head's dB and dC (scratch (B, S, H, N)) and
//     A sum_t dt_t d a_t of its chunk.
//  3. ssd_bwd_reduce_kernel: dB and dC summed over the heads of each group,
//     and da_log summed over batch and chunks, each in a fixed order.
//  Both first kernels load a chunk's rows 16 bytes at a time into registers
//  before they store any (so the loads overlap), and scan seg in one warp
//  with shuffles.  A last chunk shorter than 64 rows is zero-filled with
//  dt = 0, as in the forward, and its padded rows are not stored.  x, dy,
//  dt, B and C are read through their strides (x, dy, B and C with the last
//  dim contiguous and base and strides multiples of 16 bytes); the outputs
//  and scratch are contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;        // rows a chunk holds
constexpr int kLd = kL + 1;   // padded row of an L x L matrix in shared memory
constexpr int kPSlice = 64;   // head-dim columns of a states CTA, at most
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kThreads == 4 * kL, "four threads a row in row_sum");
static_assert(kThreads >= (kPSlice / 4) * (kMaxN / 8), "a state tile a thread");

struct Params {
  const float* x;
  const float* dt;
  const float* a_log;
  const float* b;
  const float* c;
  const float* dy;
  const float* dstate;   // (B, H, P, N) or null (zero)
  float* dx;             // (B, S, H, P)
  float* ddt;            // (B, S, H)
  float* da_log;         // (H,)
  float* db;             // (B, S, G, N)
  float* dc;             // (B, S, G, N)
  float* hs;             // (B, H, nc, P, N) scratch: state entering chunk c
  float* dhs;            // (B, H, nc, P, N) scratch: cotangent leaving it
  float* dbh;            // (B, S, H, N) scratch: dB of each head
  float* dch;            // (B, S, H, N) scratch: dC of each head
  float* part;           // (B, nc, H) scratch: A sum_t dt_t d a_t a chunk
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dy_sb, dy_ss, dy_sh;
  int batch, h, g, s, p, n, nc;
  int ps, nps;   // slice width of a states CTA, slices a head
};

// floats of each kernel's dynamic shared memory
__host__ __device__ inline int states_smem_floats(int ps, int n) {
  return kL * (ps + n) + 3 * kL;
}
__host__ __device__ inline int chunk_smem_floats(int p, int n) {
  const int ldp = p + 1, ldn = n + 1, ldo = ldp > ldn ? ldp : ldn;
  return 2 * kL * ldp + 2 * kL * ldn + 3 * kL * kLd + kL * ldo + 7 * kL
       + kThreads / 32;
}

// out(i, j) = sum_k a(i, k) b(k, j) for i < m, j < n (both multiples of 4),
// k in order, as 4 x 4 tiles: a thread's rows 4 ti .. 4 ti + 3, its columns
// tj, tj + n / 4, ... (neighbouring threads read neighbouring columns of
// b).  epi(i, j, value) takes each result once, on the thread that made it.
template <class FA, class FB, class Epi>
__device__ __forceinline__ void gemm(int m, int n, int k, FA a, FB b,
                                     Epi epi) {
  const int tn = n >> 2, tiles = (m >> 2) * tn;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int ti = t / tn, tj = t - ti * tn;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int kk = 0; kk < k; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a(4 * ti + i, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b(kk, tj + tn * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(4 * ti + i, tj + tn * j, acc[i][j]);
    }
  }
}

// seg (the inclusive cumsum of dt A over the chunk) into seg[kL], by one
// warp with shuffles (lane l takes rows 2 l and 2 l + 1), so that both
// kernels get the same bits; every lane of the warp must call it
__device__ __forceinline__ void warp_seg(const float* dtv, float a,
                                         float* seg) {
  const int lane = threadIdx.x & 31;
  const float a0 = dtv[2 * lane] * a, a1 = dtv[2 * lane + 1] * a;
  float sum = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(kAll, sum, off);
    if (lane >= off) sum += v;
  }
  float prev = __shfl_up_sync(kAll, sum, 1);
  if (lane == 0) prev = 0.f;
  seg[2 * lane] = prev + a0;
  seg[2 * lane + 1] = sum;
}

// sum over k < len of f(row, k) for row = threadIdx.x / 4, by the four
// threads of the row (k = part, part + 4, ...) and two shuffles; every
// thread of the CTA must call it, and each gets its row's sum
template <class F>
__device__ __forceinline__ float row_sum(int len, F f) {
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  float acc = 0.f;
  for (int k = part; k < len; k += 4) acc += f(row, k);
  acc += __shfl_xor_sync(kAll, acc, 1);
  acc += __shfl_xor_sync(kAll, acc, 2);
  return acc;
}

// the sum of v over the warp, lane 0's order given to every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return __shfl_sync(kAll, v, 0);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows s0 .. s0 + kL - 1 of a [S][width] view (row stride `rs` floats, 16-
// byte pieces) into `dst` [kL][ld], zeros past S: every piece is loaded
// into registers before any is stored, so the loads overlap.  At most
// kMax pieces a thread.
template <int kMax>
__device__ __forceinline__ void stage_rows(const float* src, long long rs,
                                           int width, int s0, int s,
                                           float* dst, int ld) {
  const int per_row = width >> 2, pieces = kL * per_row;
  float4 v[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int j = e / per_row, k = (e - j * per_row) * 4;
    v[i] = e < pieces && s0 + j < s ? load4(src + (s0 + j) * rs + k)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < pieces) {
      const int j = e / per_row, k = (e - j * per_row) * 4;
      float* d = dst + j * ld + k;
      if ((ld & 3) == 0) {
        store4(d, v[i]);
      } else {
        d[0] = v[i].x;
        d[1] = v[i].y;
        d[2] = v[i].z;
        d[3] = v[i].w;
      }
    }
  }
}

// The states entering each chunk (forward) and the cotangents leaving each
// chunk (backward), of one (batch, head, column slice).  A thread keeps the
// state at rows 4 tp .. 4 tp + 3 of the slice and columns 4 tn .. 4 tn + 3
// and N / 2 + 4 tn .. N / 2 + 4 tn + 3 (tn < N / 8).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(const Params q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = q.n, ps = q.ps, P = q.p, half = q.n / 2;
  float* rows = smem;                // [kL][ps]  x, then dy
  float* cols = rows + kL * ps;      // [kL][N]   B, then C
  float* dtv = cols + kL * N;        // [kL]
  float* seg = dtv + kL;             // [kL]
  float* wv = seg + kL;              // [kL]      weight of each row

  const int tid = threadIdx.x;
  const int slice = blockIdx.x % q.nps;
  const int bh = blockIdx.x / q.nps;
  const int b = bh / q.h, h = bh % q.h;
  const int g = h / (q.h / q.g);
  const int p0 = slice * ps;
  const float a = -expf(q.a_log[h]);
  const float* xg = q.x + b * q.x_sb + h * q.x_sh + p0;
  const float* dyg = q.dy + b * q.dy_sb + h * q.dy_sh + p0;
  const float* dtg = q.dt + b * q.dt_sb + h * q.dt_sh;
  const float* bg = q.b + b * q.b_sb + g * q.b_sg;
  const float* cg = q.c + b * q.c_sb + g * q.c_sg;

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

  // rows of `rg` (ps wide), of `colg` (N wide) and dt of chunk c; rows
  // past S are zeros
  auto stage = [&](const float* rg, long long rs, const float* colg,
                   long long cs, int c) {
    const int s0 = c * kL;
    stage_rows<kL * kPSlice / 4 / kThreads>(rg, rs, ps, s0, q.s, rows, ps);
    stage_rows<kL * kMaxN / 4 / kThreads>(colg, cs, N, s0, q.s, cols, N);
    if (tid < kL) dtv[tid] = s0 + tid < q.s ? dtg[(s0 + tid) * q.dt_ss] : 0.f;
  };
  // st = decay st + sum_j wv_j rows_j (x) cols_j
  auto update = [&](float decay) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) st[i][c] *= decay;
    }
    if (!mine) return;
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

  for (int c = 0; c < q.nc; ++c) {
    stage(xg, q.x_ss, bg, q.b_ss, c);
    __syncthreads();
    if (tid < 32) warp_seg(dtv, a, seg);
    __syncthreads();
    if (tid < kL) wv[tid] = expf(seg[kL - 1] - seg[tid]) * dtv[tid];
    __syncthreads();
    store(q.hs, c);
    update(expf(seg[kL - 1]));
    __syncthreads();
  }

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
  for (int c = q.nc - 1; c >= 0; --c) {
    stage(dyg, q.dy_ss, cg, q.c_ss, c);
    __syncthreads();
    if (tid < 32) warp_seg(dtv, a, seg);
    __syncthreads();
    if (tid < kL) wv[tid] = expf(seg[tid]);
    __syncthreads();
    store(q.dhs, c);
    update(expf(seg[kL - 1]));
    __syncthreads();
  }
}

// Every gradient of one (batch, head, chunk).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const Params q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = q.p, N = q.n;
  const int ldp = P + 1, ldn = N + 1, ldo = ldp > ldn ? ldp : ldn;
  float* xs = smem;                  // [kL][ldp]
  float* dys = xs + kL * ldp;        // [kL][ldp]
  float* bs = dys + kL * ldp;        // [kL][ldn]
  float* cs = bs + kL * ldn;         // [kL][ldn]
  float* km = cs + kL * ldn;         // [kL][kLd]  K = (C B^T) E
  float* wm = km + kL * kLd;         // [kL][kLd]  W = E (dy . u)
  float* gm = wm + kL * kLd;         // [kL][kLd]  G = (C B^T) W
  float* ob = gm + kL * kLd;         // [kL][ldo]  a product's result
  float* dtv = ob + kL * ldo;        // [kL]
  float* seg = dtv + kL;             // [kL]
  float* es = seg + kL;              // [kL]  exp(seg_i)
  float* tail = es + kL;             // [kL]  exp(seg_last - seg_j)
  float* dseg = tail + kL;           // [kL]
  float* sj = dseg + kL;             // [kL]  dt_j x_j . (tail_j dh_c B_j)
  float* ddir = sj + kL;             // [kL]  x_j . du_j
  float* red = ddir + kL;            // [kThreads / 32]

  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 2;
  const bool lead = (tid & 3) == 0;   // writes its row's sum
  const int chunk = blockIdx.x % q.nc;
  const int bh = blockIdx.x / q.nc;
  const int b = bh / q.h, h = bh % q.h;
  const int g = h / (q.h / q.g);
  const int s0 = chunk * kL, S = q.s;
  const float a = -expf(q.a_log[h]);
  const long long state_off =
      (static_cast<long long>(b * q.h + h) * q.nc + chunk) * P * N;
  const float* hprev = q.hs + state_off;   // [P][N]
  const float* dh = q.dhs + state_off;     // [P][N]

  constexpr int kRowPieces = kL * kMaxP / 4 / kThreads;
  stage_rows<kRowPieces>(q.x + b * q.x_sb + h * q.x_sh, q.x_ss, P, s0, S, xs,
                         ldp);
  stage_rows<kRowPieces>(q.dy + b * q.dy_sb + h * q.dy_sh, q.dy_ss, P, s0, S,
                         dys, ldp);
  stage_rows<kRowPieces>(q.b + b * q.b_sb + g * q.b_sg, q.b_ss, N, s0, S, bs,
                         ldn);
  stage_rows<kRowPieces>(q.c + b * q.c_sb + g * q.c_sg, q.c_ss, N, s0, S, cs,
                         ldn);
  if (tid < kL) {
    dtv[tid] = s0 + tid < S
        ? q.dt[b * q.dt_sb + (s0 + tid) * q.dt_ss + h * q.dt_sh] : 0.f;
  }
  __syncthreads();
  if (tid < 32) warp_seg(dtv, a, seg);
  __syncthreads();
  if (tid < kL) {
    es[tid] = expf(seg[tid]);
    tail[tid] = expf(seg[kL - 1] - seg[tid]);
  }

  // C B^T into km, then dy x^T: K, W and G, zero above the diagonal (exp
  // sees only seg_i - seg_j <= 0 there)
  gemm(kL, kL, N, [=](int i, int k) { return cs[i * ldn + k]; },
       [=](int k, int j) { return bs[j * ldn + k]; },
       [=](int i, int j, float v) { km[i * kLd + j] = v; });
  __syncthreads();
  gemm(kL, kL, P, [=](int i, int k) { return dys[i * ldp + k]; },
       [=](int k, int j) { return xs[j * ldp + k]; },
       [=](int i, int j, float v) {
         float k_ = 0.f, w_ = 0.f, g_ = 0.f;
         if (j <= i) {
           const float e = expf(seg[i] - seg[j]);
           const float cb = km[i * kLd + j];
           w_ = e * dtv[j] * v;
           k_ = cb * e;
           g_ = cb * w_;
         }
         km[i * kLd + j] = k_;
         wm[i * kLd + j] = w_;
         gm[i * kLd + j] = g_;
       });
  // du's state term, transposed (rows p, columns j, so that a warp reads a
  // column of B across rows): tail_j dh_c B_j
  gemm(P, kL, N, [=](int pp, int k) { return dh[pp * N + k]; },
       [=](int k, int j) { return bs[j * ldn + k]; },
       [=](int pp, int j, float v) { ob[j * ldo + pp] = tail[j] * v; });
  __syncthreads();
  {  // d seg of the intra-chunk exponents and of the tail
    const float rsum = row_sum(kL, [=](int i, int j) { return gm[i * kLd + j]; });
    const float csum = row_sum(kL, [=](int j, int i) { return gm[i * kLd + j]; });
    const float xu = row_sum(P, [=](int j, int pp) {
      return xs[j * ldp + pp] * ob[j * ldo + pp];
    });
    if (lead) {
      sj[row] = dtv[row] * xu;
      dseg[row] = rsum - csum - sj[row];
    }
  }
  __syncthreads();
  // du = K^T dy + the state term; dx = dt du, and dt's direct share x . du
  gemm(kL, P, kL, [=](int j, int i) { return km[i * kLd + j]; },
       [=](int i, int pp) { return dys[i * ldp + pp]; },
       [=](int j, int pp, float v) { ob[j * ldo + pp] += v; });
  __syncthreads();
  {
    float* dxg = q.dx + (static_cast<long long>(b) * S * q.h + h) * P;
    for (int e = tid; e < kL * P; e += kThreads) {
      const int j = e / P, pp = e - j * P;
      if (s0 + j < S) {
        dxg[(static_cast<long long>(s0 + j) * q.h) * P + pp] =
            dtv[j] * ob[j * ldo + pp];
      }
    }
    const float xd = row_sum(P, [=](int j, int pp) {
      return xs[j * ldp + pp] * ob[j * ldo + pp];
    });
    if (lead) ddir[row] = xd;
  }
  __syncthreads();
  // dC = W B + exp(seg_i) h_{c-1}^T dy_i; d seg_i takes C_i . (the second)
  gemm(kL, N, P, [=](int i, int k) { return dys[i * ldp + k]; },
       [=](int k, int nn) { return hprev[k * N + nn]; },
       [=](int i, int nn, float v) { ob[i * ldo + nn] = es[i] * v; });
  __syncthreads();
  {
    const float cd = row_sum(N, [=](int i, int nn) {
      return cs[i * ldn + nn] * ob[i * ldo + nn];
    });
    if (lead) dseg[row] += cd;
  }
  __syncthreads();
  const long long head_rows = static_cast<long long>(q.h) * N;
  float* dch = q.dch + (static_cast<long long>(b) * S * q.h + h) * N;
  float* dbh = q.dbh + (static_cast<long long>(b) * S * q.h + h) * N;
  gemm(kL, N, kL, [=](int i, int j) { return wm[i * kLd + j]; },
       [=](int j, int nn) { return bs[j * ldn + nn]; },
       [=](int i, int nn, float v) {
         if (s0 + i < S) {
           dch[(s0 + i) * head_rows + nn] = ob[i * ldo + nn] + v;
         }
       });
  __syncthreads();
  // dB = W^T C + tail_j dt_j dh_c^T x_j
  gemm(kL, N, P, [=](int j, int k) { return xs[j * ldp + k]; },
       [=](int k, int nn) { return dh[k * N + nn]; },
       [=](int j, int nn, float v) {
         ob[j * ldo + nn] = tail[j] * dtv[j] * v;
       });
  __syncthreads();
  gemm(kL, N, kL, [=](int j, int i) { return wm[i * kLd + j]; },
       [=](int i, int nn) { return cs[i * ldn + nn]; },
       [=](int j, int nn, float v) {
         if (s0 + j < S) {
           dbh[(s0 + j) * head_rows + nn] = ob[j * ldo + nn] + v;
         }
       });

  // d seg_last takes exp(seg_last) <dh_c, h_{c-1}> and every tail's share
  float dot = 0.f;
  for (int e = tid; e < P * N; e += kThreads) dot += dh[e] * hprev[e];
  dot = warp_sum(dot);
  if (lane == 0) red[tid >> 5] = dot;
  __syncthreads();
  if (tid < 32) {
    float all = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) all += red[w];
    const float tails = warp_sum(sj[2 * lane] + sj[2 * lane + 1]);
    // lane l: rows 2 l and 2 l + 1; d a_t = sum_{k >= t} d seg_k
    const float d0 = dseg[2 * lane];
    float d1 = dseg[2 * lane + 1];
    if (lane == 31) d1 += expf(seg[kL - 1]) * all + tails;
    float suffix = d0 + d1;   // lanes l .. 31, after the scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(kAll, suffix, off);
      if (lane + off < 32) suffix += v;
    }
    float after = __shfl_down_sync(kAll, suffix, 1);   // lanes l + 1 ..
    if (lane == 31) after = 0.f;
    const float da1 = after + d1, da0 = da1 + d0;
    float* ddtg = q.ddt + static_cast<long long>(b) * S * q.h + h;
    if (s0 + 2 * lane < S) {
      ddtg[static_cast<long long>(s0 + 2 * lane) * q.h] =
          ddir[2 * lane] + a * da0;
    }
    if (s0 + 2 * lane + 1 < S) {
      ddtg[static_cast<long long>(s0 + 2 * lane + 1) * q.h] =
          ddir[2 * lane + 1] + a * da1;
    }
    const float acc = warp_sum(dtv[2 * lane] * da0 + dtv[2 * lane + 1] * da1);
    if (lane == 0) {
      q.part[(static_cast<long long>(b) * q.nc + chunk) * q.h + h] = a * acc;
    }
  }
}

// dB and dC over the heads of each group; the last CTA sums da_log.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const Params q) {
  const int r = q.h / q.g, N = q.n;
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
  for (long long e = blockIdx.x * static_cast<long long>(kThreads)
                     + threadIdx.x; e < total; e += stride) {
    const long long row = e / N;            // (b s) g
    const int nn = static_cast<int>(e - row * N);
    const long long bs = row / q.g;
    const int g = static_cast<int>(row - bs * q.g);
    const long long src = (bs * q.h + static_cast<long long>(g) * r) * N + nn;
    float db = 0.f, dc = 0.f;
    for (int i = 0; i < r; ++i) {
      db += q.dbh[src + static_cast<long long>(i) * N];
      dc += q.dch[src + static_cast<long long>(i) * N];
    }
    q.db[e] = db;
    q.dc[e] = dc;
  }
}

int bytes(int floats) { return static_cast<int>(sizeof(float)) * floats; }

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

cudaError_t allow_smem(int states_bytes, int chunk_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      states_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_bwd_chunk_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              chunk_bytes);
}

}  // namespace

// All tensors float32 device pointers.  x and dy addressed as base + b*s_b +
// s*s_s + h*s_h + p, b and c as base + b*s_b + s*s_s + g*s_g + n, dt as
// base + b*s_b + s*s_s + h*s_h (strides in elements, the last dim
// contiguous); a_log (H,) contiguous; dstate null or (B, H, P, N)
// contiguous.  Outputs dx (B, S, H, P), ddt (B, S, H), da_log (H,), db and dc
// (B, S, G, N), and the scratch hs and dhs (B, H, nc, P, N), dbh and dch
// (B, S, H, N), part (B, nc, H), all contiguous, nc = ceil(s / 64).
// h % g == 0; p and n in {8, 16, 32, 64, 128}.  Launches three kernels on
// `stream` and returns the first error of cudaGetLastError() after each.
extern "C" int ssd_scan_bwd_launch(
    const float* x, const float* dt, const float* a_log, const float* b,
    const float* c, const float* dy, const float* dstate, float* dx,
    float* ddt, float* da_log, float* db, float* dc, float* hs, float* dhs,
    float* dbh, float* dch, float* part, int batch, int s, int h, int g,
    int p, int n, int nc, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, long long dy_sb, long long dy_ss, long long dy_sh,
    void* stream) {
  const int lp = log2_of(p), ln = log2_of(n);
  if (batch <= 0 || s <= 0 || h <= 0 || g <= 0 || h % g != 0 || lp < 3 ||
      lp > 7 || ln < 3 || ln > 7 || nc != (s + kL - 1) / kL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ps = p < kPSlice ? p : kPSlice;
  Params q{x,    dt,    a_log, b,     c,     dy,    dstate, dx,    ddt,
           da_log, db,  dc,    hs,    dhs,   dbh,   dch,    part,  x_sb,
           x_ss, x_sh,  dt_sb, dt_ss, dt_sh, b_sb,  b_ss,   b_sg,  c_sb,
           c_ss, c_sg,  dy_sb, dy_ss, dy_sh, batch, h,      g,     s,
           p,    n,     nc,    ps,    p / ps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int states_bytes = bytes(states_smem_floats(ps, n));
  const int chunk_bytes = bytes(chunk_smem_floats(p, n));
  cudaError_t err = allow_smem(states_bytes, chunk_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_states_kernel<<<batch * h * q.nps, kThreads, states_bytes, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<<<batch * h * nc, kThreads, chunk_bytes, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long outs = static_cast<long long>(batch) * s * g * n;
  long long blocks = (outs + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  ssd_bwd_reduce_kernel<<<static_cast<int>(blocks) + 1, kThreads, 0, st>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// out[0..2]: dynamic shared memory (bytes) of the states kernel and of the
// chunk kernel, and CTAs an SM of the chunk kernel, for head dim p and state
// dim n on the current device.  Returns 0 or a cudaError_t.
extern "C" int ssd_scan_bwd_occupancy(int p, int n, int* out) {
  const int lp = log2_of(p), ln = log2_of(n);
  if (lp < 3 || lp > 7 || ln < 3 || ln > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ps = p < kPSlice ? p : kPSlice;
  const int states_bytes = bytes(states_smem_floats(ps, n));
  const int chunk_bytes = bytes(chunk_smem_floats(p, n));
  cudaError_t err = allow_smem(states_bytes, chunk_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, ssd_bwd_chunk_kernel, kThreads, chunk_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = states_bytes;
  out[1] = chunk_bytes;
  out[2] = ctas;
  return 0;
}

extern "C" const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
