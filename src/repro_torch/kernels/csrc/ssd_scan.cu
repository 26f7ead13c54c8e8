// Mamba-2 SSD chunk scan: y and the final state of the selective state space.
//
// Replaces the TPU kernel in src/repro/kernels/ssd_scan.py:
//   ssd_scan_kernel / ssd_scan_pallas
// For each (batch b, head h) with group g = h / (H / G), A = -exp(a_log[h])
// and the (P, N) state carried in float32 from chunk to chunk:
//
//   seg_i   = cumsum over the chunk of dt_j * A          (non-positive)
//   y_i     = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//           + exp(seg_i) C_i . h_prev                    (P values)
//   h_next  = exp(seg_last) h_prev
//           + sum_j exp(seg_last - seg_j) dt_j x_j (x) B_j
//
// x (B, S, H, P) and B/C (B, S, G, N) are float32 or bfloat16; dt (B, S, H)
// and a_log (H,) are float32; y (B, S, H, P) is written in x's type and, on
// request, the final state (B, H, P, N) in float32.  Every sum is float32;
// bfloat16 values are converted as they are staged.  The D-skip term is
// added outside, as the reference model adds it.
//
// Bound on an H100.  Every exact algorithm updates and reads out the state:
// 4 * P * N float32 operations per (token, head), against 4 * (P + 2 N) + 4
// bytes read and 4 P written: at P = 64, N = 128 that is 32768 FLOP against
// about 1.3 KB, so the scan is bound by operations at the 67 TFLOP/s float32
// rate (no tensor cores, no TF32: the path's tolerances are set for float32
// sums).  The chunked form does more: per (64-row chunk, head) 64 P N FMAs
// for C h^T, 64 P N for the state update and 2048 P for the causal M x (a
// thread's rows run to the diagonal in steps of 4), plus 64 * 64 * N for
// C B^T once per (chunk, group).  At the mamba2-1.3b shape (P = 64,
// N = 128, G = 1) that is 19.46 GFLOP a call, 1.13x the bound's 17.18.
//
// Design.  Two kernels a call, on the caller's stream:
//  1. ssd_cb_kernel, one CTA per (batch, group, chunk): C B^T of the chunk,
//     masked to its lower triangle, into a float32 scratch
//     (B, G, n_chunks, 64, 64) that the caller allocates.  Every head of the
//     group reads it from there (2 MiB at the serving shape: it stays in L2)
//     instead of forming it again.
//  2. ssd_scan_kernel, one CTA of 256 threads per (batch, head, slice of
//     min(P, 64) head-dim columns; row p of the state and column p of y
//     depend only on column p of x, so a slice carries its own rows of the
//     state).  It loops over the chunks, and its warps split:
//     - Warps 4-7 stage: the copies of chunk c + 1 (x slice, B, C, C B^T,
//       dt) go into the other stage of a 2-stage ring while chunk c is
//       computed (16-byte cp.async for float32; for bfloat16, 16-byte loads
//       into registers, converted into the stage after the update).  Each
//       thread's source pointers are set up once.  They then update the
//       state, which they keep in registers (8 x 8 of (n, p) a thread):
//       h = exp(seg_last) h + sum_j B_j (x) w_j x_j, and write it to shared
//       memory once every read-out warp has signalled (a named barrier)
//       that it is done with h_prev.
//     - Warps 0-3 read out y = exp(seg) (C h_prev^T) + M x, 8 rows x 4
//       columns a thread: rows 4 a .. 4 a + 3 and 60 - 4 a .. 63 - 4 a, so
//       the causal M x loop is as long for every thread.  Between the two
//       products each warp builds 16 rows of M = (C B^T) exp(seg_i - seg_j)
//       dt_j in place of C B^T; exp never sees a positive argument (above
//       the diagonal seg_i - seg_j > 0 could overflow, and inf * 0 is NaN).
//     Every warp scans dt * A for itself with shuffles, in base 2 (A log2 e)
//     so that each decay is one exp2.  One block barrier a chunk opens it.
//     The tiles give 10.7 FMAs per 16-byte shared load in the read-out and
//     16 in the update; C and M have their float4 columns swizzled by row
//     (swz) so that the two rows a warp loads at once sit on distinct banks.
//  A last chunk shorter than 64 rows is zero-filled (dt = 0 makes a padded
//  row add nothing and decay nothing) and its padded rows are not stored.
//  x, B, C, dt and y are read and written through their strides (the model
//  hands in views of its projections); B/C are read by group, never
//  repeated per head.  x, B, C and y must allow 16-byte copies (base and
//  strides multiples of 16 bytes, P and N contiguous): the wrapper copies a
//  tensor that does not.  Shared memory at slice 64, N = 128: 230,912 B, one
//  CTA (8 warps) an SM.
//
// Why this shape (tried on an H100): the read-out is not bound by
// shared-memory bandwidth (taking most of its shared loads away barely
// moved it) but by how much independent work the two warps of each
// scheduler have; building M in the update warps, a chunk ahead, ran
// slower than building it here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;   // warps 0-3 read out, 4-7 update
constexpr int kL = 64;          // rows a chunk holds
constexpr int kPSlice = 64;     // head-dim columns a scan CTA owns, at most
constexpr int kMaxN = 128;

static_assert(kThreads == (kL / 4) * (kL / 4), "a 4x4 tile of C B^T a thread");
static_assert(kL == (kHalf / 32) * 16, "a read-out warp builds 16 rows of M");
static_assert(kHalf >= (kL / 8) * (kPSlice / 4), "one read-out tile a thread");
static_assert(kHalf >= (kMaxN / 8) * (kPSlice / 8), "one state tile a thread");

constexpr float kLog2e = 1.4426950408889634f;

// named barriers (0 is __syncthreads)
constexpr int kBarStateRead = 1;   // read-out warps are done with h_prev
constexpr int kBarM = 2;           // read-out warps have built M

struct Params {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  void* y;
  float* state;   // (B, H, P, N) float32, or null
  float* cb;      // (B, G, nc, kL, kL) float32 scratch
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
  int h, g, s, p, n, nc;
  int ps, nps, lps;   // slice width, slices a head, log2(slice width)
  int ln;             // log2(n)
};

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// 4 values from global memory as float32 (16 or 8 bytes, aligned)
__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
// A read-out warp loads two rows of C (and of M) 4 rows apart at once
// (4 a + i for a = 2 w, 2 w + 1, and 60 - 4 a + i); their rows are a
// multiple of 32 floats long, so the two would share banks.  The float4 at
// column k of row r is kept at column k ^ swz(r), which puts them on
// distinct banks.
__device__ __forceinline__ int swz(int row) { return ((row >> 2) & 1) << 2; }

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void readers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kHalf) : "memory");
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// floats of one stage of the ring: x slice [kL][ps], B and C [kL][n],
// C B^T (then M) [kL][kL], dt [kL]
__host__ __device__ inline int stage_floats(int ps, int n) {
  return kL * ps + 2 * kL * n + kL * kL + kL;
}
// floats of the scan kernel's shared memory: two stages, the state [n][ps]
// and each update warp's w [4][kL]
__host__ __device__ inline int scan_smem_floats(int ps, int n) {
  return 2 * stage_floats(ps, n) + n * ps + (kHalf / 32) * kL;
}
__host__ __device__ inline int cb_smem_floats(int n) {
  return 2 * kL * (n + 4);
}

// One stage's buffers.
struct Stage {
  float* x;
  float* b;
  float* c;
  float* m;
  float* dt;
  __device__ Stage(float* base, int ps, int n)
      : x(base), b(x + kL * ps), c(b + kL * n), m(c + kL * n),
        dt(m + kL * kL) {}
};

// Where one chunk of one scan CTA comes from.
struct Source {
  const void* x;      // x at (b, 0, h, p0)
  const float* dt;    // dt at (b, 0, h)
  const void* b;      // B at (b, 0, g)
  const void* c;      // C at (b, 0, g)
  const float* cb;    // C B^T scratch at (b, g, 0)
};

// The update warps stage every chunk; this is a thread's index among them.
__device__ __forceinline__ int stager_tid() { return threadIdx.x - kHalf; }

// How an update thread cuts a [kL][width] array into pieces of `vec`
// values: column k of rows j0, j0 + step, ... (step is 4 or more and
// divides kL)
struct Pieces {
  int k, j0, step;
  __device__ Pieces(int width, int vec) {
    const int per_row = width / vec;
    k = (stager_tid() % per_row) * vec;
    j0 = stager_tid() / per_row;
    step = kHalf / per_row;
  }
};

// C B^T and dt of a chunk: float32 whatever the input type, by cp.async.
// Each thread's source pointers are set up once; a chunk only moves them.
struct CbDtStager {
  Pieces pm;
  const float* cb;   // the thread's first piece of chunk 0
  const float* dt;   // dt at (b, 0, h)
  __device__ CbDtStager(const Source& src)
      : pm(kL, 4), cb(src.cb + pm.j0 * kL + pm.k), dt(src.dt) {}
  __device__ void issue(const Params& q, const Stage& sg, int chunk) const {
    const float* from = cb + static_cast<long long>(chunk) * kL * kL;
    for (int j = pm.j0; j < kL; j += pm.step, from += pm.step * kL) {
      cp_async16(sg.m + j * kL + (pm.k ^ swz(j)), from, true);
    }
    const int tid = stager_tid(), row = chunk * kL + tid;
    if (tid < kL) {
      const bool in = row < q.s;
      cp_async4(sg.dt + tid, dt + (in ? row : 0) * q.dt_ss, in);
    }
  }
};

// Stages x, B and C of a chunk, run by the update warps: issue() starts the
// copies, land() finishes them (after the current chunk's update, before
// the barrier that opens the staged chunk).  Rows past S are zero-filled.
// C's float4 columns are swizzled (swz).
template <typename T>
struct Stager;

template <>
struct Stager<float> : CbDtStager {
  Pieces px, pb;
  const float* x0;   // row 0 of x, the address a zero-filled piece names
  const float* x;    // the thread's first piece of x in chunk 0
  const float* b;
  const float* c;
  __device__ Stager(const Params& q, const Source& src)
      : CbDtStager(src), px(q.ps, 4), pb(q.n, 4),
        x0(static_cast<const float*>(src.x)),
        x(x0 + px.j0 * q.x_ss + px.k),
        b(static_cast<const float*>(src.b) + pb.j0 * q.b_ss + pb.k),
        c(static_cast<const float*>(src.c) + pb.j0 * q.c_ss + pb.k) {}

  __device__ void issue(const Params& q, const Stage& sg, int chunk) const {
    const int s0 = chunk * kL, left = q.s - s0;   // rows the chunk has
    const float* xf = x + s0 * q.x_ss;
    for (int j = px.j0; j < kL; j += px.step, xf += px.step * q.x_ss) {
      cp_async16(sg.x + j * q.ps + px.k, j < left ? xf : x0, j < left);
    }
    const float* bf = b + s0 * q.b_ss;
    const float* cf = c + s0 * q.c_ss;
    for (int j = pb.j0; j < kL;
         j += pb.step, bf += pb.step * q.b_ss, cf += pb.step * q.c_ss) {
      const bool in = j < left;
      cp_async16(sg.b + j * q.n + pb.k, in ? bf : x0, in);
      cp_async16(sg.c + j * q.n + (pb.k ^ swz(j)), in ? cf : x0, in);
    }
    CbDtStager::issue(q, sg, chunk);
  }
  __device__ void land(const Params&, const Stage&) const {}
};

template <>
struct Stager<__nv_bfloat16> : CbDtStager {
  // 16-byte pieces (8 values) a thread holds: x slice [kL][<= 64], B and C
  // [kL][<= 128]
  static constexpr int kX = kL * kPSlice / 8 / kHalf;
  static constexpr int kB = kL * kMaxN / 8 / kHalf;
  Pieces px, pb;
  const __nv_bfloat16* x;   // the thread's first piece of x in chunk 0
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  uint4 xr[kX], br[kB], cr[kB];

  __device__ Stager(const Params& q, const Source& src)
      : CbDtStager(src), px(q.ps, 8), pb(q.n, 8),
        x(static_cast<const __nv_bfloat16*>(src.x) + px.j0 * q.x_ss + px.k),
        b(static_cast<const __nv_bfloat16*>(src.b) + pb.j0 * q.b_ss + pb.k),
        c(static_cast<const __nv_bfloat16*>(src.c) + pb.j0 * q.c_ss + pb.k) {}

  __device__ void issue(const Params& q, const Stage& sg, int chunk) {
    const int s0 = chunk * kL, left = q.s - s0;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat16* xf = x + s0 * q.x_ss;
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int j = px.j0 + i * px.step;
      xr[i] = j < kL && j < left
          ? *reinterpret_cast<const uint4*>(xf + i * px.step * q.x_ss)
          : zero;
    }
    const __nv_bfloat16* bf = b + s0 * q.b_ss;
    const __nv_bfloat16* cf = c + s0 * q.c_ss;
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int j = pb.j0 + i * pb.step;
      const bool in = j < kL && j < left;
      br[i] = in ? *reinterpret_cast<const uint4*>(bf + i * pb.step * q.b_ss)
                 : zero;
      cr[i] = in ? *reinterpret_cast<const uint4*>(cf + i * pb.step * q.c_ss)
                 : zero;
    }
    CbDtStager::issue(q, sg, chunk);
  }

  // 8 bfloat16 -> 8 float32 at columns col .. col + 7 of row (the float4 at
  // column k kept at k ^ sw)
  static __device__ __forceinline__ void put(float* row, int col, int sw,
                                             const uint4& v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
    store4(row + (col ^ sw), make_float4(f[0], f[1], f[2], f[3]));
    store4(row + ((col + 4) ^ sw), make_float4(f[4], f[5], f[6], f[7]));
  }

  __device__ void land(const Params& q, const Stage& sg) const {
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int j = px.j0 + i * px.step;
      if (j < kL) put(sg.x + j * q.ps, px.k, 0, xr[i]);
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int j = pb.j0 + i * pb.step;
      if (j < kL) {
        put(sg.b + j * q.n, pb.k, 0, br[i]);
        put(sg.c + j * q.n, pb.k, swz(j), cr[i]);
      }
    }
  }
};

// seg = the inclusive cumsum over the chunk of dt * A, scanned by one warp
// with shuffles: lane l gets rows 2l (even) and 2l + 1 (odd).
struct Seg {
  float even, odd;
  __device__ Seg(const float* dt, float a) {
    const int lane = threadIdx.x & 31;
    const float a0 = dt[2 * lane] * a, a1 = dt[2 * lane + 1] * a;
    float sum = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, sum, off);
      if (lane >= off) sum += t;
    }
    float prev = __shfl_up_sync(0xffffffffu, sum, 1);
    if (lane == 0) prev = 0.f;
    even = prev + a0;
    odd = sum;
  }
  // seg of row j, from the lane that holds it (every lane must take part)
  __device__ float of(int j) const {
    const float e = __shfl_sync(0xffffffffu, even, j >> 1);
    const float o = __shfl_sync(0xffffffffu, odd, j >> 1);
    return (j & 1) ? o : e;
  }
  __device__ float last() const { return __shfl_sync(0xffffffffu, odd, 31); }
};

// C B^T of one (batch, group, chunk), masked to its lower triangle.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const Params q) {
  extern __shared__ float4 smem4[];
  const int N = q.n, ldn = N + 4;
  float* bs = reinterpret_cast<float*>(smem4);   // [kL][ldn]
  float* cs = bs + kL * ldn;                     // [kL][ldn]
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % q.nc;
  const int bg = blockIdx.x / q.nc;
  const int g = bg % q.g, b = bg / q.g;
  const int s0 = chunk * kL;
  const T* bsrc = static_cast<const T*>(q.b) + b * q.b_sb + g * q.b_sg;
  const T* csrc = static_cast<const T*>(q.c) + b * q.c_sb + g * q.c_sg;
  const int lq = q.ln - 2;   // log2 of the 4-value pieces of a row
  for (int e = tid; e < (kL << lq); e += kThreads) {
    const int j = e >> lq, k = (e & ((1 << lq) - 1)) * 4;
    const bool in = s0 + j < q.s;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    store4(bs + j * ldn + k, in ? load4f(bsrc + (s0 + j) * q.b_ss + k) : zero);
    store4(cs + j * ldn + k, in ? load4f(csrc + (s0 + j) * q.c_ss + k) : zero);
  }
  __syncthreads();

  // the thread's rows are 4*it .. 4*it+3, its columns jt + 16 r
  const int it = tid >> 4, jt = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;
  }
  for (int k = 0; k < N; k += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cv[i] = load4(cs + (4 * it + i) * ldn + k);
      bv[i] = load4(bs + (jt + 16 * i) * ldn + k);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][r] = fmaf(cv[i].x, bv[r].x, acc[i][r]);
        acc[i][r] = fmaf(cv[i].y, bv[r].y, acc[i][r]);
        acc[i][r] = fmaf(cv[i].z, bv[r].z, acc[i][r]);
        acc[i][r] = fmaf(cv[i].w, bv[r].w, acc[i][r]);
      }
    }
  }
  float* out = q.cb + (static_cast<long long>(bg) * q.nc + chunk) * kL * kL;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * it + i;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = jt + 16 * r;
      out[row * kL + col] = col <= row ? acc[i][r] : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const Params q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = q.n, ps = q.ps;
  const int sf = stage_floats(ps, N);
  float* hs = smem + 2 * sf;        // [N][ps]    the state, transposed
  float* ws = hs + N * ps;          // [4][kL]    w_j, one row an update warp

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x % q.nps;
  const int bh = blockIdx.x / q.nps;
  const int b = bh / q.h, h = bh % q.h;
  const int g = h / (q.h / q.g);
  const int p0 = slice * ps;
  const Source src{
      static_cast<const T*>(q.x) + b * q.x_sb + h * q.x_sh + p0,
      q.dt + b * q.dt_sb + h * q.dt_sh,
      static_cast<const T*>(q.b) + b * q.b_sb + g * q.b_sg,
      static_cast<const T*>(q.c) + b * q.c_sb + g * q.c_sg,
      q.cb + static_cast<long long>(b * q.g + g) * q.nc * kL * kL};
  T* yg = static_cast<T*>(q.y) + b * q.y_sb + h * q.y_sh + p0;
  // A log2(e): seg is kept in base 2, so that exp(seg_i - seg_j) is one
  // exp2 of seg_i - seg_j
  const float a = -expf(q.a_log[h]) * kLog2e;

  // Warps 0-3 read out rows 4 ra .. 4 ra + 3 and 60 - 4 ra .. 63 - 4 ra
  // (ra < kL / 8: the causal M x loop is as long for every ra) at columns
  // 4 pt .. 4 pt + 3.  Warps 4-7 stage the chunks and update state rows
  // 8 nt .. 8 nt + 7 at columns 4 pu .. 4 pu + 3 and ps / 2 + 4 pu ..
  // ps / 2 + 4 pu + 3 (nt < N / 8).
  const bool reader = tid < kHalf;
  const int ut = reader ? tid : tid - kHalf;
  const int lpt = q.lps - 2, lpu = q.lps - 3;
  const int ra = ut >> lpt, pt = ut & ((1 << lpt) - 1);
  const int nt = ut >> lpu, pu = ut & ((1 << lpu) - 1);
  const bool reads = reader && ra < kL / 8;
  const bool updates = !reader && nt < (N >> 3);
  // the read-out thread's rows: i < 4 at lo + i, i >= 4 at hi + i - 4
  const int lo = 4 * (ra & (kL / 8 - 1)), hi = kL - 4 - lo;
  auto row_of = [&](int i) { return i < 4 ? lo + i : hi + i - 4; };

  float hr[8][8];   // state rows 8 nt + i, the update thread's 8 columns
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) hr[i][c] = 0.f;
  }
  for (int e = tid; e < N * ps; e += kThreads) hs[e] = 0.f;

  Stager<T> stager(q, src);
  if (!reader) {
    const Stage first(smem, ps, N);
    stager.issue(q, first, 0);
    cp_async_commit();
    stager.land(q, first);
    cp_async_wait_all();
  }

  for (int chunk = 0; chunk < q.nc; ++chunk) {
    const int st = chunk & 1;
    const Stage sg(smem + st * sf, ps, N);
    // the chunk has landed; every thread is done with the chunk before
    // (whose stage the next copies overwrite), and h holds its state
    __syncthreads();

    if (reader) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
      }
      // C h_prev^T
      if (reads) {
#pragma unroll 4
        for (int k = 0; k < N; k += 4) {
          float4 cv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = row_of(i);
            cv[i] = load4(sg.c + r * N + (k ^ swz(r)));
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 hv = load4(hs + (k + kk) * ps + 4 * pt);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float u = at(cv[i], kk);
              acc[i][0] = fmaf(u, hv.x, acc[i][0]);
              acc[i][1] = fmaf(u, hv.y, acc[i][1]);
              acc[i][2] = fmaf(u, hv.z, acc[i][2]);
              acc[i][3] = fmaf(u, hv.w, acc[i][3]);
            }
          }
        }
      }
      bar_arrive(kBarStateRead);   // h_prev may be overwritten

      // M = (C B^T) exp(seg_i - seg_j) dt_j in place of C B^T: this warp's
      // rows 16 warp .. 16 warp + 15, the lane's columns lane and lane + 32;
      // exp never sees a positive argument (above the diagonal seg_i - seg_j
      // > 0 could overflow, and inf * 0 is NaN)
      const Seg seg(sg.dt, a);
      {
        const float seg_c0 = seg.of(lane), seg_c1 = seg.of(lane + 32);
        const float dt0 = sg.dt[lane], dt1 = sg.dt[lane + 32];
#pragma unroll 4
        for (int r = 0; r < 16; ++r) {
          const int i = warp * 16 + r;
          const float seg_i = seg.of(i);
          float* mrow = sg.m + i * kL;
          const int c0 = lane ^ swz(i), c1 = (lane + 32) ^ swz(i);
          // exp of min(seg_i - seg_j, 0): above the diagonal the argument
          // would be positive and the result is dropped
          const float m0 = mrow[c0] * exp2f(fminf(seg_i - seg_c0, 0.f)) * dt0;
          const float m1 = mrow[c1] * exp2f(fminf(seg_i - seg_c1, 0.f)) * dt1;
          mrow[c0] = lane <= i ? m0 : 0.f;
          mrow[c1] = lane + 32 <= i ? m1 : 0.f;
        }
      }
      float es[8];   // exp(seg) of the thread's rows
#pragma unroll
      for (int i = 0; i < 8; ++i) es[i] = exp2f(seg.of(row_of(i)));
      readers_sync(kBarM);

      // y = exp(seg) (C h_prev^T) + M x: the 8 rows up to the lower group's
      // diagonal, then the upper 4 rows up to theirs
      if (reads) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] *= es[i];
        }
        for (int j = 0; j < lo + 4; j += 4) {
          float4 mv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = row_of(i);
            mv[i] = load4(sg.m + r * kL + (j ^ swz(r)));
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 xv = load4(sg.x + (j + jj) * ps + 4 * pt);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float u = at(mv[i], jj);
              acc[i][0] = fmaf(u, xv.x, acc[i][0]);
              acc[i][1] = fmaf(u, xv.y, acc[i][1]);
              acc[i][2] = fmaf(u, xv.z, acc[i][2]);
              acc[i][3] = fmaf(u, xv.w, acc[i][3]);
            }
          }
        }
        for (int j = lo + 4; j < hi + 4; j += 4) {   // M is 0 past the diagonal
          float4 mv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mv[i] = load4(sg.m + (hi + i) * kL + (j ^ swz(hi)));
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 xv = load4(sg.x + (j + jj) * ps + 4 * pt);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float u = at(mv[i], jj);
              acc[4 + i][0] = fmaf(u, xv.x, acc[4 + i][0]);
              acc[4 + i][1] = fmaf(u, xv.y, acc[4 + i][1]);
              acc[4 + i][2] = fmaf(u, xv.z, acc[4 + i][2]);
              acc[4 + i][3] = fmaf(u, xv.w, acc[4 + i][3]);
            }
          }
        }
        const int s0 = chunk * kL;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = s0 + row_of(i);
          if (row < q.s) {
            store4(yg + row * q.y_ss + 4 * pt,
                   make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
          }
        }
      }
    } else {
      // stage the next chunk while this one is updated and read out
      const Stage next(smem + (st ^ 1) * sf, ps, N);
      const bool more = chunk + 1 < q.nc;
      if (more) stager.issue(q, next, chunk + 1);
      cp_async_commit();

      // w_j = exp(seg_last - seg_j) dt_j, each update warp its own copy
      const Seg seg(sg.dt, a);
      const float seg_last = seg.last();
      float* w = ws + (warp - kHalf / 32) * kL;
      w[2 * lane] = exp2f(seg_last - seg.even) * sg.dt[2 * lane];
      w[2 * lane + 1] = exp2f(seg_last - seg.odd) * sg.dt[2 * lane + 1];
      __syncwarp();
      const float dlast = exp2f(seg_last);

      // h = exp(seg_last) h + sum_j B_j (x) w_j x_j, in registers
      if (updates) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < 8; ++c) hr[i][c] *= dlast;
        }
        const float* brow = sg.b + 8 * nt;
        const float* xrow = sg.x + 4 * pu;
#pragma unroll 2
        for (int j = 0; j < kL; ++j) {
          const float4 b0 = load4(brow + j * N), b1 = load4(brow + j * N + 4);
          const float wj = w[j];
          float4 x0 = load4(xrow + j * ps), x1 = load4(xrow + j * ps + ps / 2);
          const float xv[8] = {x0.x * wj, x0.y * wj, x0.z * wj, x0.w * wj,
                               x1.x * wj, x1.y * wj, x1.z * wj, x1.w * wj};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float u = at(i < 4 ? b0 : b1, i & 3);
#pragma unroll
            for (int c = 0; c < 8; ++c) hr[i][c] = fmaf(u, xv[c], hr[i][c]);
          }
        }
      }
      // once every read-out warp is done with h_prev, write h
      bar_sync(kBarStateRead);
      if (updates) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* hrow = hs + (8 * nt + i) * ps + 4 * pu;
          store4(hrow, make_float4(hr[i][0], hr[i][1], hr[i][2], hr[i][3]));
          store4(hrow + ps / 2,
                 make_float4(hr[i][4], hr[i][5], hr[i][6], hr[i][7]));
        }
      }
      if (more) stager.land(q, next);
      cp_async_wait_all();
    }
  }

  if (q.state != nullptr && updates) {
    float* sgl = q.state + (static_cast<long long>(b * q.h + h) * q.p + p0) * N
               + 8 * nt;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : ps / 2) + 4 * pu + (c & 3);
      store4(sgl + col * N,
             make_float4(hr[0][c], hr[1][c], hr[2][c], hr[3][c]));
      store4(sgl + col * N + 4,
             make_float4(hr[4][c], hr[5][c], hr[6][c], hr[7][c]));
    }
  }
}

template <typename T>
cudaError_t allow_smem(int cb_bytes, int scan_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cb_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_scan_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              scan_bytes);
}

int bytes(int floats) { return static_cast<int>(sizeof(float)) * floats; }

template <typename T>
cudaError_t launch(const Params& q, int batch, cudaStream_t stream) {
  const int cb_bytes = bytes(cb_smem_floats(q.n));
  const int scan_bytes = bytes(scan_smem_floats(q.ps, q.n));
  cudaError_t err = allow_smem<T>(cb_bytes, scan_bytes);
  if (err != cudaSuccess) return err;
  ssd_cb_kernel<T><<<batch * q.g * q.nc, kThreads, cb_bytes, stream>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<batch * q.h * q.nps, kThreads, scan_bytes, stream>>>(
      q);
  return cudaGetLastError();
}

// out[0..2]: threads, dynamic shared memory (bytes) and CTAs an SM of the
// scan kernel; out[3..5] the same of the C B^T kernel
template <typename T>
int occupancy(int ps, int n, int* out) {
  const int cb_bytes = bytes(cb_smem_floats(n));
  const int scan_bytes = bytes(scan_smem_floats(ps, n));
  cudaError_t err = allow_smem<T>(cb_bytes, scan_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int scan_ctas = 0, cb_ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &scan_ctas, ssd_scan_kernel<T>, kThreads, scan_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &cb_ctas, ssd_cb_kernel<T>, kThreads, cb_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[6] = {kThreads, scan_bytes, scan_ctas,
                       kThreads, cb_bytes, cb_ctas};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

// x, b, c, y: device pointers to float32 (dtype 0) or bfloat16 (dtype 1)
// tensors; x and y addressed as base + b*s_b + s*s_s + h*s_h + p, b and c as
// base + b*s_b + s*s_s + g*s_g + n (strides in elements; P and N
// contiguous; bases and strides multiples of 16 bytes).  dt: float32,
// base + b*s_b + s*s_s + h*s_h; a_log: float32 (H,) contiguous; state: null,
// or float32 (B, H, P, N) contiguous; cb: float32 scratch (B, G, nc, 64, 64)
// contiguous with nc = ceil(s / 64).  h % g == 0; p and n in {8, 16, 32, 64,
// 128}.  Launches two kernels on `stream` and returns the first error of
// cudaGetLastError() after each launch.
extern "C" int ssd_scan_launch(
    const void* x, const float* dt, const float* a_log, const void* b,
    const void* c, void* y, float* state, float* cb, int dtype, int batch,
    int s, int h, int g, int p, int n, int nc, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg, long long c_sb,
    long long c_ss, long long c_sg, long long y_sb, long long y_ss,
    long long y_sh, void* stream) {
  const int lp = log2_of(p), ln = log2_of(n);
  if (batch <= 0 || s <= 0 || h <= 0 || g <= 0 || h % g != 0 || lp < 3 ||
      lp > 7 || ln < 3 || ln > 7 || nc != (s + kL - 1) / kL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ps = p < kPSlice ? p : kPSlice;
  Params q{x,    dt,    a_log, b,    c,    y,    state, cb,   x_sb, x_ss,
           x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,  c_sb, c_ss, c_sg,
           y_sb, y_ss,  y_sh,  h,    g,    s,    p,     n,    nc,   ps,
           p / ps, log2_of(ps), ln};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, batch, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, batch, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// out[0..5] as occupancy() above, for inputs of `dtype` with head dim p and
// state dim n on the current device.  Returns 0 or a cudaError_t.
extern "C" int ssd_scan_occupancy(int dtype, int p, int n, int* out) {
  const int lp = log2_of(p), ln = log2_of(n);
  if (lp < 3 || lp > 7 || ln < 3 || ln > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ps = p < kPSlice ? p : kPSlice;
  if (dtype == 0) return occupancy<float>(ps, n, out);
  if (dtype == 1) return occupancy<__nv_bfloat16>(ps, n, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
