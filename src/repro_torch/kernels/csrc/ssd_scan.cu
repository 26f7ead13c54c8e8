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
// Design.  The Pallas grid walks the chunks in order and keeps the state in
// VMEM scratch between grid steps; Hopper's CTAs run in parallel and in no
// order, so one CTA owns one (batch, head) and loops over the chunks itself,
// with the state in shared memory (transposed, [N][P]) for the whole scan.
// A chunk is 64 rows; a last chunk shorter than that is zero-filled (dt = 0
// makes a padded row add nothing and decay nothing) and its padded rows are
// not stored.  Per chunk, 256 threads:
//   1. stage x, B, C (float32) and dt; warp 0 scans dt * A into seg;
//   2. M = (C B^T) masked and scaled: exp(seg_i - seg_j) dt_j on and below
//      the diagonal, 0 above it, where exp is never taken (above the
//      diagonal seg_i - seg_j > 0 and exp could overflow; inf * 0 is NaN);
//   3. y = exp(seg) (C h^T) + M x, for rows i only over j <= i;
//   4. h = exp(seg_last) h + (w x)^T B with w_j = exp(seg_last - seg_j) dt_j.
// Each thread owns a 4 x 4 tile of the product it computes and reads float4
// rows from shared memory.  B/C are read by group through their strides,
// never repeated per head; x, dt, B, C and y are read and written through
// their strides (the model hands in views of its projections; only P and N
// must be contiguous).  Shared memory at P = N = 128: 180 KiB (one CTA an
// SM); at P = 64, N = 128 (mamba2-1.3b): 132 KiB.
//
// Bound on an H100.  Every exact algorithm updates and reads out the state:
// 4 * P * N float32 operations per (token, head), against 4 * (P + 2 N) + 4
// bytes read and 4 P written: at P = 64, N = 128 that is 32768 FLOP against
// about 1.3 KB, so the scan is bound by operations at the 67 TFLOP/s float32
// rate (no tensor cores).  This kernel also does the chunk's quadratic part
// (64 * (N + P) / 2 FMAs per token and head) and recomputes C B^T once per
// head, although for G = 1 every head of a batch row shares it: the first
// thing a redesign removes.  Left for later: C B^T once per group,
// tensor-core (wgmma) products on bf16 tiles, double-buffered TMA staging of
// the next chunk, and a chunk-parallel intra pass ahead of the state scan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;          // rows a chunk holds
constexpr int kLdm = kL + 4;    // row stride (floats) of M

static_assert(kThreads == (kL / 4) * (kL / 4), "one 4x4 tile of M a thread");

struct Params {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  void* y;
  float* state;   // (B, H, P, N) float32, or null
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
  int h, g, s, p, n, lp, ln;   // lp = log2(p), ln = log2(n)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// floats of shared memory for head dim p and state dim n
__host__ __device__ inline int smem_floats(int p, int n) {
  return n * p + kL * p + 2 * kL * (n + 4) + kL * kLdm + 4 * kL;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(Params q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = q.p, N = q.n, ldn = N + 4;
  float* ht = smem;                 // [N][P]   state, transposed
  float* xs = ht + N * P;           // [kL][P]  x
  float* bs = xs + kL * P;          // [kL][ldn] B
  float* cs = bs + kL * ldn;        // [kL][ldn] C
  float* ms = cs + kL * ldn;        // [kL][kLdm] M
  float* seg = ms + kL * kLdm;      // [kL]
  float* dts = seg + kL;            // [kL] dt
  float* wj = dts + kL;             // [kL] exp(seg_last - seg_j) dt_j
  float* es = wj + kL;              // [kL] exp(seg_i)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / q.h;
  const int h = blockIdx.x % q.h;
  const int g = h / (q.h / q.g);
  const T* xg = static_cast<const T*>(q.x) + b * q.x_sb + h * q.x_sh;
  const float* dtg = q.dt + b * q.dt_sb + h * q.dt_sh;
  const T* bg = static_cast<const T*>(q.b) + b * q.b_sb + g * q.b_sg;
  const T* cg = static_cast<const T*>(q.c) + b * q.c_sb + g * q.c_sg;
  T* yg = static_cast<T*>(q.y) + b * q.y_sb + h * q.y_sh;
  const float a = -expf(q.a_log[h]);

  for (int e = tid; e < N * P; e += kThreads) ht[e] = 0.f;

  for (int s0 = 0; s0 < q.s; s0 += kL) {
    __syncthreads();  // the last chunk's readers of the staged rows are done
    for (int e = tid; e < kL * P; e += kThreads) {
      const int j = e >> q.lp, d = e & (P - 1);
      xs[e] = s0 + j < q.s ? to_float(xg[(s0 + j) * q.x_ss + d]) : 0.f;
    }
    for (int e = tid; e < kL * N; e += kThreads) {
      const int j = e >> q.ln, k = e & (N - 1);
      const bool in = s0 + j < q.s;
      bs[j * ldn + k] = in ? to_float(bg[(s0 + j) * q.b_ss + k]) : 0.f;
      cs[j * ldn + k] = in ? to_float(cg[(s0 + j) * q.c_ss + k]) : 0.f;
    }
    if (tid < kL) dts[tid] = s0 + tid < q.s ? dtg[(s0 + tid) * q.dt_ss] : 0.f;
    __syncthreads();

    // 1. seg = inclusive cumsum of dt * A: two rows a lane, then a warp scan
    if (tid < 32) {
      const float a0 = dts[2 * tid] * a, a1 = dts[2 * tid + 1] * a;
      float sum = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, sum, off);
        if (tid >= off) sum += t;
      }
      float prev = __shfl_up_sync(0xffffffffu, sum, 1);
      if (tid == 0) prev = 0.f;
      seg[2 * tid] = prev + a0;
      seg[2 * tid + 1] = sum;
    }
    __syncthreads();
    if (tid < kL) {
      wj[tid] = expf(seg[kL - 1] - seg[tid]) * dts[tid];
      es[tid] = expf(seg[tid]);
    }

    // 2. M: the thread's rows are 4*it .. 4*it+3, its columns jt + 16 r
    {
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * it + i;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = jt + 16 * r;
          ms[row * kLdm + col] =
              col <= row ? acc[i][r] * expf(seg[row] - seg[col]) * dts[col]
                         : 0.f;
        }
      }
    }
    __syncthreads();

    // 3. y = exp(seg) (C h^T) + M x over 4 x 4 tiles of (row, p)
    for (int t = tid; t < (kL / 4) * (P / 4); t += kThreads) {
      const int it = t / (P / 4), pt = t % (P / 4);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
      }
      for (int k = 0; k < N; k += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cv[i] = load4(cs + (4 * it + i) * ldn + k);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 hv = load4(ht + (k + kk) * P + 4 * pt);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cval = at(cv[i], kk);
            acc[i][0] = fmaf(cval, hv.x, acc[i][0]);
            acc[i][1] = fmaf(cval, hv.y, acc[i][1]);
            acc[i][2] = fmaf(cval, hv.z, acc[i][2]);
            acc[i][3] = fmaf(cval, hv.w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = es[4 * it + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= e;
      }
      for (int j = 0; j < 4 * it + 4; j += 4) {   // M is 0 past the diagonal
        float4 mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mv[i] = load4(ms + (4 * it + i) * kLdm + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 xv = load4(xs + (j + jj) * P + 4 * pt);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float mval = at(mv[i], jj);
            acc[i][0] = fmaf(mval, xv.x, acc[i][0]);
            acc[i][1] = fmaf(mval, xv.y, acc[i][1]);
            acc[i][2] = fmaf(mval, xv.z, acc[i][2]);
            acc[i][3] = fmaf(mval, xv.w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = s0 + 4 * it + i;
        if (row >= q.s) continue;
        T* yrow = yg + row * q.y_ss + 4 * pt;
#pragma unroll
        for (int c = 0; c < 4; ++c) store(yrow + c, acc[i][c]);
      }
    }
    __syncthreads();  // every read of h_prev is done

    // 4. h = exp(seg_last) h + sum_j w_j x_j (x) B_j over 4 x 4 tiles of (n, p)
    const float dlast = expf(seg[kL - 1]);
    for (int t = tid; t < (N / 4) * (P / 4); t += kThreads) {
      const int nt = t / (P / 4), pt = t % (P / 4);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
      }
      for (int j = 0; j < kL; ++j) {
        const float w = wj[j];
        const float4 bv = load4(bs + j * ldn + 4 * nt);
        float4 xv = load4(xs + j * P + 4 * pt);
        xv.x *= w;
        xv.y *= w;
        xv.z *= w;
        xv.w *= w;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bval = at(bv, i);
          acc[i][0] = fmaf(bval, xv.x, acc[i][0]);
          acc[i][1] = fmaf(bval, xv.y, acc[i][1]);
          acc[i][2] = fmaf(bval, xv.z, acc[i][2]);
          acc[i][3] = fmaf(bval, xv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* hp = reinterpret_cast<float4*>(ht + (4 * nt + i) * P + 4 * pt);
        float4 hv = *hp;
        hv.x = fmaf(hv.x, dlast, acc[i][0]);
        hv.y = fmaf(hv.y, dlast, acc[i][1]);
        hv.z = fmaf(hv.z, dlast, acc[i][2]);
        hv.w = fmaf(hv.w, dlast, acc[i][3]);
        *hp = hv;
      }
    }
  }

  if (q.state != nullptr) {
    __syncthreads();
    float* sg = q.state + static_cast<long long>(b * q.h + h) * P * N;
    for (int e = tid; e < N * P; e += kThreads) {
      const int pp = e >> q.ln, k = e & (N - 1);
      sg[e] = ht[k * P + pp];
    }
  }
}

template <typename T>
cudaError_t launch(const Params& q, int batch, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(q.p, q.n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<batch * q.h, kThreads, smem, stream>>>(q);
  return cudaGetLastError();
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
// contiguous).  dt: float32, base + b*s_b + s*s_s + h*s_h; a_log: float32
// (H,) contiguous; state: null, or float32 (B, H, P, N) contiguous.  h % g
// == 0; p and n in {8, 16, 32, 64, 128}.  Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(
    const void* x, const float* dt, const float* a_log, const void* b,
    const void* c, void* y, float* state, int dtype, int batch, int s, int h,
    int g, int p, int n, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, long long y_sb, long long y_ss, long long y_sh,
    void* stream) {
  const int lp = log2_of(p), ln = log2_of(n);
  if (batch <= 0 || s <= 0 || h <= 0 || g <= 0 || h % g != 0 || lp < 3 ||
      lp > 7 || ln < 3 || ln > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params q{x,    dt,   a_log, b,    c,    y,    state, x_sb, x_ss,
           x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,  c_sb, c_ss,
           c_sg, y_sb, y_ss,  y_sh, h,    g,    s,     p,    n,
           lp,   ln};
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

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
