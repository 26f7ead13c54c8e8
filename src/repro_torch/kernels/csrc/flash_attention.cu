// Flash attention forward: GQA, causal or not, optional sliding window.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention_kernel / flash_attention_pallas
// q (B, Hq, S, D) and k, v (B, Hkv, S, D) give o (B, Hq, S, D) in q's type;
// q head h reads kv head h / (Hq / Hkv).  Scores are scaled by 1/sqrt(D),
// masked (causal: key <= query; window w > 0: key > query - w; keys past S),
// and reduced by an online softmax whose running max, denominator and
// accumulator are float32.  Masked scores take the finite value -1e30 and the
// running max starts there, as in the TPU kernel: a row whose first visited
// tile is fully masked gathers weights that the first real key wipes out
// (alpha = exp(-1e30 - m) = 0), where -inf would give exp(-inf + inf) = NaN.
// The output is acc / max(l, 1e-30).
//
// Design.  The Pallas grid walks kv blocks in order and revisits the output
// tile in VMEM; Hopper's CTAs run in parallel and in no order.  So one CTA
// owns one (batch, q head, 64-row q tile) and loops over 64-key kv tiles
// itself, from the first tile the window can reach to the last one the causal
// mask allows: fully masked tiles are never visited, as the TPU kernel's
// `needed` test skips them.  Heavy (late) causal q tiles are launched first.
// q, k, v are read through their strides (the model hands in transposed
// views of (B, S, H, D) tensors; only D must be contiguous), staged in shared
// memory as float32 (Q and K transposed, V as is), and every product is a
// float32 FMA for float32 and bfloat16 inputs alike: float32 never goes
// through TF32.  The 128 threads form a 16 x 8 grid; a thread owns 4 query
// rows, 8 scores of each and D/8 output columns of each, so a row's max and
// sum are reduced across 8 lanes with shuffles.  P is written over K's
// transposed tile for the P V product.  A ragged last tile is zero-filled and
// masked.  Shared memory: 100 KiB at D = 128, two CTAs an SM.
//
// Bound on an H100.  At the serving path's float32 shape the kernel does
// 4 * D float32 operations per (query, visible key) pair against 16 bytes a
// (row, column) of q, k, v and o: it is bound by operations, at the 67 TFLOP/s
// float32 rate without tensor cores.  In bfloat16 the bound is the bytes
// (989 TFLOP/s of tensor-core math would outrun 3.35 TB/s), which this kernel,
// doing its math on the float32 units, does not approach.
//
// Left for later: wgmma on bf16 tiles, TMA loads with an mbarrier ring, a
// warp-specialised pipeline, and register-level double buffering of tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kBQ = 64;         // query rows a CTA owns
constexpr int kBK = 64;         // keys a kv tile holds
constexpr int kLd = kBQ + 4;    // row stride (floats) of Q^T, K^T and P^T:
                                // float4-aligned, and spreads the banks
constexpr float kNegInf = -1e30f;

static_assert(kBQ == kBK, "P^T reuses K^T's row stride");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int hq, hkv, s, causal, window;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return D * kLd + (D > kBK ? D : kBK) * kLd + kBK * D;
}

// column of score j (0..7) of the thread in column group tx
__device__ __forceinline__ int score_col(int tx, int j) {
  return tx * 4 + (j & 3) + 32 * (j >> 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(Params p) {
  constexpr int kCols = D / 8;                  // output columns a thread owns
  constexpr int kVec = kCols < 4 ? kCols : 4;   // floats a shared load takes
  constexpr int kNv = kCols / kVec;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;                               // [D][kLd]     Q^T
  float* kp = qt + D * kLd;                       // [.][kLd]     K^T, then P^T
  float* vs = kp + (D > kBK ? D : kBK) * kLd;     // [kBK][D]     V

  const int tid = threadIdx.x;
  const int ty = tid >> 3;   // rows ty*4 .. ty*4+3
  const int tx = tid & 7;
  const int b = blockIdx.x / p.hq;
  const int h = blockIdx.x % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int qr = q0 + r;
    qt[d * kLd + r] = qr < p.s ? to_float(qg[qr * p.q_ss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // the kv tiles the mask reaches from this q tile
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.s - 1, q0 + kBQ - 1) : p.s - 1;

  for (int kt = k_lo / kBK; kt <= k_hi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Q^T is staged; the last tile's P^T and V are read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int kc = k0 + c;
      const bool in = kc < p.s;
      kp[d * kLd + c] = in ? to_float(kg[kc * p.k_ss + d]) : 0.f;
      vs[c * D + d] = in ? to_float(vg[kc * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(kp + d * kLd + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(kp + d * kLd + tx * 4 + 32);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + score_col(tx, j);
        bool ok = kj < p.s;
        if (p.causal) ok = ok && kj <= qi;
        if (p.window > 0) ok = ok && kj > qi - p.window;
        sc[i][j] = ok ? sc[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with K^T: write P^T over it
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(kp + score_col(tx, j) * kLd + ty * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(kp + c * kLd + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int n = 0; n < kNv; ++n) {
        const float* vp = vs + c * D + (tx + 8 * n) * kVec;
        float bv[kVec];
        if constexpr (kVec == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vp);
          bv[0] = t.x;
          bv[1] = t.y;
          bv[2] = t.z;
          bv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vp);
          bv[0] = t.x;
          bv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[i][n * kVec + e] = fmaf(av[i], bv[e], acc[i][n * kVec + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.s) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = og + qi * p.o_ss;
#pragma unroll
    for (int n = 0; n < kNv; ++n) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        store(orow + (tx + 8 * n) * kVec + e, acc[i][n * kVec + e] / den);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.hq, (p.s + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: device pointers to float32 (dtype 0) or bfloat16 (dtype 1)
// tensors, each addressed as base + b*s_b + h*s_h + s*s_s + d (strides in
// elements; D contiguous).  q and o have hq heads, k and v hkv, hq % hkv == 0.
// d in {16, 32, 64, 128}; window <= 0 means no sliding window.  Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int batch,
    int hq, int hkv, int s, int d, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,    k,    v,    o,    q_sb, q_sh,  q_ss,   k_sb, k_sh,
           k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,  o_ss,   hq,   hkv,
           s,    causal, window, 0.f};
  // 1/sqrt(D) in double, rounded once, as the reference's Python float is
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_d<float>(p, batch, d, st);
  } else if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(p, batch, d, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
