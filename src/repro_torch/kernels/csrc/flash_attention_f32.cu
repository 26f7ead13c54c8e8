// Flash attention forward in float32 on the float32 units (no TF32).
//
// Replaces, for float32 inputs, the TPU kernel in
// src/repro/kernels/flash_attention.py: flash_attention_kernel /
// flash_attention_pallas; the serving path runs this route.  q (B, Hq, S, D)
// and k, v (B, Hkv, S, D) give o (B, Hq, S, D) in float32; q head h reads kv
// head h / (Hq / Hkv).  Scores are scaled by 1/sqrt(D) and masked (causal:
// key <= query; window w > 0: key > query - w; keys past S).  The online
// softmax keeps its running max, denominator and accumulator in float32.
// Masked scores take the finite value -1e30 and the running max starts
// there, as in the TPU kernel: a row whose first visited tile is fully masked
// gathers weights that the first real key wipes out (alpha = exp(-1e30 - m)
// = 0), where -inf would give exp(-inf + inf) = NaN.  o = acc / max(l, 1e-30).
//
// Bound on an H100.  4 * D operations a visible (query, key) pair against
// 16 bytes a (row, column) of q, k, v and o: bound by operations, at the
// 67 TFLOP/s float32 rate without tensor cores (0.513 ms at the serving
// shape (8, 16, 1024, 128) causal).  Every product here is a float32 FMA:
// TF32 would keep ten bits of mantissa, and the route's tolerance is 2e-5.
//
// Design.  One CTA of 256 threads owns a 128-row q tile of one (batch, q
// head); heavy (late) causal q tiles launch first.  It loops over the 64-key
// kv tiles the mask reaches, as the TPU kernel's `needed` test does.
//  - Q is staged once, transposed (Q^T [D][128]).  K and V go through a
//    2-stage ring of 16-byte cp.async copies straight from global memory
//    (rows past S are zero-filled): the next tile's copy is issued right
//    after the one block-wide barrier of a tile and lands while the current
//    tile's FMAs run.
//  - The threads form a 16 x 16 grid (ty, tx).  A thread owns the query rows
//    8 ty .. 8 ty + 7, the keys tx + 16 j (j < 4) of each tile, and the
//    output columns (tx + 16 n) * V + e (V = min(D / 16, 4)); a row's max and
//    sum are reduced over the 16 lanes of a half-warp.  S = Q K^T reads two
//    float4 of Q^T and one of each of its four K rows per 4 d: 128 FMAs for
//    12 shared loads of 16 bytes (2.7 FMAs a float).  P V reads P^T and V
//    as float4: 8 D/16 FMAs a key for 2 + D/64 loads (64 for 4 at D = 128,
//    4 FMAs a float).  (An 8 x 8 score tile over half of D, with the halves
//    added by a shuffle, loads a float per 4 FMAs but ran slower on the
//    card, and so did 512 threads of 4 rows: shared-memory bandwidth is not
//    what bounds these loops.)
//  - P goes to a buffer private to each warp (P^T [64][16]), so only a
//    __syncwarp separates its writes from its reads.
//  - Layouts: K rows are padded to D + 4 floats, so the 8 rows a quarter-warp
//    reads land on 8 distinct groups of 4 banks; Q^T is written by 32 lanes
//    on 32 consecutive rows and read as a broadcast of 16 contiguous floats;
//    V and P^T are read as broadcasts of contiguous float4.
// Shared memory at D = 128: Q^T 64 KiB + 2 stages x (K 33 + V 32) KiB + P^T
// 32 KiB = 226 KiB, one CTA (8 warps) an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>

#include "flash_attention_host.cuh"

namespace {

constexpr int kThreads = 256;   // kBQ / kRows row groups x 16 column groups
constexpr int kBQ = 128;        // query rows a CTA owns
constexpr int kBK = 64;         // keys a kv tile holds
constexpr int kKeys = kBK / 16; // keys of a tile a thread owns
constexpr int kRows = kBQ * 16 / kThreads;   // query rows a thread owns
static_assert(kRows % 4 == 0, "rows are read from shared memory as float4");
constexpr int kStages = 2;      // K/V ring depth
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {
  static constexpr int kLdK = D + 4;                    // K row stride
  static constexpr int kQ = D * kBQ;                    // Q^T
  static constexpr int kK = kBK * kLdK;                 // one K stage
  static constexpr int kV = kBK * D;                    // one V stage
  static constexpr int kP = kBK * 2 * kRows;            // one warp's P^T
  static constexpr int kFloats = kQ + kStages * (kK + kV) + kWarps * kP;
  static constexpr int kBytes = kFloats * 4;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int hq, hkv, s, causal, window;
  float scale;
};

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// issue the copies of kv tile k0 into one stage
template <int D>
__device__ __forceinline__ void load_kv(float* ks, float* vs, const float* kg,
                                        const float* vg, const Params& p,
                                        int k0) {
  constexpr int kChunks = D / 4;   // 16-byte pieces a row
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * 4;
    const int key = k0 + row;
    const bool in = key < p.s;
    const long long r = in ? key : 0;
    cp_async16(ks + row * Smem<D>::kLdK + col, kg + r * p.k_ss + col, in);
    cp_async16(vs + row * D + col, vg + r * p.v_ss + col, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_kernel(const Params p) {
  using L = Smem<D>;
  constexpr int kCols = D / 16;                 // output columns a thread owns
  constexpr int kVec = kCols < 4 ? kCols : 4;   // floats a V load takes
  constexpr int kNv = kCols / kVec;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;                                  // [D][kBQ]
  float* ks = qt + L::kQ;                            // [kStages][kBK][kLdK]
  float* vs = ks + kStages * L::kK;                  // [kStages][kBK][D]
  float* pw = vs + kStages * L::kV + (threadIdx.x / 32) * L::kP;
                                                 // [kBK][2 kRows]

  const int tid = threadIdx.x;
  const int ty = tid / 16;   // rows kRows ty .. kRows ty + kRows - 1
  const int tx = tid % 16;
  const int half = ty % 2;   // this thread's rows in its warp's P^T
  const int b = blockIdx.x / p.hq;
  const int h = blockIdx.x % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heavy tiles first

  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh;
  float* og = p.o + b * p.o_sb + h * p.o_sh;

  // the kv tiles the mask reaches from this q tile
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.s - 1, q0 + kBQ - 1) : p.s - 1;
  const int t_lo = k_lo / kBK;
  const int n_tiles = k_hi / kBK - t_lo + 1;

  load_kv<D>(ks, vs, kg, vg, p, t_lo * kBK);
  cp_async_commit();

  // Q^T: lanes on consecutive rows, so the transposed stores hit 32 banks
  for (int e = tid; e < kBQ * D / 4; e += kThreads) {
    const int r = e % kBQ;
    const int d = (e / kBQ) * 4;
    const int qr = q0 + r;
    const float4 x = qr < p.s
        ? *reinterpret_cast<const float4*>(qg + qr * p.q_ss + d)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    qt[(d + 0) * kBQ + r] = x.x;
    qt[(d + 1) * kBQ + r] = x.y;
    qt[(d + 2) * kBQ + r] = x.z;
    qt[(d + 3) * kBQ + r] = x.w;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;   // this thread's part of the row's sum
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = (t_lo + it) * kBK;
    cp_async_wait_all();
    // tile it has landed for every thread (and Q^T is staged); every thread
    // is done with tile it - 1, whose stage the next copy overwrites
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_kv<D>(ks + (1 - st) * L::kK, vs + (1 - st) * L::kV, kg, vg, p,
                 k0 + kBK);
    }
    cp_async_commit();
    const float* kt = ks + st * L::kK;
    const float* vt = vs + st * L::kV;

    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int dc = 0; dc < D; dc += 4) {
      float4 kv[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * L::kLdK +
                                                 dc);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float* qp = qt + (dc + x) * kBQ + ty * kRows;
        float qv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; r += 4) {
          const float4 t = *reinterpret_cast<const float4*>(qp + r);
          qv[r] = t.x;
          qv[r + 1] = t.y;
          qv[r + 2] = t.z;
          qv[r + 3] = t.w;
        }
        float kx[kKeys];
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          kx[j] = x == 0 ? kv[j].x : x == 1 ? kv[j].y : x == 2 ? kv[j].z
                                                               : kv[j].w;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int j = 0; j < kKeys; ++j) {
            sc[i][j] = fmaf(qv[i], kx[j], sc[i][j]);
          }
        }
      }
    }

    const bool edge = k0 + kBK > p.s || (p.causal && k0 + kBK - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + kBQ - 1 - p.window);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float x = sc[i][j] * p.scale;
        if (edge) {
          const int kj = k0 + tx + 16 * j;
          bool ok = kj < p.s;
          if (p.causal) ok = ok && kj <= qi;
          if (p.window > 0) ok = ok && kj > qi - p.window;
          x = ok ? x : kNegInf;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

    // P^T of this warp's 16 rows; the previous tile's reads of it ended
    // before the block barrier above
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float* dst = pw + (tx + 16 * j) * 2 * kRows + half * kRows;
#pragma unroll
      for (int r = 0; r < kRows; r += 4) {
        *reinterpret_cast<float4*>(dst + r) = make_float4(
            sc[r][j], sc[r + 1][j], sc[r + 2][j], sc[r + 3][j]);
      }
    }
    __syncwarp();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      const float* pp = pw + c * 2 * kRows + half * kRows;
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; r += 4) {
        const float4 t = *reinterpret_cast<const float4*>(pp + r);
        pv[r] = t.x;
        pv[r + 1] = t.y;
        pv[r + 2] = t.z;
        pv[r + 3] = t.w;
      }
#pragma unroll
      for (int n = 0; n < kNv; ++n) {
        const float* vp = vt + c * D + (tx + 16 * n) * kVec;
        float bv[kVec];
        if constexpr (kVec == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vp);
          bv[0] = t.x;
          bv[1] = t.y;
          bv[2] = t.z;
          bv[3] = t.w;
        } else if constexpr (kVec == 2) {
          const float2 t = *reinterpret_cast<const float2*>(vp);
          bv[0] = t.x;
          bv[1] = t.y;
        } else {
          bv[0] = *vp;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[i][n * kVec + e] = fmaf(pv[i], bv[e], acc[i][n * kVec + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float den = l[i];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den += __shfl_xor_sync(0xffffffffu, den, 4);
    den += __shfl_xor_sync(0xffffffffu, den, 8);
    den = fmaxf(den, 1e-30f);
    const int qi = q0 + ty * kRows + i;
    if (qi >= p.s) continue;
    float* orow = og + qi * p.o_ss;
#pragma unroll
    for (int n = 0; n < kNv; ++n) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        orow[(tx + 16 * n) * kVec + e] = acc[i][n * kVec + e] / den;
      }
    }
  }
}

// the dynamic shared-memory limit, raised once per instantiation and device
template <int D>
cudaError_t allow_smem() {
  static std::atomic<bool> done[flash_host::kMaxDevices];
  return flash_host::allow_smem(
      reinterpret_cast<const void*>(&flash_f32_kernel<D>), Smem<D>::kBytes,
      done);
}

template <int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * p.hq, (p.s + kBQ - 1) / kBQ);
  flash_f32_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr, long long sb, long long sh, long long ss) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 &&
         sh % 4 == 0 && ss % 4 == 0;
}

template <int D>
int occupancy(int* out) {
  const cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return flash_host::occupancy(
      reinterpret_cast<const void*>(&flash_f32_kernel<D>), kThreads,
      Smem<D>::kBytes, out);
}

}  // namespace

// q, k, v, o: device pointers to float32 tensors, each addressed as
// base + b*s_b + h*s_h + s*s_s + d (strides in elements; D contiguous).
// q, k and v are read in 16-byte pieces: their bases must be 16-byte aligned
// and their strides multiples of 4 elements.  q and o have hq heads, k and v
// hkv, hq % hkv == 0; d in {16, 32, 64, 128}; window <= 0 means no sliding
// window.  Launches on `stream`; returns 0 or a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int s, int d, int causal, int window, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || s <= 0 ||
      (s + kBQ - 1) / kBQ > 65535 ||
      !aligned16(q, q_sb, q_sh, q_ss) || !aligned16(k, k_sb, k_sh, k_ss) ||
      !aligned16(v, v_sb, v_sh, v_ss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(o),
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, hq, hkv, s, causal, window, 0.f};
  // 1/sqrt(D) in double, rounded once, as the reference's Python float is
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(p, batch, st);
    case 32: return launch<32>(p, batch, st);
    case 64: return launch<64>(p, batch, st);
    case 128: return launch<128>(p, batch, st);
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
