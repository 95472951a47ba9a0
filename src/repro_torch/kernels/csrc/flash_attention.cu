// K1 — blocked online-softmax flash attention for prefill, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:84
// (`flash_attention`, body `_kernel` at :36, `pl.pallas_call` at :114).
//
// What it computes (the reference's `_kernel`, flash_attention.py:55-79):
//   out[b,s,h,:] = softmax_t(mask(cap(q.k_t * D^-1/2))) . v_t
// with query head h reading kv head h / G, the positional mask
//   ok = kv_pos >= 0 && (!causal || d >= 0) && (window < 0 || d < window),
//   d  = q_pos - kv_pos,
// an optional tanh softcap, fp32 running max / denominator / accumulator,
// and the two guards `alive = m_new > NEG_INF/2` and `den = max(l, 1e-30)`
// that make a fully masked row come out as zeros.
//
// Bound on an H100: causal prefill does about 2*S*T*D flops per
// (b, head) (half of 4*S*T*D) against 4*S*D*bytes moved (q, k, v in,
// out back) when S = T: about T/4 flop/byte in bf16.  At the main path's
// buckets (S = T = 64..512, D = 64) that is at most 128 flop/byte, below
// the 295 flop/byte ridge (989 TFLOP/s bf16 over 3.35 TB/s), so the
// kernel is bound by bytes there; it crosses the ridge only at
// S = T of about 1200.  This first version is far from either bound: its
// pace is set by the FMAs it feeds from shared memory (below), so the
// bytes bound is what the later tensor-core version has to approach.
//
// Design (a first version: correct first, fast later): the TPU kernel's sequential
// kv grid axis becomes a loop inside one block.  One block owns a
// (b, head, 64-row query tile) and walks kv tiles of 64; q, k, v and the
// 64x64 score tile sit in shared memory as fp32, scores and P.V are plain
// FMAs on the CUDA cores (no tensor cores yet: that, and wgmma/TMA, is
// later work).  A kv tile in which no (q, kv) pair passes the mask is
// skipped, which removes the causal upper triangle without assuming
// positions are ordered.  Ragged S and T edges are masked in the kernel
// (out-of-range rows read as pos = -1) instead of padded in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  void* out;
  int B, S, T, Hq, Hkv;
  int causal;
  int window;     // < 0: no window
  float softcap;  // <= 0: no softcap
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool allowed(int qp, int kp, int causal,
                                        int window) {
  const int d = qp - kp;
  return kp >= 0 && (!causal || d >= 0) && (window < 0 || d < window);
}

template <int D>
constexpr size_t smem_bytes() {
  // qs, ks: [64][D+1]; vs: [64][D]; ss: [64][65]; m, l, corr: [64];
  // q_pos, kv_pos: [64] ints
  return sizeof(float) * (2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1) +
                          3 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int DP = D + 1;    // padded row stride of the q / k tiles
  constexpr int SP = kBK + 1;  // padded row stride of the score tile
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][DP], pre-scaled by D^-1/2
  float* ks = qs + kBQ * DP;     // [kBK][DP]
  float* vs = ks + kBK * DP;     // [kBK][D]
  float* ss = vs + kBK * D;      // [kBQ][SP] scores, then probabilities
  float* m_s = ss + kBQ * SP;    // [kBQ] running max
  float* l_s = m_s + kBQ;        // [kBQ] running denominator
  float* c_s = l_s + kBQ;        // [kBQ] this tile's rescale factor
  int* qp_s = reinterpret_cast<int*>(c_s + kBQ);  // [kBQ]
  int* kp_s = qp_s + kBQ;                          // [kBK]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    float x = 0.f;
    if (s < p.S) {
      x = to_f(q[((size_t)(b * p.S + s) * p.Hq + h) * D + d]) * p.scale;
    }
    qs[r * DP + d] = x;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    const int s = q0 + r;
    qp_s[r] = s < p.S ? p.q_pos[(size_t)b * p.S + s] : -1;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // This thread's share of the output tile: rows rg + 16 i, columns
  // cg + 16 j (so a warp reads 16 consecutive columns of v).
  const int rg = tid / 16, cg = tid % 16;
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  const int ntiles = (p.T + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < kBK; c += kThreads) {
      const int tt = k0 + c;
      kp_s[c] = tt < p.T ? p.kv_pos[(size_t)b * p.T + tt] : -1;
    }
    __syncthreads();
    int any = 0;
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      any |= allowed(qp_s[i / kBK], kp_s[i % kBK], p.causal, p.window);
    }
    if (!__syncthreads_or(any)) continue;  // fully masked tile: no-op

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int tt = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (tt < p.T) {
        const size_t off = ((size_t)(b * p.T + tt) * p.Hkv + hk) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[c * DP + d] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    // scores: rows rg + 16 i, kv columns cg + 16 j of the 64 x 64 tile
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cg + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg + 16 * i, c = cg + 16 * j;
        float s = sc[i][j];
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        if (!allowed(qp_s[r], kp_s[c], p.causal, p.window)) s = kNegInf;
        ss[r * SP + c] = s;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 columns each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = ss + r * SP + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool alive = m_new > kNegInf * 0.5f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float e = alive ? expf(row[c] - m_new) : 0.f;
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the row has read m_s[r]
      if (part == 0) {
        const float corr = alive ? expf(m_prev - m_new) : 1.f;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[rg + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(rg + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = vs[c * D + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // final l_s is visible to every thread

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    const int s = q0 + r;
    if (s >= p.S) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* o = out + ((size_t)(b * p.S + s) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) o[cg + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.Hq, p.B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the caller raises on anything else.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, const void* q_pos,
                                     const void* kv_pos, void* out, int B,
                                     int S, int T, int Hq, int Hkv, int D,
                                     int dtype, int causal, int window,
                                     float softcap, float scale,
                                     void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.out = out;
  p.B = B;
  p.S = S;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(p, D, st);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(p, D, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
