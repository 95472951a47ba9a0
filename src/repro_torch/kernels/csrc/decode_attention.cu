// K2 — flash-decode: one query token per row against a rolling KV cache,
// and K3 — the same against a paged KV pool, sm_90a.
//
// K2 replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:189
// (`decode_attention`, body `_kernel` at :34, `pl.pallas_call` at :214).
// K3 replaces src/repro/kernels/decode_attention.py:132
// (`paged_decode_attention`, body `_paged_kernel` at :77, `pl.pallas_call`
// at :176).
//
// What it computes: out[b, h*G+g, :] = softmax over cache slots t of
// mask(cap(q.k_t * D^-1/2)) . v_t for the G query heads of kv head h,
// with the same positional mask as K1 (pos < 0 = empty slot, causal
// d >= 0, window d < window; slot order does not matter, so a rolling
// buffer needs no reordering), fp32 running max / denominator /
// accumulator and the guards `alive = m_new > NEG_INF/2`,
// `den = max(l, 1e-30)`.
//
// One body, two addressing policies.  Only where slot t of row b lives
// depends on the layout (`Rows::slot`):
//   dense (K2): k/v (B, T, Hkv, D), kv_pos (B, T); slot = b*T + t;
//   paged (K3): k/v pages (P+1, page, Hkv, D), kv_pos_pages (P+1, page),
//     page_tables (B, ppr); T = ppr*page, pg = page_tables[b, t/page],
//     slot = pg*page + t%page.  A short row's table is padded with a null
//     page whose positions are all -1, so its slots are masked like the
//     empty slots of a dense row.
// Everything else (which row group takes which slot, the skip of a masked
// slot, the trip count, the merge) is shared, so K3 on a pool does the
// same float operations in the same order as K2 on the gathered
// contiguous view: the two are bitwise equal, as the TPU kernels are.
// Page ids are not checked on the device: the engine keeps every table
// entry in [0, P].
//
// Bound on an H100: decode is memory-bound.  Each call reads the live
// slots' K and V (2*Hkv*D values per slot) once, plus q, the positions
// and (K3) the page table, and does about 4 flops per value, far below
// the 295 flop/byte ridge, so the floor is those bytes / 3.35 TB/s.
//
// Design: one block per (b, kv head, chunk of up to 8 query heads), so a
// cache row is read once for all the query heads that share it (MHA,
// G = 1, is the common case on the main path; nothing assumes G >= 16).
// The TPU kernel's sequential kv grid axis becomes a loop inside the
// block.  Each cache row is streamed with one 16-byte load per thread
// (D*bytes/16 neighbouring threads per row, so a warp reads several rows
// at once, coalesced); the row's dot product is reduced with warp
// shuffles and every row group keeps its own online-softmax state in
// registers.  A slot that fails the mask is not read at all, so empty
// and future slots of the rolling cache (and null pages) cost no
// bandwidth.  The row groups' partial states are merged through shared
// memory at the end.  With bf16 and D = 64 one loop iteration covers 16
// slots: one page at page_size 16.  Later work: split-K over T (more
// blocks for small B) and, for K3, TMA loads of whole pages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;      // (B, T) dense; (P+1, page) paged
  const int* page_table;  // (B, ppr), paged only
  void* out;
  int B, T, Hq, Hkv;
  int ppr, page;          // paged only: T = ppr * page
  int window;     // < 0: no window
  float softcap;  // <= 0: no softcap
  float scale;
};

// 16-byte vector loads: 4 floats or 8 bfloat16 values, widened to fp32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
  __device__ __forceinline__ static float store_cvt(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 store_cvt(float x) {
    return __float2bfloat16(x);
  }
};

// Where slot t of row b lives: the flat slot index into kv_pos, and
// (times Hkv*D) into k/v.
struct DenseRows {
  __device__ __forceinline__ static size_t slot(const Params& p, int b,
                                                int t) {
    return (size_t)b * p.T + t;
  }
};

struct PagedRows {
  __device__ __forceinline__ static size_t slot(const Params& p, int b,
                                                int t) {
    const int pg = p.page_table[(size_t)b * p.ppr + t / p.page];
    return (size_t)pg * p.page + t % p.page;
  }
};

template <typename T, int D, int GC, typename Rows>
__global__ void __launch_bounds__(kWarps * 32) decode_fwd(Params p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TPR = D / VEC;         // threads per cache row
  constexpr int RPW = 32 / TPR;        // cache rows per warp per step
  constexpr int NGRP = kWarps * RPW;   // row groups per block
  static_assert(TPR >= 1 && TPR <= 32 && 32 % TPR == 0, "bad D");
  __shared__ float sm_m[NGRP][GC];
  __shared__ float sm_l[NGRP][GC];
  __shared__ float sm_acc[NGRP][GC][D];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int sub = lane % TPR;                 // this thread's 16-byte slice
  const int grp = warp * RPW + lane / TPR;    // this thread's row group
  const int G = p.Hq / p.Hkv;
  const int nchunk = (G + GC - 1) / GC;
  const int hk = blockIdx.x / nchunk;
  const int g0 = (blockIdx.x % nchunk) * GC;
  const int b = blockIdx.y;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);

  float qr[GC][VEC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    const int g = g0 + gi;
    if (g < G) {
      Vec<T>::load(q + ((size_t)b * p.Hq + hk * G + g) * D + sub * VEC,
                   qr[gi]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[gi][e] *= p.scale;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[gi][e] = 0.f;
    }
  }
  float m[GC], l[GC], acc[GC][VEC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[gi][e] = 0.f;
  }

  const int qp = p.q_pos[b];
  // Uniform trip count across the block: every lane reaches the shuffles.
  for (int base = 0; base < p.T; base += NGRP) {
    const int t = base + grp;
    bool ok = false;
    size_t slot = 0;
    if (t < p.T) {
      slot = Rows::slot(p, b, t);
      const int kp = p.kv_pos[slot];
      const int d = qp - kp;
      ok = kp >= 0 && d >= 0 && (p.window < 0 || d < p.window);
    }
    float kf[VEC], vf[VEC];
    if (ok) {
      const size_t off = (slot * p.Hkv + hk) * D + sub * VEC;
      Vec<T>::load(k + off, kf);
      Vec<T>::load(v + off, vf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qr[gi][e], kf[e], dot);
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (ok) {
        float s = dot;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        const float m_new = fmaxf(m[gi], s);
        const bool alive = m_new > kNegInf * 0.5f;
        const float pr = alive ? expf(s - m_new) : 0.f;
        const float corr = alive ? expf(m[gi] - m_new) : 1.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[gi][e] = fmaf(acc[gi][e], corr, pr * vf[e]);
        }
        l[gi] = l[gi] * corr + pr;
        m[gi] = m_new;
      }
    }
  }

  // merge the row groups' partial states
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[grp][gi][sub * VEC + e] = acc[gi][e];
    if (sub == 0) {
      sm_m[grp][gi] = m[gi];
      sm_l[grp][gi] = l[gi];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < GC * D; idx += kWarps * 32) {
    const int gi = idx / D, dc = idx % D;
    const int g = g0 + gi;
    if (g >= G) continue;
    float M = kNegInf;
    for (int r = 0; r < NGRP; ++r) M = fmaxf(M, sm_m[r][gi]);
    const bool alive = M > kNegInf * 0.5f;
    float L = 0.f, o = 0.f;
    for (int r = 0; r < NGRP; ++r) {
      const float w = alive ? expf(sm_m[r][gi] - M) : 0.f;
      L = fmaf(sm_l[r][gi], w, L);
      o = fmaf(sm_acc[r][gi][dc], w, o);
    }
    out[((size_t)b * p.Hq + hk * G + g) * D + dc] =
        Vec<T>::store_cvt(o / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, typename Rows>
int launch(const Params& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  int GC = 1;  // query heads per block: the next power of two >= G, <= 8
  while (GC < G && GC < 8) GC *= 2;
  const dim3 grid(p.Hkv * ((G + GC - 1) / GC), p.B);
  const int threads = kWarps * 32;
  switch (GC) {
    case 1: decode_fwd<T, D, 1, Rows><<<grid, threads, 0, stream>>>(p); break;
    case 2: decode_fwd<T, D, 2, Rows><<<grid, threads, 0, stream>>>(p); break;
    case 4: decode_fwd<T, D, 4, Rows><<<grid, threads, 0, stream>>>(p); break;
    default: decode_fwd<T, D, 8, Rows><<<grid, threads, 0, stream>>>(p); break;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename Rows>
int launch_dim(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, Rows>(p, stream);
    case 32: return launch<T, 32, Rows>(p, stream);
    case 64: return launch<T, 64, Rows>(p, stream);
    case 128: return launch<T, 128, Rows>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Rows>
int launch_dtype(const Params& p, int D, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_dim<float, Rows>(p, D, stream);
  if (dtype == 1) return launch_dim<__nv_bfloat16, Rows>(p, D, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each entry point returns
// cudaGetLastError() after the launch (0 on success); the caller raises on
// anything else.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* kv_pos, void* out, int B,
                                      int T, int Hq, int Hkv, int D,
                                      int dtype, int window, float softcap,
                                      float scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.out = out;
  p.B = B;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  return launch_dtype<DenseRows>(p, D, dtype,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* q_pos, const void* kv_pos_pages,
    void* out, int B, int ppr, int page, int Hq, int Hkv, int D, int dtype,
    int window, float softcap, float scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos_pages);
  p.page_table = static_cast<const int*>(page_tables);
  p.out = out;
  p.B = B;
  p.T = ppr * page;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.ppr = ppr;
  p.page = page;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  return launch_dtype<PagedRows>(p, D, dtype,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
