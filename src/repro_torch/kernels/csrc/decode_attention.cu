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
// Everything else (the split of the slots, which row group takes which
// slot, the skip of a masked slot, the trip count, both merges) is shared
// and depends on T alone, so K3 on a pool does the same float operations
// in the same order as K2 on the gathered contiguous view: the two are
// bitwise equal, as the TPU kernels are.  Page ids are not checked on the
// device: the engine keeps every table entry in [0, P].
//
// Bound on an H100: decode is memory-bound.  Each call reads the live
// slots' K and V (2*Hkv*D values per slot) once, plus q, the positions
// and (K3) the page table, and does about 4 flops per value, far below
// the 295 flop/byte ridge, so the floor is those bytes / 3.35 TB/s.  At
// the main path's sizes (a few MB a call) what sets the pace is how many
// loads are in flight across the card: latency, not the roof.
//
// Design: a unit of work is (b, kv head, chunk of up to 8 query heads), so
// a cache row is read once for all the query heads that share it (MHA,
// G = 1, is the common case; nothing assumes G >= 16).  Each unit's T
// slots are split over a thread-block cluster of C blocks (C in 1, 2, 4,
// 8, chosen by the launcher, `kernels/decode_attention.py`, so that about
// two blocks per SM run while each block keeps >= 128 slots): block r of
// the cluster walks slots [r*span, (r+1)*span), span a multiple of 64
// slots (of every step below, and of page sizes 16, 32 and 64).  Inside a
// block the TPU kernel's sequential kv grid axis is a loop: each cache
// row is streamed with one 16-byte load per thread (D*bytes/16
// neighbouring threads per row, so a warp reads several rows at once,
// coalesced), the row's dot product is reduced with warp shuffles and
// every row group keeps its own online-softmax state in registers.  At
// these sizes the kernel waits on load latency, so steps go in batches of
// four: a batch's K/V loads (raw 16-byte registers) are all issued before
// its arithmetic, and the next batch's slot positions are read while it
// computes.  A slot that fails the mask is not read at all, so empty and
// future slots of the rolling cache (and null pages) cost no bandwidth,
// and a warp skips a step in which none of its slots is live.  A block
// serves the G query heads of its kv head (up to 8, so G > 8 takes
// several chunks); its state is sized for 1, 2, 4, 5 or 8 heads, the
// smallest that holds them, so hymba's G = 5 carries no padding heads'
// registers.  The row groups' partial states are merged through
// shared memory; with C > 1 each block leaves its partial (m, l, acc)
// there and, after a cluster barrier, rank 0 merges the C partials through
// distributed shared memory in rank order and writes the output: one
// launch, no global scratch, a deterministic result.  A block whose range
// holds no live slot contributes m = -1e30, l = 0, acc = 0, and the merge
// keeps the `alive`/`max(l, 1e-30)` guards, so an all-empty row is still
// exactly zero.  With C = 1 (no cluster launch) the output is written as
// before the split, bit for bit.  With bf16 and D = 64 one step covers 16
// slots: one page at page_size 16.

#include <cooperative_groups.h>
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
  int cluster;            // blocks per unit of work (a cluster), 1..8
  int span;               // slots per block of a cluster
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
  using Raw = float4;
  __device__ __forceinline__ static Raw raw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void widen(const Raw& x, float* o) {
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
  __device__ __forceinline__ static void load(const float* p, float* o) {
    widen(raw(p), o);
  }
  __device__ __forceinline__ static float store_cvt(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void widen(const Raw& x, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    widen(raw(p), o);
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

// The position of slot t of row b (and, through `slot`, where it lives),
// or -1 past the block's last slot t1.
template <typename Rows>
__device__ __forceinline__ int position(const Params& p, int b, int t, int t1,
                                        size_t& slot) {
  if (t >= t1) return -1;
  slot = Rows::slot(p, b, t);
  return p.kv_pos[slot];
}

__device__ __forceinline__ bool passes(int qp, int kp, int window) {
  const int d = qp - kp;
  return kp >= 0 && d >= 0 && (window < 0 || d < window);
}

template <typename T, int D, int GC, typename Rows>
__global__ void __launch_bounds__(kWarps * 32) decode_fwd(Params p) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TPR = D / VEC;         // threads per cache row
  constexpr int RPW = 32 / TPR;        // cache rows per warp per step
  constexpr int NGRP = kWarps * RPW;   // row groups per block
  static_assert(TPR >= 1 && TPR <= 32 && 32 % TPR == 0, "bad D");
  static_assert(64 % NGRP == 0, "a split must start on a step");
  using Raw = typename Vec<T>::Raw;
  __shared__ float sm_m[NGRP][GC];
  __shared__ float sm_l[NGRP][GC];
  __shared__ float sm_acc[NGRP][GC][D];
  __shared__ float part_m[GC], part_l[GC], part_acc[GC][D];  // C > 1

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int sub = lane % TPR;                 // this thread's 16-byte slice
  const int grp = warp * RPW + lane / TPR;    // this thread's row group
  const int G = p.Hq / p.Hkv;
  const int nchunk = (G + GC - 1) / GC;
  const int C = p.cluster;
  const int rank = blockIdx.x % C;            // the block's cluster rank
  const int unit = blockIdx.x / C;
  const int hk = unit / nchunk;
  const int g0 = (unit % nchunk) * GC;
  const int b = blockIdx.y;
  const int t0 = min(rank * p.span, p.T);     // this block's slots
  const int t1 = min(t0 + p.span, p.T);
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

  const int heads = min(GC, G - g0);          // live heads of the chunk
  const int qp = p.q_pos[b];
  const size_t koff = (size_t)hk * D + sub * VEC;
  const size_t kstride = (size_t)p.Hkv * D;
  // Steps go in batches of U: a batch's K/V loads are all issued before
  // its arithmetic, and the next batch's slot positions are read while
  // it computes, so a thread keeps up to 2U 16-byte loads in flight.
  constexpr int U = 4;
  int kp[U];
  size_t slot[U] = {};
#pragma unroll
  for (int u = 0; u < U; ++u) {
    kp[u] = position<Rows>(p, b, t0 + u * NGRP + grp, t1, slot[u]);
  }
  // Uniform trip count across the block: every lane reaches the shuffles.
  for (int base = t0; base < t1; base += U * NGRP) {
    bool ok[U];
    Raw kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = passes(qp, kp[u], p.window);
      kr[u] = vr[u] = Raw{};
      if (ok[u]) {
        kr[u] = Vec<T>::raw(k + slot[u] * kstride + koff);
        vr[u] = Vec<T>::raw(v + slot[u] * kstride + koff);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kp[u] = position<Rows>(p, b, base + (U + u) * NGRP + grp, t1, slot[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // A warp whose slots of this step are all masked skips the step (it
      // would change no state); so do the padding heads of a chunk.
      if (!__any_sync(0xffffffffu, ok[u])) continue;
      float kf[VEC], vf[VEC];
      Vec<T>::widen(kr[u], kf);
      Vec<T>::widen(vr[u], vf);
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        if (gi >= heads) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[gi][e], kf[e], dot);
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        }
        if (ok[u]) {
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
    if (C == 1) {
      out[((size_t)b * p.Hq + hk * G + g) * D + dc] =
          Vec<T>::store_cvt(o / fmaxf(L, 1e-30f));
    } else {
      part_acc[gi][dc] = o;
      if (dc == 0) {
        part_m[gi] = M;
        part_l[gi] = L;
      }
    }
  }
  if (C == 1) return;

  // merge the cluster's C partial states on rank 0, in rank order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                     // every partial is in shared memory
  if (rank == 0) {
    for (int idx = tid; idx < GC * D; idx += kWarps * 32) {
      const int gi = idx / D, dc = idx % D;
      const int g = g0 + gi;
      if (g >= G) continue;
      float M = kNegInf;
      for (int r = 0; r < C; ++r) {
        M = fmaxf(M, *cluster.map_shared_rank(&part_m[gi], r));
      }
      const bool alive = M > kNegInf * 0.5f;
      float L = 0.f, o = 0.f;
      for (int r = 0; r < C; ++r) {
        const float w =
            alive ? expf(*cluster.map_shared_rank(&part_m[gi], r) - M) : 0.f;
        L = fmaf(*cluster.map_shared_rank(&part_l[gi], r), w, L);
        o = fmaf(*cluster.map_shared_rank(&part_acc[gi][dc], r), w, o);
      }
      out[((size_t)b * p.Hq + hk * G + g) * D + dc] =
          Vec<T>::store_cvt(o / fmaxf(L, 1e-30f));
    }
  }
  cluster.sync();                     // rank 0 is done reading the others
}

// One launch of the instantiation: a plain grid for C = 1, else clusters
// of C blocks along x.
template <typename T, int D, int GC, typename Rows>
int launch_gc(const Params& p, dim3 grid, cudaStream_t stream) {
  const int threads = kWarps * 32;
  if (p.cluster == 1) {
    decode_fwd<T, D, GC, Rows><<<grid, threads, 0, stream>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_fwd<T, D, GC, Rows>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int D, typename Rows>
int launch(const Params& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  // query heads per block: the smallest instantiated chunk (1, 2, 4, 5 or
  // 8) that holds min(G, 8); 5 is hymba-1.5b's G, where a chunk of 8
  // would hold three padding heads' state in registers
  const int G8 = G < 8 ? G : 8;
  const int GC = G8 == 3 ? 4 : (G8 > 5 ? 8 : G8);
  if (p.cluster < 1 || p.cluster > 8 || (p.cluster & (p.cluster - 1)) ||
      p.span < 1 || (long long)p.cluster * p.span < p.T) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(p.Hkv * ((G + GC - 1) / GC) * p.cluster, p.B);
  switch (GC) {
    case 1: return launch_gc<T, D, 1, Rows>(p, grid, stream);
    case 2: return launch_gc<T, D, 2, Rows>(p, grid, stream);
    case 4: return launch_gc<T, D, 4, Rows>(p, grid, stream);
    case 5: return launch_gc<T, D, 5, Rows>(p, grid, stream);
    default: return launch_gc<T, D, 8, Rows>(p, grid, stream);
  }
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

// dtype: 0 = float32, 1 = bfloat16.  cluster: blocks a unit's slots are
// split over (1, 2, 4 or 8), span: slots per block (cluster * span >= T).
// Each entry point returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* kv_pos, void* out, int B,
                                      int T, int Hq, int Hkv, int D,
                                      int dtype, int window, float softcap,
                                      float scale, int cluster, int span,
                                      void* stream) {
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
  p.cluster = cluster;
  p.span = span;
  return launch_dtype<DenseRows>(p, D, dtype,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* q_pos, const void* kv_pos_pages,
    void* out, int B, int ppr, int page, int Hq, int Hkv, int D, int dtype,
    int window, float softcap, float scale, int cluster, int span,
    void* stream) {
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
  p.cluster = cluster;
  p.span = span;
  return launch_dtype<PagedRows>(p, D, dtype,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
