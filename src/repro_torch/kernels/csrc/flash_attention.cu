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
// that make a fully masked row come out as zeros.  Positions may come in
// any order: nothing below assumes that they are sorted.
//
// Bound on an H100: causal prefill does about 2*S*T*D flops per
// (b, head) (half of 4*S*T*D) against 4*S*D*bytes moved (q, k, v in,
// out back) when S = T: about T/4 flop/byte in bf16.  At the main path's
// buckets (S = T = 64..1024, D = 64) that is at most 256 flop/byte, below
// the 295 flop/byte ridge (989 TFLOP/s bf16 over 3.35 TB/s), so the
// kernel is bound by bytes there; it crosses the ridge only at S = T of
// about 1200.  A call at these sizes moves a few MB and finishes in tens
// of microseconds, so what sets its pace is the latency of each block's
// chain of kv tiles: the longest block (the last query tile) walks
// ceil(T/64) of them one after the other.
//
// bfloat16: tensor cores (wgmma) fed by TMA, one warp-specialised block
// per (b, query head, 64 query rows).  Four consumer warps (one
// warpgroup) own the 64 rows; a fifth, the producer, issues the copies:
//   * TMA loads the Q tile once and K/V tiles of 64 rows into a 2-stage
//     ring in shared memory, with a "full" and an "empty" mbarrier per
//     stage.  q, k and v are (B, S, H, D) with heads interleaved, so each
//     tensor map is 4-d (D, H, S, B) and a box is (D, 1, 64, 1): the head
//     stride lives in the map.  Maps are built on the host per call and
//     passed as __grid_constant__ parameters; cuTensorMapEncodeTiled
//     comes through cudaGetDriverEntryPoint, so the library needs no
//     -lcuda.  TMA writes zeros past the ragged S and T edges; those rows
//     keep position -1, as before.  The swizzle follows the row width:
//     32, 64 or 128 B for D = 16, 32, 64, and two 128 B boxes side by
//     side for D = 128.
//   * The producer reads each K/V tile's positions one tile ahead and
//     skips a tile in which no pair can pass: no valid kv position, its
//     least valid position above the Q tile's largest (causal), or the
//     window excluding all of them.  A tile in which every pair passes is
//     flagged so that it takes no per-element mask.  Both tests use
//     per-tile min/max positions and are conservative: a dead tile they
//     miss costs time, never a result.
//   * S = Q.K^T is wgmma m64n64k16 (bf16 in, fp32 accumulate) with both
//     operands read from shared memory in the swizzle TMA wrote (K-major).
//     The scale D^-1/2 (times log2 e) is applied to the fp32 accumulator,
//     not to bf16 q (it is not a power of two for D = 32).
//   * softcap, the mask and the online softmax work on the accumulator
//     fragments in registers, in the log2 domain so that each exp is one
//     ex2 (a row's max and sum over a quad of lanes).  The softcap and the
//     all-pass flag are tested once a tile and the mask is a select, not
//     a branch: with a branch per score the softmax took most of a tile's
//     time.
//   * O += P.V is wgmma m64nDk16 with P converted to bf16 in registers as
//     the A operand and V read through a transposed (MN-major)
//     descriptor.  Rounding P to bf16 is a deviation from the TPU kernel,
//     which multiplies fp32 P by fp32 V; it stays inside the bf16
//     tolerance (2e-2).  The denominator sums the fp32 P.
//   Grid: ceil(S/64) x Hq x B blocks of 160 threads, the last query tiles
//   (the most kv tiles under a causal mask) first.  At the main path's
//   shapes: stablelm B=1 S=512 Hq=32 gives 256 blocks, hymba S=1024 Hq=25
//   400, and S=128 64; at 41 KB of shared memory and 96 registers (D =
//   64) four fit an SM, so each is one wave on 132 SMs.  64-row tiles,
//   not 128: 128 would halve the blocks and leave SMs idle at S <= 512.
//
// float32: the first version's CUDA-core body, unchanged (bitwise the same
// results).  On the tensor cores fp32 runs as TF32, outside the
// reference's 2e-5/2e-4 fp32 tolerance, and the fp32 smoke models must
// emit the CPU's greedy ids.  One block per (b, head, 64-row query tile)
// walks kv tiles of 64, skipping a tile in which no pair passes the mask;
// q, k, v and the 64x64 score tile sit in shared memory as fp32, scores
// and P.V are FMAs.  The choice is made by dtype at compile time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

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

template <int D>
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
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float* out = static_cast<float*>(p.out);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    float x = 0.f;
    if (s < p.S) {
      x = q[((size_t)(b * p.S + s) * p.Hq + h) * D + d] * p.scale;
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
        kx = k[off];
        vx = v[off];
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
    float* o = out + ((size_t)(b * p.S + s) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) o[cg + 16 * j] = acc[i][j] * inv;
  }
}


// ------------------------------------------------------------------ bf16
// The tensor-core path: TMA + mbarriers + wgmma.

constexpr int kStages = 2;          // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 128;     // one warpgroup: 64 query rows
constexpr int kTcThreads = kConsumers + 32;   // + the producer warp

// Tile geometry by head dim: a TMA box is BOXC columns wide (one swizzle
// row of RB bytes); D = 128 takes two boxes side by side.
template <int D>
struct Geo {
  static constexpr int BOXC = D < 64 ? D : 64;
  static constexpr int NBOX = D / BOXC;
  static constexpr int RB = BOXC * 2;              // 32, 64 or 128 bytes
  static constexpr int BOX_BYTES = 64 * RB;        // 64 rows
  static constexpr int TILE_BYTES = NBOX * BOX_BYTES;   // 64 x D bf16
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr int SWZ = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle TMA_SWZ =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B);
  // shared memory, from a 1024-aligned base: Q, then per stage K and V,
  // then the barriers, each stage's kv positions and its tile flag
  static constexpr int OFF_K = TILE_BYTES;
  static constexpr int OFF_BAR = OFF_K + kStages * 2 * TILE_BYTES;
  static constexpr int OFF_POS = OFF_BAR + 8 * (1 + 2 * kStages);
  static constexpr int OFF_INFO = OFF_POS + kStages * 64 * 4;
  static constexpr int SMEM = OFF_INFO + kStages * 4 + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.  A wait of
// more than about ten seconds traps (the launch then fails) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One 4-d TMA box (D-columns, head, row, batch) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// Q or K (rows x D, D contiguous) as a K-major operand, at k-step kk
// (columns 16kk..16kk+15): 8-row groups RB*8 bytes apart; inside a
// swizzle row the step moves the start address by 32 bytes.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using G = Geo<D>;
  const int col = kk * 16;
  const uint32_t addr =
      tile + (col / G::BOXC) * G::BOX_BYTES + (col % G::BOXC) * 2;
  return desc(addr, 16, 8 * G::RB, G::SWZ);
}

// V (kv rows x D, D contiguous) as the MN-major B operand of P.V, at
// k-step kb (kv rows 16kb..16kb+15): 8-row groups RB*8 bytes apart (the
// stride byte offset), 64-column boxes BOX_BYTES apart (the leading one).
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kb) {
  using G = Geo<D>;
  return desc(tile + kb * 16 * G::RB, G::BOX_BYTES, 8 * G::RB, G::SWZ);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64x64 fp32) = A (64x16, smem) . B (64x16, smem)^T [+ D], both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64x16 fp32) += A (64x16 bf16, registers) . B (16x16, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64x32 fp32) += A (64x16 bf16, registers) . B (16x32, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64x64 fp32) += A (64x16 bf16, registers) . B (16x64, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64x128 fp32) += A (64x16 bf16, registers) . B (16x128, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(o, a, db);
  if constexpr (D == 32) wgmma_rs_n32(o, a, db);
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  if constexpr (D == 128) wgmma_rs_n128(o, a, db);
}

// 2^x in one instruction (flushes denormals; 2^-1e30 is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The positional mask without branches (the CUDA-core body's `allowed`).
__device__ __forceinline__ bool passes(int qp, int kp, int causal,
                                       int window) {
  const int d = qp - kp;
  return (kp >= 0) & ((causal == 0) | (d >= 0)) & ((window < 0) | (d < window));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -kIntMax - 1;

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;    // swizzle-atom aligned
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t sq = base;
  const uint32_t bar_q = base + G::OFF_BAR;
  int* pos_s = reinterpret_cast<int*>(sm + G::OFF_POS);     // [kStages][64]
  int* info_s = reinterpret_cast<int*>(sm + G::OFF_INFO);   // [kStages]
  auto sk = [&](int st) { return base + G::OFF_K + st * 2 * G::TILE_BYTES; };
  auto sv = [&](int st) { return sk(st) + G::TILE_BYTES; };
  auto full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto empty = [&](int st) { return bar_q + 8 * (1 + kStages + st); };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;   // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 32);           // the producer warp's lanes
      mbar_init(empty(st), kConsumers);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      mbar_arrive_tx(bar_q, G::TILE_BYTES);
#pragma unroll
      for (int x = 0; x < G::NBOX; ++x) {
        tma_load(sq + x * G::BOX_BYTES, &tq, x * G::BOXC, h, q0, b, bar_q);
      }
    }
    // the first kv tile's positions (a tile's are read one tile ahead),
    // then the Q tile's least and largest position over its rows < S
    const int ntiles = (p.T + 63) / 64;
    const int* kvp = p.kv_pos + (size_t)b * p.T;
    int kp_next[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      kp_next[i] = lane + 32 * i < p.T ? kvp[lane + 32 * i] : -1;
    }
    int qmin = kIntMax, qmax = kIntMin;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + lane + 32 * i;
      if (r < p.S) {
        const int x = p.q_pos[(size_t)b * p.S + r];
        qmin = min(qmin, x);
        qmax = max(qmax, x);
      }
    }
    qmin = warp_min(qmin);
    qmax = warp_max(qmax);
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * 64;
      int kp[2], vmin = kIntMax, vmax = kIntMin, nbad = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kp[i] = kp_next[i];
        const int tn = k0 + 64 + lane + 32 * i;
        kp_next[i] = tn < p.T ? kvp[tn] : -1;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kp[i] >= 0) {
          vmin = min(vmin, kp[i]);
          vmax = max(vmax, kp[i]);
        } else {
          ++nbad;
        }
      }
      vmin = warp_min(vmin);
      vmax = warp_max(vmax);
      nbad = __reduce_add_sync(0xffffffffu, nbad);
      const bool dead =
          vmin == kIntMax || (p.causal && vmin > qmax) ||
          (p.window >= 0 && (long long)qmin - vmax >= p.window);
      if (dead) continue;          // no (q, kv) pair of the tile passes
      const bool all_pass =
          nbad == 0 && (!p.causal || vmax <= qmin) &&
          (p.window < 0 || (long long)qmax - vmin < p.window);
      mbar_wait(empty(st), phase ^ 1);
      pos_s[st * 64 + lane] = kp[0];
      pos_s[st * 64 + lane + 32] = kp[1];
      if (lane == 0) info_s[st] = all_pass ? 1 : 0;
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_tx(full(st), 2 * G::TILE_BYTES);
#pragma unroll
        for (int x = 0; x < G::NBOX; ++x) {
          tma_load(sk(st) + x * G::BOX_BYTES, &tk, x * G::BOXC, hk, k0, b,
                   full(st));
          tma_load(sv(st) + x * G::BOX_BYTES, &tv, x * G::BOXC, hk, k0, b,
                   full(st));
        }
      } else {
        mbar_arrive(full(st));
      }
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }
    // end of the stream: a stage with no data and flag -1
    mbar_wait(empty(st), phase ^ 1);
    if (lane == 0) info_s[st] = -1;
    __syncwarp();
    mbar_arrive(full(st));
    return;
  }

  // ------------------------------------------------------------ consumers
  // Accumulator fragments: this thread holds rows r0 and r0 + 8 of the
  // 64-row tile, columns 8j + c2 and 8j + c2 + 1 of each 8-column block.
  const int r0 = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  const int qp0 = q0 + r0 < p.S ? p.q_pos[(size_t)b * p.S + q0 + r0] : -1;
  const int qp1 =
      q0 + r0 + 8 < p.S ? p.q_pos[(size_t)b * p.S + q0 + r0 + 8] : -1;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  int st = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(full(st), phase);
    const int info = info_s[st];
    if (info < 0) break;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(s, desc_kmajor<D>(sq, kk), desc_kmajor<D>(sk(st), kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();

    // Scores in the log2 domain (x * log2 e), so that each exp is one ex2.
    // The softcap and the all-pass test are uniform over the block: one
    // branch a tile, none a score.
    if (p.softcap > 0.f) {
      const float cap2 = p.softcap * kLog2e, inv = p.scale / p.softcap;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = cap2 * tanhf(s[i] * inv);
    } else {
      const float scale2 = p.scale * kLog2e;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale2;
    }
    if (!info) {   // a tile with pairs on both sides of the mask
      const int* kps = pos_s + st * 64 + c2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 kv = *reinterpret_cast<const int2*>(kps + 8 * j);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = c ? kv.y : kv.x;
          s[4 * j + c] =
              passes(qp0, kp, p.causal, p.window) ? s[4 * j + c] : kNegInf;
          s[4 * j + 2 + c] = passes(qp1, kp, p.causal, p.window)
                                 ? s[4 * j + 2 + c]
                                 : kNegInf;
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const bool alive0 = mn0 > kNegInf * 0.5f, alive1 = mn1 > kNegInf * 0.5f;
    const float corr0 = alive0 ? ex2(m0 - mn0) : 1.f;
    const float corr1 = alive1 ? ex2(m1 - mn1) : 1.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = alive0 ? ex2(s[4 * j + e] - mn0) : 0.f;
        const float p1 = alive1 ? ex2(s[4 * j + 2 + e] - mn1) : 0.f;
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o_);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o_);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    // P as the bf16 A operand: k-step kb covers kv columns 16kb..16kb+15,
    // which are the accumulator's column blocks 2kb and 2kb + 1
    uint32_t pa[16];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      pa[4 * kb] = pack_bf16(s[8 * kb], s[8 * kb + 1]);
      pa[4 * kb + 1] = pack_bf16(s[8 * kb + 2], s[8 * kb + 3]);
      pa[4 * kb + 2] = pack_bf16(s[8 * kb + 4], s[8 * kb + 5]);
      pa[4 * kb + 3] = pack_bf16(s[8 * kb + 6], s[8 * kb + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      wgmma_pv<D>(o, pa + 4 * kb, desc_mnmajor<D>(sv(st), kb));
    }
    wgmma_commit();
    wgmma_wait0();
    mbar_arrive(empty(st));
    if (++st == kStages) {
      st = 0;
      phase ^= 1;
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s_ = q0 + r0 + 8 * half;
    if (s_ >= p.S) continue;
    const float inv = 1.f / fmaxf(half ? l1 : l0, 1e-30f);
    __nv_bfloat16* row = out + ((size_t)(b * p.S + s_) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c2) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] * inv,
                                o[4 * j + 2 * half + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 4-d map over a (B, L, H, D) bf16 tensor: dims (D, H, L, B), boxes of
// (BOXC, 1, 64, 1); reads past L come back as zeros.
template <int D>
int tensor_map(CUtensorMap* map, const void* ptr, int B, int L, int H) {
  using G = Geo<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::BOXC, 1, 64, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, G::TMA_SWZ,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_tc(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = tensor_map<D>(&tq, p.q, p.B, p.S, p.Hq);
  if (!e) e = tensor_map<D>(&tk, p.k, p.B, p.T, p.Hkv);
  if (!e) e = tensor_map<D>(&tv, p.v, p.B, p.T, p.Hkv);
  if (e) return e;
  const int smem = Geo<D>::SMEM;
  cudaError_t ce = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((p.S + 63) / 64, p.Hq, p.B);
  flash_fwd_tc<D><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.Hq, p.B);
  flash_fwd<D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// bfloat16 on the tensor cores, float32 on the CUDA cores.
int launch_dim(const Params& p, int D, bool bf16, cudaStream_t stream) {
  switch (D) {
    case 16: return bf16 ? launch_tc<16>(p, stream) : launch<16>(p, stream);
    case 32: return bf16 ? launch_tc<32>(p, stream) : launch<32>(p, stream);
    case 64: return bf16 ? launch_tc<64>(p, stream) : launch<64>(p, stream);
    case 128:
      return bf16 ? launch_tc<128>(p, stream) : launch<128>(p, stream);
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
  if (dtype == 0 || dtype == 1) return launch_dim(p, D, dtype == 1, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
