// K4 — the WKV6 (RWKV "Finch") scan with data-dependent decay, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:87
// (`rwkv6_scan`, body `_kernel` at :38, `pl.pallas_call` at :100).
//
// What it computes, per row b and head h, with the (D, D) state S (key
// index i, value index j) and the log-decay lw <= 0:
//   y_t[j]   = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//   S[i, j] <- exp(lw_t[i]) * S[i, j] + k_t[i] * v_t[j]
// y_t reads the state before the update.  All in float32: r, k, v, lw
// (B, S, H, D), u (H, D), s0 (B, H, D, D) -> y (B, S, H, D), s_final
// (B, H, D, D).  The plain version is repro_torch.kernels.ref.rwkv6_scan.
//
// Bound on an H100: bytes.  A call reads r, k, v, lw and writes y once,
// 5 * B*S*H*D * 4 bytes, plus s0 and s_final, 2 * B*H*D*D * 4 bytes
// (rwkv6-7b, H = D = 64, B = 1, S = 512: 44.0 MB, 0.0131 ms at 3.35 TB/s).
// The float work is 5 flops per (t, i, j) (a product and two
// multiply-adds; the u term is folded into one scalar per token): 0.67
// GFLOP at that shape, 0.010 ms at the card's 67 TFLOP/s float32, so the
// bytes set the bound.
//
// Design.  Every value column j of a head's state evolves on its own:
// S[:, j] <- e^{lw} * S[:, j] + k * v_j, and y_j = sum_i r_i S[i, j] +
// v_j * (sum_i r_i u_i k_i).  So the parallel work is B*H*D columns, not
// B*H heads (64 heads would leave half of the 132 SMs idle); the TPU
// kernel's chunked closed form, whose (C, C) pairwise matrix feeds the
// MXU, is not needed.  A lane holds an 8 (rows) x 2 (columns) tile of S
// in registers; kTpc = D / 8 neighbouring lanes share two columns and
// split the rows.  A block covers kCt = min(D, 32) columns of one head:
// grid (D / kCt, H, B), 128 blocks of 128 threads for rwkv6-7b at B = 1.
// Tokens are staged in chunks of kT = 16: r, k, lw of the whole head and
// v of the block's columns are copied into shared memory with 16-byte
// cp.async, double-buffered so the next chunk loads while this one is
// computed; exp(lw) (expf, not __expf) and the per-token bonus
// sum_i r_i u_i k_i are computed once per chunk, before the steps.  Rows
// are interleaved over the lanes in float4 groups, so a lane's r/k/w
// reads are conflict-free 16-byte loads shared with the lanes of the
// other columns.  A step adds this lane's rows to its partial sums of y
// and updates its state; the chunk's 32 partial sums stay in registers
// and are reduced over the kTpc lanes after the chunk's steps (each
// shuffle level halves what a lane holds), so no step waits on a
// shuffle and the unrolled steps overlap.  y is staged per chunk and
// written back coalesced; s0 is read at the start and s_final written at
// the end.
//
// Measured on the H100 (PERF.md): at B = 1 the kernel is latency-bound,
// with one warp per scheduler.  Later work: more warps per SM at B = 1
// (fewer rows a lane), a cluster that shares the staged r/k/w (each block
// stages the whole head, twice over at D = 64), or the chunked closed
// form on tensor cores.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kT = 16;   // tokens staged per chunk
constexpr int kNi = 8;   // state rows a lane holds
constexpr int kCj = 2;   // state columns a lane holds

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
struct Shape {
  static constexpr int kTpc = D / kNi;                  // lanes per column pair
  static constexpr int kCt = D < 32 ? D : 32;           // columns per block
  static constexpr int kActive = (kCt / kCj) * kTpc;    // lanes with columns
  static constexpr int kThreads = kActive < 32 ? 32 : kActive;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kParts = kT * kCj / kTpc;        // sums a lane ends with
  static constexpr int kLevels =                        // log2(kTpc)
      kTpc == 8 ? 3 : (kTpc == 4 ? 2 : (kTpc == 2 ? 1 : 0));
  static_assert(D % kNi == 0, "rows come in float4s");
  static_assert(D % kCt == 0 && kActive % kTpc == 0, "columns tile the head");
  static_assert(kParts >= 1, "a chunk's sums must cover the lanes");
};

template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
    rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ lw,
                      const float* __restrict__ u, const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ s_final,
                      int S, int H) {
  using Sh = Shape<D>;
  constexpr int kTpc = Sh::kTpc, kCt = Sh::kCt;
  constexpr int kThreads = Sh::kThreads;
  constexpr int kRow4 = D / 4;                          // float4s of a row
  constexpr int kV4 = kCt / 4;                          // float4s of v's tile

  __shared__ __align__(16) float r_s[2][kT * D];
  __shared__ __align__(16) float k_s[2][kT * D];
  __shared__ __align__(16) float w_s[2][kT * D];
  __shared__ __align__(16) float v_s[2][kT * kCt];
  __shared__ __align__(16) float y_s[kT * kCt];
  __shared__ float bonus[kT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = blockIdx.x * kCt;                    // first column
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t tok_stride = static_cast<int64_t>(H) * D;   // t -> t + 1
  const int64_t base = b * S * tok_stride + static_cast<int64_t>(h) * D;

  // this lane's state tile: rows (n4 * kTpc + p) * 4 + e, columns
  // col0 + g * kCj + c.  Lanes past kActive mirror group 0 (so every lane
  // of a warp takes part in the shuffles) and write nothing.
  const bool active = tid < Sh::kActive;
  const int g = active ? tid / kTpc : 0;
  const int p = tid % kTpc;
  const int jl = g * kCj;                               // column in the tile
  const int64_t sbase = (b * H + h) * static_cast<int64_t>(D) * D;

  float st[kNi][kCj];
#pragma unroll
  for (int n = 0; n < kNi; ++n) {
    const int i = ((n / 4) * kTpc + p) * 4 + (n % 4);
    const float* src = s0 + sbase + static_cast<int64_t>(i) * D + col0 + jl;
#pragma unroll
    for (int c = 0; c < kCj; ++c) st[n][c] = src[c];
  }
  // u of the rows a lane sums in the bonus pass (i = lane, lane + 32)
  float u_l[(D + 31) / 32];
#pragma unroll
  for (int q = 0; q < (D + 31) / 32; ++q) {
    const int i = lane + 32 * q;
    u_l[q] = i < D ? u[static_cast<int64_t>(h) * D + i] : 0.f;
  }

  const int n_chunks = (S + kT - 1) / kT;
  auto stage = [&](int chunk) {
    const int buf = chunk & 1;
    const int t0 = chunk * kT;
    const int n = S - t0 < kT ? S - t0 : kT;
    for (int idx = tid; idx < n * kRow4; idx += kThreads) {
      const int tt = idx / kRow4, c4 = idx % kRow4;
      const int64_t off = base + (t0 + tt) * tok_stride + c4 * 4;
      cp_async16(&r_s[buf][tt * D + c4 * 4], r + off);
      cp_async16(&k_s[buf][tt * D + c4 * 4], k + off);
      cp_async16(&w_s[buf][tt * D + c4 * 4], lw + off);
    }
    for (int idx = tid; idx < n * kV4; idx += kThreads) {
      const int tt = idx / kV4, c4 = idx % kV4;
      const int64_t off = base + (t0 + tt) * tok_stride + col0 + c4 * 4;
      cp_async16(&v_s[buf][tt * kCt + c4 * 4], v + off);
    }
    cp_async_commit();
  };

  if (n_chunks > 0) stage(0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int buf = chunk & 1;
    const int t0 = chunk * kT;
    const int n = S - t0 < kT ? S - t0 : kT;
    if (chunk + 1 < n_chunks) {
      stage(chunk + 1);    // that buffer's last chunk is done
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // once per (t, i): the decay factor, and per token the u bonus
    for (int idx = tid; idx < n * D; idx += kThreads)
      w_s[buf][idx] = expf(w_s[buf][idx]);
    for (int tt = warp; tt < n; tt += Sh::kWarps) {
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < (D + 31) / 32; ++q) {
        const int i = lane + 32 * q;
        if (i < D)
          part = fmaf(r_s[buf][tt * D + i] * u_l[q], k_s[buf][tt * D + i],
                      part);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) bonus[tt] = part;
    }
    __syncthreads();

    // the chunk's steps: each token's partial sums of y over this lane's
    // rows, from the state before the update, then the update.  The sums
    // stay in registers (acc[tt * kCj + c]) and are reduced over the
    // kTpc lanes after the chunk, so no step waits on a shuffle.
    float acc[kT * kCj];
    auto step = [&](int tt) {
      const float4* r4 = reinterpret_cast<const float4*>(&r_s[buf][tt * D]);
      const float4* k4 = reinterpret_cast<const float4*>(&k_s[buf][tt * D]);
      const float4* w4 = reinterpret_cast<const float4*>(&w_s[buf][tt * D]);
      const float2 vv =
          *reinterpret_cast<const float2*>(&v_s[buf][tt * kCt + jl]);
      const float vc[kCj] = {vv.x, vv.y};
#pragma unroll
      for (int n4 = 0; n4 < kNi / 4; ++n4) {
        const float4 a = r4[n4 * kTpc + p];
        const float4 bk = k4[n4 * kTpc + p];
        const float4 bw = w4[n4 * kTpc + p];
        const float rr[4] = {a.x, a.y, a.z, a.w};
        const float kk[4] = {bk.x, bk.y, bk.z, bk.w};
        const float ww[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int c = 0; c < kCj; ++c) {
            float& s_ = st[n4 * 4 + e][c];
            acc[tt * kCj + c] = fmaf(rr[e], s_, acc[tt * kCj + c]);
            s_ = fmaf(ww[e], s_, kk[e] * vc[c]);
          }
        }
      }
    };
#pragma unroll
    for (int m = 0; m < kT * kCj; ++m) acc[m] = 0.f;
    if (n == kT) {
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) step(tt);
    } else {
#pragma unroll
      for (int tt = 0; tt < kT; ++tt)
        if (tt < n) step(tt);
    }
    // reduce over the kTpc lanes of the column pair, halving the sums a
    // lane holds at each level: lanes with the level's bit set keep the
    // upper half and send the lower.  Lane p ends with the full sums of
    // acc[p * kParts .. p * kParts + kParts).
#pragma unroll
    for (int level = 0; level < Sh::kLevels; ++level) {
      const int lvl = kTpc >> (level + 1);
      const int half = kT * kCj * lvl / kTpc;
      const bool up = (p & lvl) != 0;
      // a constant trip count, so both loops unroll and acc stays in
      // registers
#pragma unroll
      for (int i = 0; i < kT * kCj / 2; ++i) {
        if (i < half) {
          const float keep = up ? acc[i + half] : acc[i];
          const float send = up ? acc[i] : acc[i + half];
          acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, lvl);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < Sh::kParts; ++i) {
        const int m = p * Sh::kParts + i;
        const int tt = m / kCj, c = m % kCj;
        y_s[tt * kCt + jl + c] = fmaf(v_s[buf][tt * kCt + jl + c], bonus[tt],
                                      acc[i]);
      }
    }
    __syncthreads();

    for (int idx = tid; idx < n * kV4; idx += kThreads) {
      const int tt = idx / kV4, c4 = idx % kV4;
      const int64_t off = base + (t0 + tt) * tok_stride + col0 + c4 * 4;
      *reinterpret_cast<float4*>(y + off) =
          *reinterpret_cast<const float4*>(&y_s[tt * kCt + c4 * 4]);
    }
    // y_s, bonus and this chunk's buffers are rewritten only after the
    // next chunk's first __syncthreads
  }

  if (active) {
#pragma unroll
    for (int n = 0; n < kNi; ++n) {
      const int i = ((n / 4) * kTpc + p) * 4 + (n % 4);
      float* dst = s_final + sbase + static_cast<int64_t>(i) * D + col0 + jl;
#pragma unroll
      for (int c = 0; c < kCj; ++c) dst[c] = st[n][c];
    }
  }
}

template <int D>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* lw, const float* u, const float* s0, float* y,
                   float* s_final, int B, int S, int H, cudaStream_t stream) {
  using Sh = Shape<D>;
  const dim3 grid(D / Sh::kCt, static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  rwkv6_scan_kernel<D><<<grid, Sh::kThreads, 0, stream>>>(
      r, k, v, lw, u, s0, y, s_final, S, H);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, lw, y: (B, S, H, D); u: (H, D); s0, s_final: (B, H, D, D); all
// float32, contiguous, 16-byte aligned, on the device of `stream`.
// D must be 8, 16, 32 or 64 (cudaErrorInvalidValue otherwise).  Returns
// the CUDA error of the launch (0 = cudaSuccess); does not synchronise.
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* lw, const void* u, const void* s0,
                                void* y, void* s_final, int B, int S, int H,
                                int D, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(lw);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(s_final);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 8:  err = launch<8>(rf, kf, vf, wf, uf, sf, yf, of, B, S, H, st); break;
    case 16: err = launch<16>(rf, kf, vf, wf, uf, sf, yf, of, B, S, H, st); break;
    case 32: err = launch<32>(rf, kf, vf, wf, uf, sf, yf, of, B, S, H, st); break;
    case 64: err = launch<64>(rf, kf, vf, wf, uf, sf, yf, of, B, S, H, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
