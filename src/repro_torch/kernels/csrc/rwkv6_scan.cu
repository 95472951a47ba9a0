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
// multiply-adds): 0.67 GFLOP at that shape, 0.010 ms at the card's 67
// TFLOP/s float32, so the bytes set the bound.
//
// Layout of the work.  Every value column j of a head's state evolves on
// its own, so a lane holds an 8 (rows) x 2 (columns) tile of S in
// registers; kTpc = D / 8 neighbouring lanes share two columns and split
// the rows, and a block covers kCt = min(D, 32) columns of one head.  A
// unit of work is one (b, h, column tile), one block of 4 warps: grid
// (D / kCt, H, B).  At the main path's shapes (rwkv6-7b, B = 1 and 2)
// that is 128 or 256 blocks, one wave on the 132 SMs (two blocks fit an
// SM).
//
// What held the first version back (0.115 ms at B = 1, S = 512, 11 % of
// its bound): each 16-token chunk ran its phases in turn (wait for a
// copy prefetched one chunk ahead, an exp pass, a bonus pass of warp
// shuffles, the steps, a lane reduction whose partial sums went through
// local memory, a staged write of y) between three block barriers, with
// one warp per scheduler to hide each latency.
//
// The redesign, and what each part does about that: a 3-stage ring of
// 16-byte cp.async copies, issued two chunks ahead.  One prep pass a
// chunk, one (token, row group) a thread, computes exp(lw) in place
// (expf, not __expf: the strongest decay, lw = -e^10, must give exact
// zeros where the state dies) and the token's bonus partial
// sum_i r_i u_i k_i over the row group; a lane adds v_j times its group's
// partial to its partial sums of y, so the bonus rides the lane reduction
// (no shuffle pass of its own).  The reduction swaps register values,
// never indexes them at run time, so no partial sum goes to local memory;
// each lane then writes its tokens x two columns of y straight from
// registers (whole 32-byte sectors a warp), so y is not staged.  Two
// block barriers a chunk remain (chunk landed -> prep; prep -> steps),
// down from three.  Up to 255 registers a thread (two blocks an SM), so
// nothing spills.  The state update is the first version's, in the same
// order, so s_final is bitwise equal to it; y is not (the bonus is summed
// per row group before the lane reduction): it is held to the
// reference's WKV tolerance against the plain version.
//
// Not kept: splitting the time axis over a thread-block cluster (spans
// run from a zero state, then each folded into the next through
// distributed shared memory).  One block of four warps already takes most
// of what an SM issues for this loop, so at rwkv6-7b's 128 units the
// split's extra state-only pass ran 1.4-1.9x slower than one block a unit
// (PERF.md section 6); it won only with a few heads, which no
// configuration of the repo has.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kT = 16;       // tokens staged per chunk
constexpr int kNi = 8;       // state rows a lane holds
constexpr int kCj = 2;       // state columns a lane holds
constexpr int kStages = 3;   // chunks in the copy ring

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
  static constexpr int kPrep = kT * kTpc;               // (token, row group)s
  static constexpr int kParts = kT * kCj / kTpc;        // sums a lane ends with
  static constexpr int kLevels =                        // log2(kTpc)
      kTpc == 8 ? 3 : (kTpc == 4 ? 2 : (kTpc == 2 ? 1 : 0));
  static_assert(D % kNi == 0, "rows come in float4s");
  static_assert(D % kCt == 0 && kActive % kTpc == 0, "columns tile the head");
  static_assert(kPrep <= kThreads, "one prep thread per (token, row group)");
  static_assert(kParts >= kCj && kParts % kCj == 0,
                "a lane ends with whole column pairs");
};

// The copy ring: kStages chunks in flight.
template <int D>
struct Ring {
  float r[kStages][kT * D];
  float k[kStages][kT * D];
  float w[kStages][kT * D];                       // lw, then exp(lw)
  float v[kStages][kT * Shape<D>::kCt];
  float bonus[kStages][kT * Shape<D>::kTpc];      // per (token, row group)
};

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;
  float* y;
  float* s_final;
  int S, H;
};

// What a thread needs to run its unit's tokens.
template <int D>
struct Lane {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  float* y;
  Ring<D>* rg;
  const float* u_s;
  int64_t base;          // offset of (b, token 0, h, 0) in r/k/v/lw/y
  int64_t tok_stride;    // t -> t + 1
  int col0;              // first column of the block's tile
  int tid;
  int p;                 // row group: rows ((n4 * kTpc + p) * 4 + e)
  int jl;                // first of the lane's two columns in the tile
  bool active;           // lanes past kActive mirror group 0, write nothing
};

// Runs tokens [0, S) of the lane's unit through the recurrence on the
// lane's state tile `st`, writing y.
template <int D>
__device__ __forceinline__ void run_tokens(const Lane<D>& ln, int S,
                                           float (&st)[kNi][kCj]) {
  using Sh = Shape<D>;
  constexpr int kTpc = Sh::kTpc, kCt = Sh::kCt, kThreads = Sh::kThreads;
  constexpr int kRow4 = D / 4;                          // float4s of a row
  constexpr int kV4 = kCt / 4;                          // float4s of v's tile
  Ring<D>& rg = *ln.rg;
  const int tid = ln.tid;
  const int n_chunks = (S + kT - 1) / kT;

  auto tokens = [&](int chunk) {
    const int left = S - chunk * kT;
    return left < kT ? left : kT;
  };
  // issue the copies of a chunk into its ring slot; always commits a
  // group, so the wait counts below hold past the end
  auto stage = [&](int chunk) {
    if (chunk < n_chunks) {
      const int buf = chunk % kStages;
      const int t0 = chunk * kT;
      const int n = tokens(chunk);
      for (int idx = tid; idx < n * kRow4; idx += kThreads) {
        const int tt = idx / kRow4, c4 = idx % kRow4;
        const int64_t off = ln.base + (t0 + tt) * ln.tok_stride + c4 * 4;
        const int at = tt * D + c4 * 4;
        cp_async16(&rg.r[buf][at], ln.r + off);
        cp_async16(&rg.k[buf][at], ln.k + off);
        cp_async16(&rg.w[buf][at], ln.lw + off);
      }
      for (int idx = tid; idx < n * kV4; idx += kThreads) {
        const int tt = idx / kV4, c4 = idx % kV4;
        const int64_t off =
            ln.base + (t0 + tt) * ln.tok_stride + ln.col0 + c4 * 4;
        cp_async16(&rg.v[buf][tt * kCt + c4 * 4], ln.v + off);
      }
    }
    cp_async_commit();
  };
  // once per (token, row group) of a landed chunk, one a thread: e^{lw}
  // in place and the bonus partial
  auto prep = [&](int chunk) {
    if (chunk >= n_chunks || tid >= Sh::kPrep) return;
    const int buf = chunk % kStages;
    const int tt = tid / kTpc, q = tid % kTpc;
    if (tt >= tokens(chunk)) return;
    float4* w4 = reinterpret_cast<float4*>(&rg.w[buf][tt * D]);
    const float4* r4 = reinterpret_cast<const float4*>(&rg.r[buf][tt * D]);
    const float4* k4 = reinterpret_cast<const float4*>(&rg.k[buf][tt * D]);
    const float4* u4 = reinterpret_cast<const float4*>(ln.u_s);
    float part = 0.f;
#pragma unroll
    for (int n4 = 0; n4 < kNi / 4; ++n4) {
      const int f = n4 * kTpc + q;
      float4 x = w4[f];
      x.x = expf(x.x);
      x.y = expf(x.y);
      x.z = expf(x.z);
      x.w = expf(x.w);
      w4[f] = x;
      const float4 a = r4[f], b = k4[f], c = u4[f];
      part = fmaf(a.x * c.x, b.x, part);
      part = fmaf(a.y * c.y, b.y, part);
      part = fmaf(a.z * c.z, b.z, part);
      part = fmaf(a.w * c.w, b.w, part);
    }
    rg.bonus[buf][tt * kTpc + q] = part;
  };
  // one token's step: adds this lane's rows (and its row group's bonus
  // partial) to the token's partial sums of y, from the state before the
  // update; then the update
  auto step = [&](int buf, int tt, float* acc) {
    const float4* r4 = reinterpret_cast<const float4*>(&rg.r[buf][tt * D]);
    const float4* k4 = reinterpret_cast<const float4*>(&rg.k[buf][tt * D]);
    const float4* w4 = reinterpret_cast<const float4*>(&rg.w[buf][tt * D]);
    const float2 vv =
        *reinterpret_cast<const float2*>(&rg.v[buf][tt * kCt + ln.jl]);
    const float vc[kCj] = {vv.x, vv.y};
    const float bq = rg.bonus[buf][tt * kTpc + ln.p];
#pragma unroll
    for (int c = 0; c < kCj; ++c) acc[c] = vc[c] * bq;
#pragma unroll
    for (int n4 = 0; n4 < kNi / 4; ++n4) {
      const float4 bk = k4[n4 * kTpc + ln.p];
      const float4 bw = w4[n4 * kTpc + ln.p];
      const float kk[4] = {bk.x, bk.y, bk.z, bk.w};
      const float ww[4] = {bw.x, bw.y, bw.z, bw.w};
      const float4 a = r4[n4 * kTpc + ln.p];
      const float rr[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < kCj; ++c) {
          float& s_ = st[n4 * 4 + e][c];
          acc[c] = fmaf(rr[e], s_, acc[c]);
          s_ = fmaf(ww[e], s_, kk[e] * vc[c]);
        }
      }
    }
  };
  // the chunk's steps; their partial sums stay in registers and are
  // reduced over the kTpc lanes of the column pair after the chunk
  // (each shuffle level halves what a lane holds, so no step waits on a
  // shuffle) and written out
  auto steps = [&](int chunk) {
    const int buf = chunk % kStages;
    const int n = tokens(chunk);
    float acc[kT * kCj];
    if (n == kT) {
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) step(buf, tt, &acc[tt * kCj]);
    } else {
#pragma unroll
      for (int m = 0; m < kT * kCj; ++m) acc[m] = 0.f;
#pragma unroll
      for (int tt = 0; tt < kT; ++tt)
        if (tt < n) step(buf, tt, &acc[tt * kCj]);
    }
    // lanes with the level's bit set keep the upper half and send the
    // lower; both values are read before the swap, so it selects
    // registers and acc is never indexed by a runtime value (which
    // would put it in local memory).  Lane p ends with the sums of
    // acc[p * kParts .. p * kParts + kParts).
#pragma unroll
    for (int level = 0; level < Sh::kLevels; ++level) {
      const int lvl = kTpc >> (level + 1);
      const int half = kT * kCj * lvl / kTpc;
      const bool up = (ln.p & lvl) != 0;
#pragma unroll
      for (int i = 0; i < kT * kCj / 2; ++i) {
        if (i < half) {
          float keep = acc[i], send = acc[i + half];
          if (up) {
            const float t = keep;
            keep = send;
            send = t;
          }
          acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, lvl);
        }
      }
    }
    if (ln.active) {
      const int t0 = chunk * kT;
#pragma unroll
      for (int i = 0; i < Sh::kParts; i += kCj) {
        const int tt = (ln.p * Sh::kParts + i) / kCj;
        if (tt < n) {
          float* dst = ln.y + ln.base + (t0 + tt) * ln.tok_stride +
                       ln.col0 + ln.jl;
          *reinterpret_cast<float2*>(dst) = make_float2(acc[i], acc[i + 1]);
        }
      }
    }
  };

  // the ring: chunk c + 2 is issued while chunk c is computed; a chunk's
  // prep runs once it has landed, and its steps after the prep
  stage(0);
  stage(1);
  cp_async_wait<1>();
  __syncthreads();
  prep(0);
  __syncthreads();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    stage(chunk + 2);      // that slot's last chunk (c - 1) is done
    steps(chunk);
    cp_async_wait<1>();    // chunk c + 1 has landed (c + 2 may not)
    __syncthreads();
    prep(chunk + 1);
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads, 2)
    rwkv6_scan_kernel(const Params prm) {
  using Sh = Shape<D>;
  constexpr int kTpc = Sh::kTpc, kCt = Sh::kCt, kThreads = Sh::kThreads;
  __shared__ __align__(16) Ring<D> rg;
  __shared__ __align__(16) float u_s[D];

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  Lane<D> ln;
  ln.r = prm.r;
  ln.k = prm.k;
  ln.v = prm.v;
  ln.lw = prm.lw;
  ln.y = prm.y;
  ln.rg = &rg;
  ln.u_s = u_s;
  ln.tok_stride = static_cast<int64_t>(prm.H) * D;
  ln.base = b * prm.S * ln.tok_stride + static_cast<int64_t>(h) * D;
  ln.col0 = blockIdx.x * kCt;
  ln.tid = tid;
  ln.active = tid < Sh::kActive;
  ln.p = tid % kTpc;
  ln.jl = (ln.active ? tid / kTpc : 0) * kCj;
  const int64_t sbase = (b * prm.H + h) * static_cast<int64_t>(D) * D;
  auto row = [&](int nn) { return ((nn / 4) * kTpc + ln.p) * 4 + (nn % 4); };

  for (int i = tid; i < D; i += kThreads)
    u_s[i] = prm.u[static_cast<int64_t>(h) * D + i];
  float st[kNi][kCj];
#pragma unroll
  for (int nn = 0; nn < kNi; ++nn) {
    const float2 x = *reinterpret_cast<const float2*>(
        prm.s0 + sbase + static_cast<int64_t>(row(nn)) * D + ln.col0 + ln.jl);
    st[nn][0] = x.x;
    st[nn][1] = x.y;
  }
  __syncthreads();                                      // u_s

  run_tokens<D>(ln, prm.S, st);

  if (ln.active) {
#pragma unroll
    for (int nn = 0; nn < kNi; ++nn)
      *reinterpret_cast<float2*>(
          prm.s_final + sbase + static_cast<int64_t>(row(nn)) * D +
          ln.col0 + ln.jl) = make_float2(st[nn][0], st[nn][1]);
  }
}

template <int D>
cudaError_t launch(const Params& prm, int B, cudaStream_t stream) {
  using Sh = Shape<D>;
  const dim3 grid(D / Sh::kCt, static_cast<unsigned>(prm.H),
                  static_cast<unsigned>(B));
  rwkv6_scan_kernel<D><<<grid, Sh::kThreads, 0, stream>>>(prm);
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
  Params prm;
  prm.r = static_cast<const float*>(r);
  prm.k = static_cast<const float*>(k);
  prm.v = static_cast<const float*>(v);
  prm.lw = static_cast<const float*>(lw);
  prm.u = static_cast<const float*>(u);
  prm.s0 = static_cast<const float*>(s0);
  prm.y = static_cast<float*>(y);
  prm.s_final = static_cast<float*>(s_final);
  prm.S = S;
  prm.H = H;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 8:  err = launch<8>(prm, B, st); break;
    case 16: err = launch<16>(prm, B, st); break;
    case 32: err = launch<32>(prm, B, st); break;
    case 64: err = launch<64>(prm, B, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
