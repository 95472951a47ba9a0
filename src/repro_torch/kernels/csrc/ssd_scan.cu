// K5 — the selective-SSM diagonal scan, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:58
// (`ssd_scan`, body `_kernel` at :27, `pl.pallas_call` at :79).
//
// What it computes: for every channel c = (i, n) of every row b,
//   h_t = a[b, t, c] * h_{t-1} + b[b, t, c],   h_{-1} = h0[b, c],
// and writes every h_t to hs[b, t, c] and the last one to h_final[b, c].
// All in float32: a, b (B, S, I, N), h0 (B, I, N) -> hs (B, S, I, N),
// h_final (B, I, N).  The product and the sum round separately
// (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version
// (`repro_torch.kernels.ref.ssd_scan`, two tensor operations a step)
// does, so the two agree bit for bit.
//
// Bound on an H100: bytes.  Each call reads a and b and writes hs once,
// 3 * B*S*I*N * 4 bytes, plus h0 and h_final, and does 2 flops per
// element: far below any compute roof, so the floor is those bytes over
// 3.35 TB/s (hymba-1.5b, I*N = 51,200 channels: 315 MB, 0.094 ms, at
// B = 1, S = 512).
//
// Design: the recurrence is independent per channel, so one thread owns
// one channel of one row and walks t = 0..S-1 with its state in a
// register; the TPU kernel's in-VMEM associative scan over 128-step
// chunks is not needed when every channel has its own thread.  Neighbouring
// threads own neighbouring channels, so every load of a[b, t, :] and
// b[b, t, :] and every store of hs[b, t, :] is one coalesced 128-byte
// line per warp.  The time loop is unrolled by kUnroll: the loads of the
// next kUnroll steps are issued together, ahead of the dependent chain
// of multiply-adds, so a thread keeps 2*kUnroll loads in flight while h
// waits.  Grid: (ceil(I*N / 256), B).  Later work: split the time axis
// into chunks across blocks (a two-pass scan) when B*I*N threads are too
// few to cover the memory latency.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ h0, float* __restrict__ hs,
                    float* __restrict__ h_final, int S, int64_t C) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t row = blockIdx.y;
  const int64_t base = row * S * C + c;  // element (row, t = 0, c)
  float h = h0[row * C + c];
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = base + static_cast<int64_t>(t + u) * C;
      av[u] = __ldg(a + off);
      bv[u] = __ldg(b + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      hs[base + static_cast<int64_t>(t + u) * C] = h;
    }
  }
  for (; t < S; ++t) {
    const int64_t off = base + static_cast<int64_t>(t) * C;
    h = __fadd_rn(__fmul_rn(__ldg(a + off), h), __ldg(b + off));
    hs[off] = h;
  }
  h_final[row * C + c] = h;
}

}  // namespace

// a, b: (B, S, I, N); h0: (B, I, N); hs: (B, S, I, N); h_final: (B, I, N);
// all float32, contiguous, on the device of `stream`.  Returns the CUDA
// error of the launch (0 = cudaSuccess); does not synchronise.
extern "C" int repro_ssd_scan(const void* a, const void* b, const void* h0,
                              void* hs, void* h_final, int B, int S, int I,
                              int N, void* stream) {
  const int64_t C = static_cast<int64_t>(I) * N;
  if (B <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((C + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  ssd_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(h_final), S, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
