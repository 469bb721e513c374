// Mamba-1 selective scan: h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,
// y_t = h_t . C_t + D * x_t, from an optional initial state, returning the
// output and the last state.
//
// Replaces: src/repro/kernels/mamba_scan.py, _mamba_kernel /
// mamba_scan_pallas (the TPU kernel walks the grid (B, Di / BDi, S / CHUNK)
// with the chunks innermost and carries the (BDi, N) state in VMEM scratch
// from one grid step to the next, vectorising each step over channels and
// states). Unlike the Pallas kernel, this one also takes an initial state
// and writes the last one, which the model's prefill keeps as its SSM cache.
//
// Bound on the H100: at the prefill shapes (B 1, S up to a few hundred,
// Di 8192, N 16) each input is read once and y written once, about 17 MB
// at S = 200 (5 us at 3.35 TB/s), while the S * Di * N exponentials take
// about 6 us at the special-function units' 16 results per clock per SM.
// So the exponentials bind, by a little; the remaining f32 work (about
// six flops per state and step) is a third of either.
//
// Design: one thread per (batch row, channel, state), so with N = 16 a
// warp holds two channels and a block of 128 threads eight; the grid is
// (Di / channels per block, B), 1,024 blocks at B 1 and Di 8192, enough to
// fill all 132 SMs. Each thread keeps its state h, A[i, n] and D[i] in
// registers for the whole sequence. The sequence is walked in runs of 64
// steps: the block stages the run's dt and x for its channels and B_t, C_t
// in shared memory with coalesced loads (x converted to f32 on the way in,
// so the model's bf16 activations need no cast), then steps through the run
// with the state in registers. The N-sum of y_t is a butterfly of
// __shfl_xor_sync inside each group of N lanes; the group's first lane
// parks y_t in shared memory, and the run's outputs leave in one coalesced
// pass. exp is the accurate expf, so the kernel stays within f32 rounding
// of the plain version. N is a template parameter: 4, 8 or 16.
//
// C entry point: mamba_scan_launch(dt, a, b, c, d, x, h0, y, h_last, B, S,
// Di, N, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss, x_dtype, stream):
// dt, b, c and x are read by their (batch, step) element strides with unit
// stride on the last axis; a (Di, N), d (Di,), h0 (B, Di, N) (or null for a
// zero state), y (B, S, Di) and h_last (B, Di, N) are contiguous float32;
// x_dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 64;   // steps staged in shared memory per run

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int N, typename TX>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ dvec, const TX* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int Di, long long dt_sb,
                  long long dt_ss, long long b_sb, long long b_ss,
                  long long c_sb, long long c_ss, long long x_sb,
                  long long x_ss) {
  constexpr int CH = kThreads / N;   // channels per block
  __shared__ float dt_s[kSteps][CH];
  __shared__ float x_s[kSteps][CH];
  __shared__ float y_s[kSteps][CH];
  __shared__ float b_s[kSteps][N];
  __shared__ float c_s[kSteps][N];

  const int tid = threadIdx.x;
  const int ch = tid / N;
  const int n = tid % N;
  const int row = blockIdx.y;
  const int i0 = blockIdx.x * CH;
  const int i = i0 + ch;
  const bool live = i < Di;
  const long long state = (static_cast<long long>(row) * Di + i) * N + n;

  const float a_in = live ? a[static_cast<long long>(i) * N + n] : 0.f;
  const float d_i = live ? dvec[i] : 0.f;
  float h = (live && h0 != nullptr) ? h0[state] : 0.f;

  const float* dt_r = dt + row * dt_sb;
  const float* b_r = bm + row * b_sb;
  const float* c_r = cm + row * c_sb;
  const TX* x_r = x + row * x_sb;
  float* y_r = y + static_cast<long long>(row) * S * Di;

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int T = min(kSteps, S - t0);
    for (int e = tid; e < T * CH; e += kThreads) {
      const int tt = e / CH;
      const int ii = i0 + e % CH;
      const long long t = t0 + tt;
      const bool ok = ii < Di;
      dt_s[tt][e % CH] = ok ? dt_r[t * dt_ss + ii] : 0.f;
      x_s[tt][e % CH] = ok ? to_f(x_r[t * x_ss + ii]) : 0.f;
    }
    for (int e = tid; e < T * N; e += kThreads) {
      const long long t = t0 + e / N;
      b_s[e / N][e % N] = b_r[t * b_ss + e % N];
      c_s[e / N][e % N] = c_r[t * c_ss + e % N];
    }
    __syncthreads();
    for (int tt = 0; tt < T; ++tt) {
      const float dv = dt_s[tt][ch];
      const float xv = x_s[tt][ch];
      h = expf(dv * a_in) * h + (dv * xv) * b_s[tt][n];
      float p = h * c_s[tt][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) y_s[tt][ch] = p + d_i * xv;
    }
    __syncthreads();
    for (int e = tid; e < T * CH; e += kThreads) {
      const int ii = i0 + e % CH;
      if (ii < Di) {
        y_r[static_cast<long long>(t0 + e / CH) * Di + ii] =
            y_s[e / CH][e % CH];
      }
    }
    // the next run's staging overwrites only dt_s, x_s, b_s and c_s, which
    // every thread finished reading before the barrier above; y_s is
    // rewritten only after the next barrier
  }
  if (live) h_last[state] = h;
}

template <int N, typename TX>
cudaError_t launch_n(const void* dt, const void* a, const void* b,
                     const void* c, const void* d, const void* x,
                     const void* h0, void* y, void* h_last, int B, int S,
                     int Di, long long dt_sb, long long dt_ss, long long b_sb,
                     long long b_ss, long long c_sb, long long c_ss,
                     long long x_sb, long long x_ss, cudaStream_t stream) {
  constexpr int CH = kThreads / N;
  const dim3 grid((Di + CH - 1) / CH, B);
  mamba_scan_kernel<N, TX><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(d), static_cast<const TX*>(x),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), S, Di, dt_sb, dt_ss, b_sb, b_ss, c_sb,
      c_ss, x_sb, x_ss);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(const void* dt, const void* a, const void* b,
                   const void* c, const void* d, const void* x,
                   const void* h0, void* y, void* h_last, int B, int S,
                   int Di, int N, long long dt_sb, long long dt_ss,
                   long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss, long long x_sb, long long x_ss,
                   cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch_n<4, TX>(dt, a, b, c, d, x, h0, y, h_last, B, S, Di,
                             dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb,
                             x_ss, stream);
    case 8:
      return launch_n<8, TX>(dt, a, b, c, d, x, h0, y, h_last, B, S, Di,
                             dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb,
                             x_ss, stream);
    case 16:
      return launch_n<16, TX>(dt, a, b, c, d, x, h0, y, h_last, B, S, Di,
                              dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb,
                              x_ss, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mamba_scan_launch(
    const void* dt, const void* a, const void* b, const void* c,
    const void* d, const void* x, const void* h0, void* y, void* h_last,
    int B, int S, int Di, int N, long long dt_sb, long long dt_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long x_sb, long long x_ss, int x_dtype, void* stream) {
  if (B < 1 || S < 1 || Di < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0) {
    err = launch<float>(dt, a, b, c, d, x, h0, y, h_last, B, S, Di, N,
                        dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss, s);
  } else if (x_dtype == 1) {
    err = launch<__nv_bfloat16>(dt, a, b, c, d, x, h0, y, h_last, B, S, Di,
                                N, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss,
                                x_sb, x_ss, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
