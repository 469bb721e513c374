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
// at S = 200 (5.2 us at 3.35 TB/s), while the S * Di * N exponentials take
// 6.3 us at the special-function units' 16 results per clock per SM. So
// the exponentials bind, by a little. Per state and step the rest is four
// f32 instructions (dt * A, dt x * B, the update and the h * C product)
// and the two shared-memory words B_t[n] and C_t[n], which cost the SM
// about as many cycles as the exponential does.
//
// Mamba-1's A is (Di, N): every (channel, state) pair decays at its own
// rate, so the scan has no one-scalar-per-head decay to turn into a chunked
// matrix form on the tensor cores (that is Mamba-2's SSD); it stays on the
// CUDA cores.
//
// Design: a thread owns K = 4 consecutive states of one channel, so
// G = N / K lanes hold a channel; a block holds 32 channels (32 * G
// threads) and the grid is (Di / 32, B). The thread keeps its K states,
// A * log2(e) and D in registers for the whole sequence, so dt and x are
// read once per channel and step, not once per state, and B_t and C_t
// come in one 16-byte shared-memory load each. Each step's decay is one
// ex2.approx.ftz of dt * (A * log2 e).
// Steps go in groups of 8, unrolled: the 8K decays and inputs dt x B of a
// group depend on no state, so they are all issued first and the
// special-function units see independent work; only then runs the chain
// h = da * h + bu, one FMA a step, and the h * C products. The group's 8
// partial y sums (D * x folded into one lane's) are reduced across the G
// lanes by a reduce-scatter of log2(G) shuffle rounds that halves the
// values each round, 8 - 8 / G shuffles a group instead of 8 log2(G), and
// leaves each lane the full y of 8 / G steps, which it parks in a
// shared-memory tile (rows padded to 36 floats: conflict-free for every G);
// the run's y rows then leave the tile in coalesced 16-byte stores.
// The sequence is staged 32 steps at a time (a run) in three buffers with
// 16-byte cp.async copies (dt and y rows of 128 bytes, x rows of 64 bytes
// in bf16): run r + 2 is staged while run r computes, into the buffer run
// r - 1 read (csrc/scan.cuh stage_run, which the backward shares). Steps
// past S and channels past Di are staged as zeros (decay 1, input 0), so
// groups never need a tail case. An operand whose pointer or strides are
// not 16-byte aligned is staged element by element instead; the model's
// operands are all aligned.
//
// K = 4 (at most N for every N the kernel takes), chosen on the H100 at
// B 1, Di 8192, N 16 against K 2 and K 8 (PERF.md): K 8 leaves one warp
// per SM sub-partition and was the slowest at S 200 and S 64; K 2 doubles
// the warps but also the per-state loads of dt and x and the shuffles,
// and was level with K 4 at S 200 and slower at S 64. With two warps per
// sub-partition at K 4, the exponentials, the B and C reads and the issue
// slots each need about half the time the kernel takes, and two warps do
// not overlap them fully: the kernel runs at about three times its bound.
// Pipelining the next group's exponentials into this group's chain,
// staging from a producer warp, runs fed by TMA, 64-step runs and writing
// y straight from registers were each tried on the H100, and none was
// faster.
//
// The states for the backward: with a non-null `states` each thread also
// writes its 16 bytes of the state entering every run (before the run's
// first step), (B, ceil(S / 32), Di, N) f32, which csrc/mamba_scan_bwd.cu
// reads instead of walking the sequence again. The write is compiled into
// a second instantiation of the kernel (kWriteStates), so a launch with
// null runs the kernel as it was without the output: the same code, the
// same bits.
//
// C entry point: mamba_scan_launch(dt, a, b, c, d, x, h0, y, h_last,
// states, B, S, Di, N, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss,
// x_dtype, stream): dt, b, c and x are read by their (batch, step) element
// strides with unit stride on the last axis; a (Di, N), d (Di,), h0
// (B, Di, N) (or null for a zero state), y (B, S, Di), h_last (B, Di, N)
// and states (or null) are contiguous float32; N 4, 8 or 16; x_dtype 0 =
// float32, 1 = bfloat16. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kGroup = 8;     // steps unrolled together
// staging buffers: runs r, r + 1 and r + 2; run r + 2 is staged while
// run r computes, into the buffer run r - 1 read
constexpr int kBufs = 3;
constexpr int kYPitch = kCh + 4;

template <int N, typename TX>
struct Smem {
  float dt[kBufs][kRun][kCh];
  TX x[kBufs][kRun][kCh];
  float b[kBufs][kRun][N];
  float c[kBufs][kRun][N];
  float y[kRun][kYPitch];
};

template <int N, typename TX, bool kWriteStates>
__global__ void __launch_bounds__(kCh * N / kStates)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ dvec, const TX* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ h_last, float* __restrict__ states,
                  int S, int Di, long long dt_sb,
                  long long dt_ss, long long b_sb, long long b_ss,
                  long long c_sb, long long c_ss, long long x_sb,
                  long long x_ss, unsigned vec) {
  constexpr int K = kStates;
  constexpr int G = N / K;                 // lanes per channel
  constexpr int NT = kCh * G;              // threads per block
  constexpr int U = kGroup;                // steps a group
  static_assert(K <= N && N % K == 0 && U % G == 0 && kRun % U == 0,
                "K, N and the group");
  constexpr int XE = 16 / static_cast<int>(sizeof(TX));
  __shared__ __align__(16) Smem<N, TX> sm;

  const int tid = threadIdx.x;
  const int cl = tid / G;                  // channel within the block
  const int gl = tid % G;                  // lane within the channel
  const int row = blockIdx.y;
  const int i0 = blockIdx.x * kCh;
  const int i = i0 + cl;
  const bool live = i < Di;
  const long long state0 =
      (static_cast<long long>(row) * Di + i) * N + gl * K;

  float a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a2[k] = live ? a[static_cast<long long>(i) * N + gl * K + k] * kLog2e
                 : 0.f;
    h[k] = (live && h0 != nullptr) ? h0[state0 + k] : 0.f;
  }
  const float d_i = live ? dvec[i] : 0.f;

  const float* dt_r = dt + row * dt_sb;
  const float* b_r = bm + row * b_sb;
  const float* c_r = cm + row * c_sb;
  const TX* x_r = x + row * x_sb;
  float* y_r = y + static_cast<long long>(row) * S * Di;

  auto stage = [&](int r, int buf) {
    stage_run<float, kCh / 4, kCh, NT>(&sm.dt[buf][0][0], dt_r, dt_ss, i0,
                                       Di, r, S, vec & 1u, tid);
    stage_run<TX, kCh / XE, kCh, NT>(&sm.x[buf][0][0], x_r, x_ss, i0, Di, r,
                                     S, vec & 2u, tid);
    stage_run<float, N / 4, N, NT>(&sm.b[buf][0][0], b_r, b_ss, 0, N, r, S,
                                   vec & 4u, tid);
    stage_run<float, N / 4, N, NT>(&sm.c[buf][0][0], c_r, c_ss, 0, N, r, S,
                                   vec & 8u, tid);
  };

  const int runs = (S + kRun - 1) / kRun;
  stage(0, 0);
  cp_async_commit();
  if (runs > 1) stage(1, 1);
  cp_async_commit();
  for (int r = 0; r < runs; ++r) {
    const int buf = r % kBufs;
    if constexpr (kWriteStates) {
      // the state entering run r: (B, runs, Di, N), 16 bytes a thread
      if (live)
        *reinterpret_cast<float4*>(
            states + ((static_cast<long long>(row) * runs + r) * Di + i) * N
            + gl * K) = make_float4(h[0], h[1], h[2], h[3]);
    }
    cp_async_wait<1>();   // this thread's copies of run r landed
    __syncthreads();      // ... and every other thread's; run r - 1 is done
    if (r + 2 < runs) stage(r + 2, (r + 2) % kBufs);
    cp_async_commit();
    const int T = min(kRun, S - r * kRun);
    for (int g0 = 0; g0 < T; g0 += U) {
      float dtv[U], dtx[U], p[U], da[U][K], bu[U][K];
      // everything that does not depend on h: dt, x, the decays and inputs
#pragma unroll
      for (int u = 0; u < U; ++u) {
        dtv[u] = sm.dt[buf][g0 + u][cl];
        const float xv = to_f(sm.x[buf][g0 + u][cl]);
        dtx[u] = dtv[u] * xv;
        p[u] = gl == 0 ? d_i * xv : 0.f;
        float bk[K];
        load_k(bk, &sm.b[buf][g0 + u][gl * K]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          da[u][k] = ex2(dtv[u] * a2[k]);
          bu[u][k] = dtx[u] * bk[k];
        }
      }
      // the recurrence: one FMA a state and step, then h . C
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float ck[K];
        load_k(ck, &sm.c[buf][g0 + u][gl * K]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          h[k] = fmaf(da[u][k], h[k], bu[u][k]);
          p[u] = fmaf(h[k], ck[k], p[u]);
        }
      }
      // reduce-scatter the U partial sums over the G lanes of the channel:
      // each round a lane keeps one half of its values, adds its
      // partner's copy of that half, and ends with U / G full sums
      int base = 0;
#pragma unroll
      for (int o = G / 2, half = U / 2; o >= 1; o >>= 1, half >>= 1) {
        const bool hi = (gl & o) != 0;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float send = hi ? p[j] : p[j + half];
          const float keep = hi ? p[j + half] : p[j];
          p[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
        base += hi ? half : 0;
      }
#pragma unroll
      for (int j = 0; j < U / G; ++j) sm.y[g0 + base + j][cl] = p[j];
    }
    __syncthreads();
    // the run's y rows, 16 bytes a thread where the rows allow it
    constexpr int YC = kCh / 4;
    const bool y_vec = Di % 4 == 0;
    for (int e = tid; e < T * YC; e += NT) {
      const int tt = e / YC, c = e % YC, ch = i0 + c * 4;
      float* dst = y_r + static_cast<long long>(r * kRun + tt) * Di + ch;
      const float* src = &sm.y[tt][c * 4];
      if (y_vec && ch + 4 <= Di) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (ch + u < Di) dst[u] = src[u];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) h_last[state0 + k] = h[k];
  }
}

template <int N, typename TX>
cudaError_t launch_n(const void* dt, const void* a, const void* b,
                     const void* c, const void* d, const void* x,
                     const void* h0, void* y, void* h_last, void* states,
                     int B, int S, int Di, long long dt_sb, long long dt_ss,
                     long long b_sb, long long b_ss, long long c_sb,
                     long long c_ss, long long x_sb, long long x_ss,
                     cudaStream_t stream) {
  const unsigned vec = aligned_operands<TX>(dt, dt_sb, dt_ss, x, x_sb, x_ss,
                                            b, b_sb, b_ss, c, c_sb, c_ss);
  const dim3 grid((Di + kCh - 1) / kCh, B);
  auto kernel = states == nullptr ? mamba_scan_kernel<N, TX, false>
                                  : mamba_scan_kernel<N, TX, true>;
  kernel<<<grid, kCh * N / kStates, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(d), static_cast<const TX*>(x),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), static_cast<float*>(states), S, Di,
      dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss, vec);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(int N, const void* dt, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* x, const void* h0, void* y, void* h_last,
                   void* states, int B, int S, int Di, long long dt_sb,
                   long long dt_ss, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss, long long x_sb,
                   long long x_ss, cudaStream_t stream) {
#define MAMBA_FWD_ARGS                                                     \
  dt, a, b, c, d, x, h0, y, h_last, states, B, S, Di, dt_sb, dt_ss, b_sb,  \
      b_ss, c_sb, c_ss, x_sb, x_ss, stream
  switch (N) {
    case 4:
      return launch_n<4, TX>(MAMBA_FWD_ARGS);
    case 8:
      return launch_n<8, TX>(MAMBA_FWD_ARGS);
    case 16:
      return launch_n<16, TX>(MAMBA_FWD_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef MAMBA_FWD_ARGS
}

}  // namespace

extern "C" int mamba_scan_launch(
    const void* dt, const void* a, const void* b, const void* c,
    const void* d, const void* x, const void* h0, void* y, void* h_last,
    void* states, int B, int S, int Di, int N, long long dt_sb, long long dt_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long x_sb, long long x_ss, int x_dtype, void* stream) {
  if (B < 1 || S < 1 || Di < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0) {
    err = launch<float>(N, dt, a, b, c, d, x, h0, y, h_last, states, B, S,
                        Di, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss,
                        s);
  } else if (x_dtype == 1) {
    err = launch<__nv_bfloat16>(N, dt, a, b, c, d, x, h0, y, h_last,
                                states, B, S, Di, dt_sb, dt_ss, b_sb, b_ss,
                                c_sb, c_ss, x_sb, x_ss, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
