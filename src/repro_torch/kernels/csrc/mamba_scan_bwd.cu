// The gradient of the Mamba-1 selective scan (csrc/mamba_scan.cu):
// h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = h_t . C_t + D x_t,
// from an optional initial state, against dy and an optional dh_last.
// With g_t = dL/dh_t and e_t = exp(dt_t A) (kernels/ref.py
// mamba_scan_bwd_ref runs the same recurrence):
//
//   g_t   = dy_t C_t + e_{t+1} g_{t+1}       (the carry into S - 1: dh_last)
//   dC_t  = sum_d dy_t h_t                   dB_t = sum_d g_t dt_t x_t
//   dx_t  = dt_t sum_n g_t B_t + D dy_t
//   ddt_t = sum_n g_t (A e_t h_{t-1} + B_t x_t)
//         = sum_n A (g_t e_t h_{t-1}) + x_t sum_n g_t B_t
//   dA    = sum_{b,t} g_t dt_t e_t h_{t-1}   dD = sum_{b,t} dy_t x_t
//   dh0   = e_0 g_0
//
// Replaces: no TPU kernel. The JAX model differentiates its jnp
// selective_scan (src/repro/models/mamba.py:75, a chunked associative scan
// inside lax.scan) with XLA; the port's forward runs csrc/mamba_scan.cu,
// so its gradient needs a kernel of its own.
//
// Bound on the H100: at falcon-mamba-7b's training shape (B 4, S 512,
// Di 8192, N 16, x bf16) dt, x, dy, ddt, dx and the forward's chunk states
// are 303.6 MB (0.0906 ms at 3.35 TB/s), and each decay e_t once is 268 M
// exponentials (0.0642 ms at the special-function units' 16 results per
// clock per SM): bytes bind. The work that sets this kernel's time is
// elsewhere: per state and step about 30 instructions (the recompute, the
// reverse step, and the sums over channels and over states, which cross
// lanes), and shared memory holding the chunk's states, which caps the
// blocks an SM can keep (PERF.md §6 reads each share).
//
// Design: one block owns one batch row and 32 channels, as the forward
// does: a thread holds K = 4 consecutive states of one channel, G = N / 4
// lanes a channel, 32 * G threads. The recurrence is per channel, so a
// block needs no other block's states. It walks the 32-step chunks in
// reverse:
//   1. the chunk's dt, x, dy, B and C are staged by a two-buffer cp.async
//      ring: chunk c - 1 loads while chunk c computes; steps past S are
//      zeros (decay 1, input 0, dy 0), so every chunk runs 32 steps and
//      only the writes stop at S;
//   2. the state entering the chunk comes from the forward (`states`, the
//      16 bytes this thread's counterpart in the forward wrote, read a
//      chunk ahead). Shared memory holds the states of 16 steps, so the
//      chunk runs as two halves, the second first: the first half is
//      walked once for the state entering the second, then each half is
//      recomputed from the state entering it, its decays kept in
//      registers (16 x 4 a thread, the loops unrolled) and its states
//      stored (16 bytes a thread and step). Each decay is taken 1.5 times
//      a step, never in the reverse step;
//   3. the reverse recurrence runs in registers, in quads of 4 steps. Each
//      step's dB and dC products are summed over the warp's channels by a
//      reduce-scatter over the lanes that hold the same states (3 shuffle
//      rounds at N 16, 7 shuffles a step), each lane keeping a finished
//      sum, which it parks where its quad's first state was (no longer
//      read); after each half the block adds its warps' sums in order and
//      writes one partial a block. dx and ddt: each lane's terms, already
//      multiplied by dt and x (D dy on one lane), are reduce-scattered over
//      the channel's G lanes a quad at a time, and each lane writes the
//      steps it is left with from registers;
//   4. a second kernel adds the blocks' partials of dB and dC, and the
//      batch rows' of dA and dD (sums over t kept in registers), in a
//      fixed order.
// No atomics: two calls give the same bits. Channels past Di carry zeros
// and write nothing.
//
// At N 16 a block is 128 threads with 61,440 bytes of shared memory (x
// bf16; 63,488 with x f32) and at most 168 registers a thread: 3 blocks an
// SM, 12 warps. Chosen on the card (profiling/scan_bwd_ab.py; PERF.md §6
// has the runs): the whole chunk's states in shared memory (102 KB a
// block, 2 blocks an SM) was slower than this, and in that design a
// thread-block cluster of 8 summing dB and dC through distributed shared
// memory was slower than one partial a block; dB and dC summed from shared
// memory once a half was slower than the reduce-scatter, and so was the
// decay taken again in the reverse step instead of kept.
//
// C entry point: mamba_scan_bwd_launch(dt, a, b, c, d, x, h0, dy, dh_last,
// ddt, da, db, dc, dd, dx, dh0, states, part_bc, part_ad, B, S, Di, N,
// dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss, dy_sb, dy_ss, x_dtype,
// stream): dt, b, c, x and dy are read by their (batch, step) element
// strides with unit stride on the last axis; a (Di, N), d (Di,), h0 and
// dh_last (B, Di, N) (each may be null: zero) are contiguous float32;
// states (B, ceil(S / 32), Di, N) float32, the forward's states output for
// the same inputs; outputs ddt (B, S, Di), da (Di, N), db and dc (B, S, N),
// dd (Di,), dh0 (B, Di, N) (null: not written) are contiguous float32 and
// dx (B, S, Di) contiguous in x's dtype; scratch part_bc (2, B,
// ceil(Di / 32), S, N) and part_ad (B, Di * (N + 1)) float32. N 4, 8 or
// 16; x_dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "scan.cuh"

namespace {

constexpr int kQuad = 4;            // steps whose dx, ddt sums reduce together
constexpr int kHalf = kRun / 2;     // steps whose states shared memory holds

__device__ __forceinline__ void from_f(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <int N, typename TX>
struct BwdSmem {
  static constexpr int NT = kCh * N / kStates;
  float h[kHalf][NT][kStates];  // h_t of half a chunk; then dB, dC sums
  float dt[2][kRun][kCh];       // the staging ring
  float dy[2][kRun][kCh];
  TX x[2][kRun][kCh];
  float b[2][kRun][N];
  float c[2][kRun][N];
};

template <int N, typename TX>
__global__ void __launch_bounds__(kCh * N / kStates, 3)
mamba_scan_bwd_kernel(
    const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ dvec, const TX* __restrict__ x,
    const float* __restrict__ dy, const float* __restrict__ dh_last,
    const float* __restrict__ states, float* __restrict__ ddt,
    TX* __restrict__ dx, float* __restrict__ dh0,
    float* __restrict__ part_bc, float* __restrict__ part_ad, int B, int S,
    int Di, long long dt_sb, long long dt_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, long long x_sb, long long x_ss,
    long long dy_sb, long long dy_ss, unsigned vec) {
  constexpr int K = kStates;
  constexpr int G = N / K;                 // lanes per channel
  constexpr int NT = kCh * G;              // threads per block
  constexpr int W = NT / 32;               // warps
  constexpr int U = kQuad / G;             // steps a dB, dC reduce-scatter
  constexpr int XE = 16 / static_cast<int>(sizeof(TX));
  static_assert(K <= N && N % K == 0 && NT % 32 == 0 && U * G == kQuad
                && kHalf % kQuad == 0, "K, N and the quad");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<N, TX>& sm = *reinterpret_cast<BwdSmem<N, TX>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cl = tid / G;                  // channel within the block
  const int gl = tid % G;                  // lane within the channel
  const int row = blockIdx.y;
  const int blk = blockIdx.x;
  const int i0 = blk * kCh;
  const int i = i0 + cl;
  const bool live = i < Di;
  const int nc = (S + kRun - 1) / kRun;
  const long long state0 =
      (static_cast<long long>(row) * Di + i) * N + gl * K;

  float av[K], a2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    av[k] = live ? a[static_cast<long long>(i) * N + gl * K + k] : 0.f;
    a2[k] = av[k] * kLog2e;
  }
  const float d_i = live ? dvec[i] : 0.f;

  const float* dt_r = dt + row * dt_sb;
  const TX* x_r = x + row * x_sb;
  const float* dy_r = dy + row * dy_sb;
  const float* b_r = bm + row * b_sb;
  const float* c_r = cm + row * c_sb;
  auto stage = [&](int r, int buf) {
    stage_run<float, kCh / 4, kCh, NT>(&sm.dt[buf][0][0], dt_r, dt_ss, i0,
                                       Di, r, S, vec & 1u, tid);
    stage_run<TX, kCh / XE, kCh, NT>(&sm.x[buf][0][0], x_r, x_ss, i0, Di, r,
                                     S, vec & 2u, tid);
    stage_run<float, N / 4, N, NT>(&sm.b[buf][0][0], b_r, b_ss, 0, N, r, S,
                                   vec & 4u, tid);
    stage_run<float, N / 4, N, NT>(&sm.c[buf][0][0], c_r, c_ss, 0, N, r, S,
                                   vec & 8u, tid);
    stage_run<float, kCh / 4, kCh, NT>(&sm.dy[buf][0][0], dy_r, dy_ss, i0,
                                       Di, r, S, vec & 16u, tid);
  };
  // the state entering chunk c, as the forward wrote it
  const float* st_in = states
      + (static_cast<long long>(row) * nc * Di + i) * N + gl * K;
  auto entry = [&](int c) {
    return live ? *reinterpret_cast<const float4*>(
                      st_in + c * static_cast<long long>(Di) * N)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float g[K], acc_a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    g[k] = (live && dh_last != nullptr) ? dh_last[state0 + k] : 0.f;
    acc_a[k] = 0.f;
  }
  float acc_d = 0.f;
  float4 next = entry(nc - 1);
  stage(nc - 1, (nc - 1) & 1);
  cp_async_commit();
  for (int c = nc - 1; c >= 0; --c) {
    const int buf = c & 1;
    const int t0 = c * kRun;
    cp_async_wait<0>();   // this thread's copies of chunk c landed
    __syncthreads();      // ... and every thread's; chunk c + 1 is out
    if (c > 0) stage(c - 1, buf ^ 1);
    cp_async_commit();
    const float hs[K] = {next.x, next.y, next.z, next.w};
    if (c > 0) next = entry(c - 1);

    // the state entering the chunk's second half: the first half walked
    float hm[K];
#pragma unroll
    for (int k = 0; k < K; ++k) hm[k] = hs[k];
#pragma unroll
    for (int tt = 0; tt < kHalf; ++tt) {
      const float dtv = sm.dt[buf][tt][cl];
      const float dtx = dtv * to_f(sm.x[buf][tt][cl]);
      float bk[K];
      load_k(bk, &sm.b[buf][tt][gl * K]);
#pragma unroll
      for (int k = 0; k < K; ++k)
        hm[k] = fmaf(ex2(dtv * a2[k]), hm[k], dtx * bk[k]);
    }

    // each half from the state entering it: its states (the decays kept),
    // then its reverse recurrence a quad of steps at a time
    for (int half = 1; half >= 0; --half) {
      const int base = half * kHalf;
      float h_in[K], e[kHalf][K], h[K];
#pragma unroll
      for (int k = 0; k < K; ++k) h[k] = h_in[k] = half ? hm[k] : hs[k];
#pragma unroll
      for (int tl = 0; tl < kHalf; ++tl) {
        const int t = base + tl;
        const float dtv = sm.dt[buf][t][cl];
        const float dtx = dtv * to_f(sm.x[buf][t][cl]);
        float bk[K];
        load_k(bk, &sm.b[buf][t][gl * K]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          e[tl][k] = ex2(dtv * a2[k]);
          h[k] = fmaf(e[tl][k], h[k], dtx * bk[k]);
        }
        if (tl + 1 < kHalf)     // the half's last state stays in registers
          *reinterpret_cast<float4*>(&sm.h[tl][tid][0]) =
              make_float4(h[0], h[1], h[2], h[3]);
      }
      float ht[K];   // h_t
#pragma unroll
      for (int k = 0; k < K; ++k) ht[k] = h[k];
#pragma unroll
      for (int q = kHalf / kQuad - 1; q >= 0; --q) {
        float sx[kQuad], sd[kQuad];   // this lane's dx and ddt terms
        float slot[4] = {0.f, 0.f, 0.f, 0.f};   // finished dB, dC sums
        float p[8 * U];               // dB, dC products of U steps
#pragma unroll
        for (int j = kQuad - 1; j >= 0; --j) {
          const int tl = q * kQuad + j;
          const int t = base + tl;
          const int u = j % U;
          const float dtv = sm.dt[buf][t][cl];
          const float dyv = sm.dy[buf][t][cl];
          const float xv = to_f(sm.x[buf][t][cl]);
          const float dtx = dtv * xv;
          float bk[K], ck[K], hp[K];
          load_k(bk, &sm.b[buf][t][gl * K]);
          load_k(ck, &sm.c[buf][t][gl * K]);
          if (tl > 0) {
            load_k(hp, &sm.h[tl - 1][tid][0]);
          } else {
#pragma unroll
            for (int k = 0; k < K; ++k) hp[k] = h_in[k];
          }
          float sdx = 0.f, sdd = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float ek = e[tl][k];
            const float gk = fmaf(dyv, ck[k], g[k]);
            p[(u * 2) * K + k] = gk * dtx;          // dB_t's term
            p[(u * 2 + 1) * K + k] = dyv * ht[k];   // dC_t's term
            sdx = fmaf(gk, bk[k], sdx);
            const float qk = gk * (ek * hp[k]);
            sdd = fmaf(av[k], qk, sdd);
            acc_a[k] = fmaf(qk, dtv, acc_a[k]);
            g[k] = ek * gk;
            ht[k] = hp[k];
          }
          // this lane's terms of dx_t (D dy_t on one lane) and ddt_t
          sx[j] = fmaf(dtv, sdx, gl == 0 ? d_i * dyv : 0.f);
          sd[j] = fmaf(xv, sdx, sdd);
          acc_d = fmaf(dyv, xv, acc_d);
          if (u == 0) {
            // reduce-scatter the 8U products over the lanes holding the
            // same states (lane bits G .. 16): each round a lane keeps one
            // half, adds its partner's copy of it, and ends with the sum
            // of value v = lane / G: step j + v / 8, dC if v & 4, state
            // v % 4
#pragma unroll
            for (int o = 16, hw = 4 * U; o >= G; o >>= 1, hw >>= 1) {
              const bool hi = (lane & o) != 0;
#pragma unroll
              for (int m = 0; m < hw; ++m) {
                const float send = hi ? p[m] : p[m + hw];
                const float keep = hi ? p[m + hw] : p[m];
                p[m] = keep + __shfl_xor_sync(0xffffffffu, send, o);
              }
            }
            slot[j / U] = p[0];
          }
        }
        // the quad's sums go where h_{4q} was (read at step 4q + 1)
        *reinterpret_cast<float4*>(&sm.h[q * kQuad][tid][0]) =
            make_float4(slot[0], slot[1], slot[2], slot[3]);
        // dx and ddt: reduce-scatter 2 x 4 terms over the channel's lanes,
        // each lane left with steps gl * U .. gl * U + U - 1, which it
        // writes
        float r[2 * kQuad];
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          r[2 * j] = sx[j];
          r[2 * j + 1] = sd[j];
        }
#pragma unroll
        for (int o = G / 2, hw = kQuad; o >= 1; o >>= 1, hw >>= 1) {
          const bool hi = (gl & o) != 0;
#pragma unroll
          for (int m = 0; m < hw; ++m) {
            const float send = hi ? r[m] : r[m + hw];
            const float keep = hi ? r[m + hw] : r[m];
            r[m] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = t0 + base + q * kQuad + gl * U + u;
          if (live && t < S) {
            const long long at = (static_cast<long long>(row) * S + t) * Di
                + i;
            from_f(dx + at, r[2 * u]);
            ddt[at] = r[2 * u + 1];
          }
        }
      }
      __syncthreads();   // every warp's dB, dC sums of the half

      // the block's dB and dC of the half: its warps' sums in order
      for (int e2 = tid; e2 < 2 * kHalf * N; e2 += NT) {
        const int which = e2 / (kHalf * N);
        const int tl = (e2 / N) % kHalf;
        const int n = e2 % N;
        const int j = tl % kQuad;
        const int v = ((j % U) * 2 + which) * K + n % K;
        const float* src = &sm.h[tl - j][0][0] + (v * G + n / K) * K + j / U;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) sum += src[w * 32 * K];
        const int t = t0 + base + tl;
        if (t < S)
          part_bc[(((static_cast<long long>(which) * B + row) * gridDim.x
                    + blk) * S + t) * N + n] = sum;
      }
      if (half) __syncthreads();   // the first half's states reuse the rows
    }
  }
  // dD: every lane of a channel summed all its steps
  if (live) {
    float* pa = part_ad + static_cast<long long>(row) * Di * (N + 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pa[static_cast<long long>(i) * N + gl * K + k] = acc_a[k];
      if (dh0 != nullptr) dh0[state0 + k] = g[k];
    }
    if (gl == 0) pa[static_cast<long long>(Di) * N + i] = acc_d;
  }
}

// db and dc: the blocks' partials; da and dd: the batch rows' partials,
// each summed in a fixed order. A block takes 32 outputs: warp w adds the
// w-th of kParts runs of partials for each (coalesced along the outputs),
// and warp 0 adds the runs in order.
constexpr int kParts = 8;

__global__ void __launch_bounds__(32 * kParts)
mamba_scan_bwd_reduce(
    const float* __restrict__ part_bc, const float* __restrict__ part_ad,
    float* __restrict__ da, float* __restrict__ db, float* __restrict__ dc,
    float* __restrict__ dd, int B, int S, int Di, int N, int nblk) {
  __shared__ float run[kParts][32];
  const long long bsn = static_cast<long long>(B) * S * N;
  const long long sn = static_cast<long long>(S) * N;
  const long long dn = static_cast<long long>(Di) * N;
  const long long total = 2 * bsn + dn + Di;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const long long e = blockIdx.x * 32LL + lane;
  float sum = 0.f;
  if (e < 2 * bsn) {
    const long long which = e / bsn, r = e % bsn;
    const long long row = r / sn, t = r % sn;
    const float* p = part_bc + ((which * B + row) * nblk) * sn + t;
    const int per = (nblk + kParts - 1) / kParts;
    const int k1 = min(nblk, (w + 1) * per);
    for (int k = w * per; k < k1; ++k) sum += p[k * sn];
  } else if (e < total && w == 0) {
    const long long j = e - 2 * bsn;     // da's entries, then dd's
    for (int row = 0; row < B; ++row) sum += part_ad[row * (dn + Di) + j];
  }
  run[w][lane] = sum;
  __syncthreads();
  if (w != 0 || e >= total) return;
  sum = run[0][lane];
#pragma unroll
  for (int m = 1; m < kParts; ++m) sum += run[m][lane];
  if (e < 2 * bsn) {
    (e < bsn ? db : dc)[e % bsn] = sum;
  } else {
    const long long j = e - 2 * bsn;
    if (j < dn) da[j] = sum; else dd[j - dn] = sum;
  }
}

template <int N, typename TX>
cudaError_t launch_n(const void* dt, const void* a, const void* b,
                     const void* c, const void* d, const void* x,
                     const void* dy, const void* dh_last, const void* states,
                     void* ddt, void* da, void* db, void* dc, void* dd,
                     void* dx, void* dh0, void* part_bc, void* part_ad,
                     int B, int S, int Di, long long dt_sb, long long dt_ss,
                     long long b_sb, long long b_ss, long long c_sb,
                     long long c_ss, long long x_sb, long long x_ss,
                     long long dy_sb, long long dy_ss, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(BwdSmem<N, TX>));
  auto kernel = mamba_scan_bwd_kernel<N, TX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nblk = (Di + kCh - 1) / kCh;
  const unsigned vec = aligned_operands<TX>(dt, dt_sb, dt_ss, x, x_sb, x_ss,
                                            b, b_sb, b_ss, c, c_sb, c_ss,
                                            dy, dy_sb, dy_ss);
  kernel<<<dim3(nblk, B), kCh * N / kStates, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(d), static_cast<const TX*>(x),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last),
      static_cast<const float*>(states), static_cast<float*>(ddt),
      static_cast<TX*>(dx), static_cast<float*>(dh0),
      static_cast<float*>(part_bc), static_cast<float*>(part_ad), B, S, Di,
      dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss, dy_sb, dy_ss, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = 2LL * B * S * N + static_cast<long long>(Di) * N
      + Di;
  mamba_scan_bwd_reduce<<<static_cast<int>((total + 31) / 32), 32 * kParts,
                          0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_ad),
      static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<float*>(dd), B, S, Di, N, nblk);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(int N, const void* dt, const void* a, const void* b,
                   const void* c, const void* d, const void* x,
                   const void* dy, const void* dh_last, const void* states,
                   void* ddt, void* da, void* db, void* dc, void* dd,
                   void* dx, void* dh0, void* part_bc, void* part_ad, int B,
                   int S, int Di, long long dt_sb, long long dt_ss,
                   long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss, long long x_sb, long long x_ss,
                   long long dy_sb, long long dy_ss, cudaStream_t stream) {
#define MAMBA_BWD_ARGS                                                     \
  dt, a, b, c, d, x, dy, dh_last, states, ddt, da, db, dc, dd, dx, dh0,    \
      part_bc, part_ad, B, S, Di, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss,    \
      x_sb, x_ss, dy_sb, dy_ss, stream
  switch (N) {
    case 4:
      return launch_n<4, TX>(MAMBA_BWD_ARGS);
    case 8:
      return launch_n<8, TX>(MAMBA_BWD_ARGS);
    case 16:
      return launch_n<16, TX>(MAMBA_BWD_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef MAMBA_BWD_ARGS
}

}  // namespace

extern "C" int mamba_scan_bwd_launch(
    const void* dt, const void* a, const void* b, const void* c,
    const void* d, const void* x, const void* h0, const void* dy,
    const void* dh_last, void* ddt, void* da, void* db, void* dc, void* dd,
    void* dx, void* dh0, const void* states, void* part_bc, void* part_ad,
    int B, int S, int Di, int N, long long dt_sb, long long dt_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long x_sb, long long x_ss, long long dy_sb, long long dy_ss,
    int x_dtype, void* stream) {
  // h0 enters only through the states (the first chunk's is h0) and dh0
  (void)h0;
  if (B < 1 || S < 1 || Di < 1 || B > 65535 || states == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0) {
    err = launch<float>(N, dt, a, b, c, d, x, dy, dh_last, states, ddt, da,
                        db, dc, dd, dx, dh0, part_bc, part_ad, B, S, Di,
                        dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss,
                        dy_sb, dy_ss, s);
  } else if (x_dtype == 1) {
    err = launch<__nv_bfloat16>(N, dt, a, b, c, d, x, dy, dh_last, states,
                                ddt, da, db, dc, dd, dx, dh0, part_bc,
                                part_ad, B, S, Di, dt_sb, dt_ss, b_sb, b_ss,
                                c_sb, c_ss, x_sb, x_ss, dy_sb, dy_ss, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
