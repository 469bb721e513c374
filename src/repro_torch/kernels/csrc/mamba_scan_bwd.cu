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
//   dA    = sum_{b,t} g_t dt_t e_t h_{t-1}   dD = sum_{b,t} dy_t x_t
//   dh0   = e_0 g_0
//
// Replaces: no TPU kernel. The JAX model differentiates its jnp
// selective_scan (src/repro/models/mamba.py:75, a chunked associative scan
// inside lax.scan) with XLA; the port's forward runs csrc/mamba_scan.cu,
// so its gradient needs a kernel of its own.
//
// Bound on the H100: at falcon-mamba-7b's training shape (B 4, S 512,
// Di 8192, N 16, x bf16) dt, x, dy, ddt and dx are about 270 MB (0.08 ms at
// 3.35 TB/s); the states are not saved by the forward, so they are
// recomputed, and the decays e_t are needed once for that and once for the
// reverse pass: 2 x 268 M exponentials, 0.13 ms at the special-function
// units' 16 results per clock per SM. So the exponentials bind. This kernel
// takes each decay three times (the states at the chunk boundaries, the
// chunk's states again, the reverse step), and its per-step reductions over
// channels are shuffles: it is a simple kernel, not a fast one.
//
// Design: one block owns one batch row and 32 channels, as the forward
// does: a thread holds K = 4 consecutive states of one channel, G = N / 4
// lanes a channel, 32 * G threads. The recurrence is per channel, so a
// block needs no other block's states:
//   1. it walks the sequence forward, states only, and stores the state
//      entering each chunk of L = 32 steps into a scratch buffer
//      (B, ceil(S / L), Di, N), which only the thread that wrote an entry
//      reads back;
//   2. it walks the chunks in reverse: it stages the chunk's dt, x, dy, B
//      and C in shared memory, recomputes the chunk's states from the
//      stored one into shared memory (each thread its own column of
//      16 bytes a step), then runs the reverse recurrence in registers.
//      dx and ddt (sums over the channel's lanes: shuffles) go through a
//      shared-memory tile to coalesced stores. dB_t and dC_t sum over all
//      Di channels: each warp sums its channels with shuffles, the block
//      adds its warps in order and writes one partial per block row, and
//      dA and dD (sums over b and t) stay in registers and are written
//      per batch row;
//   3. a second kernel adds the partials in a fixed order.
// No atomics: two calls give the same bits. Steps past S are never run
// (a chunk's loops stop at S), and channels past Di carry zeros (decay 1,
// input 0, dy 0) and write nothing.
//
// C entry point: mamba_scan_bwd_launch(dt, a, b, c, d, x, h0, dy, dh_last,
// ddt, da, db, dc, dd, dx, dh0, ckpt, part_bc, part_ad, B, S, Di, N, dt_sb,
// dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss, dy_sb, dy_ss, x_dtype,
// stream): dt, b, c, x and dy are read by their (batch, step) element
// strides with unit stride on the last axis; a (Di, N), d (Di,), h0 and
// dh_last (B, Di, N) (each may be null: zero) are contiguous float32;
// outputs ddt (B, S, Di), da (Di, N), db and dc (B, S, N), dd (Di,),
// dh0 (B, Di, N) (null: not written) are contiguous float32 and dx
// (B, S, Di) contiguous in x's dtype; scratch ckpt (B, ceil(S / 32), Di,
// N), part_bc (2, B, ceil(Di / 32), S, N) and part_ad (B, Di * (N + 1))
// float32. N 4, 8 or 16; x_dtype 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kCh = 32;       // channels per block
constexpr int kChunk = 32;    // steps per chunk (L)
constexpr int kStates = 4;    // states a thread carries (K)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// the shared-memory layout of one block, in floats
template <int N>
struct Layout {
  static constexpr int NT = kCh * N / kStates;       // threads
  static constexpr int W = NT / 32;                  // warps
  static constexpr int H = 0;                              // [L][NT][K]
  static constexpr int DT = H + kChunk * NT * kStates;     // [L][kCh]
  static constexpr int X = DT + kChunk * kCh;              // [L][kCh]
  static constexpr int DY = X + kChunk * kCh;              // [L][kCh]
  static constexpr int B = DY + kChunk * kCh;              // [L][N]
  static constexpr int C = B + kChunk * N;                 // [L][N]
  static constexpr int DX = C + kChunk * N;                // [L][kCh]
  static constexpr int DDT = DX + kChunk * kCh;            // [L][kCh]
  static constexpr int RED = DDT + kChunk * kCh;           // [2][W][L][N]
  static constexpr int FLOATS = RED + 2 * W * kChunk * N;
  static constexpr int BYTES = FLOATS * 4;
};

template <int N, typename TX>
__global__ void __launch_bounds__(kCh * N / kStates)
mamba_scan_bwd_kernel(
    const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ dvec, const TX* __restrict__ x,
    const float* __restrict__ h0, const float* __restrict__ dy,
    const float* __restrict__ dh_last, float* __restrict__ ddt,
    TX* __restrict__ dx, float* __restrict__ dh0, float* __restrict__ ckpt,
    float* __restrict__ part_bc, float* __restrict__ part_ad, int B, int S,
    int Di, long long dt_sb, long long dt_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, long long x_sb, long long x_ss,
    long long dy_sb, long long dy_ss) {
  constexpr int K = kStates;
  constexpr int G = N / K;                 // lanes per channel
  using Lay = Layout<N>;
  constexpr int NT = Lay::NT;
  static_assert(K <= N && N % K == 0 && NT % 32 == 0, "K, N");
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem + Lay::H;
  float* s_dt = smem + Lay::DT;
  float* s_x = smem + Lay::X;
  float* s_dy = smem + Lay::DY;
  float* s_b = smem + Lay::B;
  float* s_c = smem + Lay::C;
  float* s_dx = smem + Lay::DX;
  float* s_ddt = smem + Lay::DDT;
  float* s_red = smem + Lay::RED;

  const int tid = threadIdx.x;
  const int cl = tid / G;                  // channel within the block
  const int gl = tid % G;                  // lane within the channel
  const int warp = tid / 32;
  const int row = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int i0 = blk * kCh;
  const int i = i0 + cl;
  const bool live = i < Di;
  const int nc = (S + kChunk - 1) / kChunk;
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
  const float* b_r = bm + row * b_sb;
  const float* c_r = cm + row * c_sb;
  const TX* x_r = x + row * x_sb;
  const float* dy_r = dy + row * dy_sb;

  // a chunk's T steps of the block's channels (zeros past Di) and of B
  // (and C and dy with `all`) into shared memory
  auto stage = [&](int t0, int T, bool all) {
    for (int e = tid; e < T * kCh; e += NT) {
      const int tt = e / kCh, ch = e % kCh;
      const bool in = i0 + ch < Di;
      const long long t = t0 + tt;
      s_dt[e] = in ? dt_r[t * dt_ss + i0 + ch] : 0.f;
      s_x[e] = in ? to_f(x_r[t * x_ss + i0 + ch]) : 0.f;
      if (all) s_dy[e] = in ? dy_r[t * dy_ss + i0 + ch] : 0.f;
    }
    for (int e = tid; e < T * N; e += NT) {
      const long long t = t0 + e / N;
      s_b[e] = b_r[t * b_ss + e % N];
      if (all) s_c[e] = c_r[t * c_ss + e % N];
    }
  };
  // the chunk's forward steps from h, storing each state when `keep`
  auto forward = [&](float (&h)[K], int T, bool keep) {
    for (int tt = 0; tt < T; ++tt) {
      const float dtv = s_dt[tt * kCh + cl];
      const float dtx = dtv * s_x[tt * kCh + cl];
      const float4 bq = *reinterpret_cast<const float4*>(
          &s_b[tt * N + gl * K]);
      const float bk[K] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int k = 0; k < K; ++k)
        h[k] = fmaf(ex2(dtv * a2[k]), h[k], dtx * bk[k]);
      if (keep)
        *reinterpret_cast<float4*>(&s_h[(tt * NT + tid) * K]) =
            make_float4(h[0], h[1], h[2], h[3]);
    }
  };

  // 1. the state entering every chunk
  float* ck = ckpt + (static_cast<long long>(row) * nc * Di + i) * N
      + gl * K;
  const long long ck_step = static_cast<long long>(Di) * N;
  {
    float h[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      h[k] = (live && h0 != nullptr) ? h0[state0 + k] : 0.f;
    for (int c = 0; c < nc; ++c) {
      if (live)
        *reinterpret_cast<float4*>(ck + c * ck_step) =
            make_float4(h[0], h[1], h[2], h[3]);
      if (c + 1 == nc) break;          // the last chunk's states: step 2
      __syncthreads();
      stage(c * kChunk, kChunk, false);
      __syncthreads();
      forward(h, kChunk, false);
    }
  }

  // 2. the chunks in reverse
  float g[K], acc_a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    g[k] = (live && dh_last != nullptr) ? dh_last[state0 + k] : 0.f;
    acc_a[k] = 0.f;
  }
  float acc_d = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int T = min(kChunk, S - t0);
    __syncthreads();                   // the last chunk's tiles are read
    stage(t0, T, true);
    __syncthreads();
    float hs[K], h[K];
    if (live) {
      const float4 q = *reinterpret_cast<const float4*>(ck + c * ck_step);
      hs[0] = q.x; hs[1] = q.y; hs[2] = q.z; hs[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) hs[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] = hs[k];
    forward(h, T, true);               // s_h: this thread's h_t, t in chunk
    for (int tt = T - 1; tt >= 0; --tt) {
      const float dtv = s_dt[tt * kCh + cl];
      const float xv = s_x[tt * kCh + cl];
      const float dyv = s_dy[tt * kCh + cl];
      const float dtx = dtv * xv;
      const float4 bq = *reinterpret_cast<const float4*>(
          &s_b[tt * N + gl * K]);
      const float4 cq = *reinterpret_cast<const float4*>(
          &s_c[tt * N + gl * K]);
      const float4 htq = *reinterpret_cast<const float4*>(
          &s_h[(tt * NT + tid) * K]);
      float hp[K];
      if (tt > 0) {
        const float4 q = *reinterpret_cast<const float4*>(
            &s_h[((tt - 1) * NT + tid) * K]);
        hp[0] = q.x; hp[1] = q.y; hp[2] = q.z; hp[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) hp[k] = hs[k];
      }
      const float bk[K] = {bq.x, bq.y, bq.z, bq.w};
      const float cc[K] = {cq.x, cq.y, cq.z, cq.w};
      const float ht[K] = {htq.x, htq.y, htq.z, htq.w};
      float pb[K], pc[K], sdx = 0.f, sddt = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float e = ex2(dtv * a2[k]);
        const float gk = fmaf(dyv, cc[k], g[k]);
        pc[k] = dyv * ht[k];
        pb[k] = gk * dtx;
        sdx = fmaf(gk, bk[k], sdx);
        const float eh = e * hp[k];
        sddt = fmaf(gk, fmaf(av[k], eh, bk[k] * xv), sddt);
        acc_a[k] = fmaf(gk * dtv, eh, acc_a[k]);
        g[k] = e * gk;
      }
      // the channel's lanes: dx and ddt
#pragma unroll
      for (int o = 1; o < G; o <<= 1) {
        sdx += __shfl_xor_sync(0xffffffffu, sdx, o);
        sddt += __shfl_xor_sync(0xffffffffu, sddt, o);
      }
      // the warp's channels: dB_t and dC_t for the lane's states
#pragma unroll
      for (int o = G; o < 32; o <<= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          pb[k] += __shfl_xor_sync(0xffffffffu, pb[k], o);
          pc[k] += __shfl_xor_sync(0xffffffffu, pc[k], o);
        }
      }
      if (gl == 0) {
        s_dx[tt * kCh + cl] = fmaf(dtv, sdx, d_i * dyv);
        s_ddt[tt * kCh + cl] = sddt;
        acc_d = fmaf(dyv, xv, acc_d);
      }
      if ((tid & 31) < G) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          s_red[(warp * kChunk + tt) * N + gl * K + k] = pb[k];
          s_red[((Lay::W + warp) * kChunk + tt) * N + gl * K + k] = pc[k];
        }
      }
    }
    __syncthreads();
    // the chunk's dx and ddt rows, and the block's dB and dC partials
    float* ddt_r = ddt + (static_cast<long long>(row) * S + t0) * Di + i0;
    TX* dx_r = dx + (static_cast<long long>(row) * S + t0) * Di + i0;
    for (int e = tid; e < T * kCh; e += NT) {
      const int tt = e / kCh, ch = e % kCh;
      if (i0 + ch < Di) {
        ddt_r[static_cast<long long>(tt) * Di + ch] = s_ddt[e];
        from_f(dx_r + static_cast<long long>(tt) * Di + ch, s_dx[e]);
      }
    }
    for (int e = tid; e < 2 * T * N; e += NT) {
      const int which = e / (T * N), r = e % (T * N);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < Lay::W; ++w)
        sum += s_red[((which * Lay::W + w) * kChunk) * N + r];
      part_bc[(((static_cast<long long>(which) * B + row) * nblk + blk)
               * S + t0) * N + r] = sum;
    }
  }
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
// each summed in a fixed order
__global__ void mamba_scan_bwd_reduce(
    const float* __restrict__ part_bc, const float* __restrict__ part_ad,
    float* __restrict__ da, float* __restrict__ db, float* __restrict__ dc,
    float* __restrict__ dd, int B, int S, int Di, int N, int nblk) {
  const long long bsn = static_cast<long long>(B) * S * N;
  const long long sn = static_cast<long long>(S) * N;
  const long long dn = static_cast<long long>(Di) * N;
  const long long total = 2 * bsn + dn + Di;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x)
           + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    if (e < 2 * bsn) {
      const long long which = e / bsn, r = e % bsn;
      const long long row = r / sn, t = r % sn;
      const float* p = part_bc + ((which * B + row) * nblk) * sn + t;
      for (int k = 0; k < nblk; ++k) sum += p[k * sn];
      (which == 0 ? db : dc)[r] = sum;
    } else {
      const long long j = e - 2 * bsn;     // da's entries, then dd's
      for (int row = 0; row < B; ++row)
        sum += part_ad[row * (dn + Di) + j];
      if (j < dn) da[j] = sum; else dd[j - dn] = sum;
    }
  }
}

template <int N, typename TX>
cudaError_t launch_n(const void* dt, const void* a, const void* b,
                     const void* c, const void* d, const void* x,
                     const void* h0, const void* dy, const void* dh_last,
                     void* ddt, void* da, void* db, void* dc, void* dd,
                     void* dx, void* dh0, void* ckpt, void* part_bc,
                     void* part_ad, int B, int S, int Di, long long dt_sb,
                     long long dt_ss, long long b_sb, long long b_ss,
                     long long c_sb, long long c_ss, long long x_sb,
                     long long x_ss, long long dy_sb, long long dy_ss,
                     cudaStream_t stream) {
  using Lay = Layout<N>;
  auto kernel = mamba_scan_bwd_kernel<N, TX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
  if (err != cudaSuccess) return err;
  const int nblk = (Di + kCh - 1) / kCh;
  kernel<<<dim3(nblk, B), Lay::NT, Lay::BYTES, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(d), static_cast<const TX*>(x),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<float*>(ddt),
      static_cast<TX*>(dx), static_cast<float*>(dh0),
      static_cast<float*>(ckpt), static_cast<float*>(part_bc),
      static_cast<float*>(part_ad), B, S, Di, dt_sb, dt_ss, b_sb, b_ss,
      c_sb, c_ss, x_sb, x_ss, dy_sb, dy_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = 2LL * B * S * N + static_cast<long long>(Di) * N
      + Di;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  mamba_scan_bwd_reduce<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                          threads, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_ad),
      static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<float*>(dd), B, S, Di, N, nblk);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(int N, const void* dt, const void* a, const void* b,
                   const void* c, const void* d, const void* x,
                   const void* h0, const void* dy, const void* dh_last,
                   void* ddt, void* da, void* db, void* dc, void* dd,
                   void* dx, void* dh0, void* ckpt, void* part_bc,
                   void* part_ad, int B, int S, int Di, long long dt_sb,
                   long long dt_ss, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss, long long x_sb,
                   long long x_ss, long long dy_sb, long long dy_ss,
                   cudaStream_t stream) {
#define MAMBA_BWD_ARGS                                                     \
  dt, a, b, c, d, x, h0, dy, dh_last, ddt, da, db, dc, dd, dx, dh0, ckpt,  \
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
    void* dx, void* dh0, void* ckpt, void* part_bc, void* part_ad, int B,
    int S, int Di, int N, long long dt_sb, long long dt_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, long long x_sb,
    long long x_ss, long long dy_sb, long long dy_ss, int x_dtype,
    void* stream) {
  if (B < 1 || S < 1 || Di < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0) {
    err = launch<float>(N, dt, a, b, c, d, x, h0, dy, dh_last, ddt, da, db,
                        dc, dd, dx, dh0, ckpt, part_bc, part_ad, B, S, Di,
                        dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, x_sb, x_ss,
                        dy_sb, dy_ss, s);
  } else if (x_dtype == 1) {
    err = launch<__nv_bfloat16>(N, dt, a, b, c, d, x, h0, dy, dh_last, ddt,
                                da, db, dc, dd, dx, dh0, ckpt, part_bc,
                                part_ad, B, S, Di, dt_sb, dt_ss, b_sb, b_ss,
                                c_sb, c_ss, x_sb, x_ss, dy_sb, dy_ss, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
