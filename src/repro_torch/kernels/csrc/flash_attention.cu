// Causal (optionally sliding-window) or full flash attention with GQA.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention_pallas (the TPU kernel runs the grid (B, H, S/BQ, S/BK)
// with KV blocks innermost, carrying online-softmax state in VMEM scratch;
// its K/V index map sends query head h to KV head h // G). It is the
// function of models/attention.py prefill_attention / attention_forward,
// which the model runs in every layer at every prefill.
//
// Bound on the H100: at prefill lengths of a few hundred tokens the causal
// score and P.V products (4 * hd flops per query-key pair and head) weigh
// more than the bytes of q, k, v and the output, so the bound is the
// tensor-core rate (989 TFLOP/s in bf16); at short lengths it is memory.
//
// Design (first, simple version: CUDA cores, not yet wgmma): grid
// (ceil(S / 64), H, B); a block of 64 threads serves 64 query rows of one
// head, one row per thread, with that row's scaled query and its f32
// accumulator in registers. The block walks the key tiles its rows can see
// (up to the causal limit, from the window's start), staging each 32-key
// tile of K and V (from KV head h / G) in shared memory as f32 with 16-byte
// loads. Every thread then reads the same K/V row at the same time, which
// shared memory serves as a broadcast. Scores, max, exp and the rescaled
// accumulator stay in registers (online softmax in f32). q, k, v and the
// output are read and written in the model's (B, S, heads, hd) layout by
// the strides the wrapper passes, so no transpose is made. Moving the two
// products onto wgmma with TMA-fed tiles is the work of a later change.
// Instantiated for hd 32 and 64: at hd 128 the per-thread query and
// accumulator rows no longer fit the register file (ptxas spills), which
// the wgmma version will not need.
//
// C entry point: flash_attention_launch(q, k, v, out, B, S, H, KV, D, q_sb,
// q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal, window, dtype, stream);
// head stride D and element stride 1 for every tensor; dtype 0 = float32,
// 1 = bfloat16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 64;   // query rows (threads) per block
constexpr int kKeys = 32;   // keys per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             int KV, long long q_sb, long long q_ss, long long k_sb,
             long long k_ss, long long v_sb, long long v_ss, long long o_sb,
             long long o_ss, int causal, int window, float scale) {
  constexpr int VE = 16 / sizeof(T);      // elements per 16-byte load
  constexpr int CHUNKS = D / VE;          // 16-byte loads per row
  __shared__ __align__(16) float k_s[kKeys][D];
  __shared__ __align__(16) float v_s[kKeys][D];

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int qi = q0 + tid;
  const bool row_ok = qi < S;

  float qr[D], acc[D];
  if (row_ok) {
    const uint4* src = reinterpret_cast<const uint4*>(
        q + b * q_sb + qi * q_ss + static_cast<long long>(h) * D);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const uint4 raw = __ldg(src + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < VE; ++u) qr[c * VE + u] = to_f(e[u]) * scale;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  // keys this block's rows can see: [k_lo, k_hi)
  int k_hi = S, k_lo = 0;
  if (causal) {
    k_hi = min(S, q0 + kRows);
    if (window > 0) k_lo = max(0, q0 - window + 1) / kKeys * kKeys;
  }
  const T* kb = k + b * k_sb + static_cast<long long>(kvh) * D;
  const T* vb = v + b * v_sb + static_cast<long long>(kvh) * D;

  for (int kt = k_lo; kt < k_hi; kt += kKeys) {
    __syncthreads();   // the previous tile is consumed
    for (int i = tid; i < kKeys * CHUNKS; i += kRows) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const int kj = kt + r;
      float kf[VE], vf[VE];
      if (kj < S) {
        const uint4 kraw = __ldg(reinterpret_cast<const uint4*>(
            kb + kj * k_ss) + c);
        const uint4 vraw = __ldg(reinterpret_cast<const uint4*>(
            vb + kj * v_ss) + c);
        const T* ke = reinterpret_cast<const T*>(&kraw);
        const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int u = 0; u < VE; ++u) {
          kf[u] = to_f(ke[u]);
          vf[u] = to_f(ve[u]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < VE; ++u) kf[u] = vf[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VE; ++u) {
        k_s[r][c * VE + u] = kf[u];
        v_s[r][c * VE + u] = vf[u];
      }
    }
    __syncthreads();
    if (!row_ok) continue;

    float s[kKeys];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int kj = kt + r;
      bool keep = kj < S;
      if (causal) {
        keep = keep && kj <= qi;
        if (window > 0) keep = keep && kj > qi - window;
      }
      float dot = 0.f;
      const float4* kr = reinterpret_cast<const float4*>(&k_s[r][0]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      s[r] = keep ? dot : -INFINITY;
      mx = fmaxf(mx, s[r]);
    }
    if (mx == -INFINITY) continue;   // no visible key in this tile
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);   // 0 while m is still -inf
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const float p = s[r] == -INFINITY ? 0.f : __expf(s[r] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(&v_s[r][0]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* dst = out + b * o_sb + qi * o_ss + static_cast<long long>(h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = from_f<T>(acc[d] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int H, int KV, long long q_sb,
                     long long q_ss, long long k_sb, long long k_ss,
                     long long v_sb, long long v_ss, long long o_sb,
                     long long o_ss, int causal, int window,
                     cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, q_sb, q_ss,
      k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int D, long long q_sb,
                   long long q_ss, long long k_sb, long long k_ss,
                   long long v_sb, long long v_ss, long long o_sb,
                   long long o_ss, int causal, int window,
                   cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, out, B, S, H, KV, q_sb, q_ss, k_sb,
                             k_ss, v_sb, v_ss, o_sb, o_ss, causal, window,
                             stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, B, S, H, KV, q_sb, q_ss, k_sb,
                             k_ss, v_sb, v_ss, o_sb, o_ss, causal, window,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int KV, int D, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, long long o_sb,
    long long o_ss, int causal, int window, int dtype, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, out, B, S, H, KV, D, q_sb, q_ss, k_sb, k_ss,
                        v_sb, v_ss, o_sb, o_ss, causal, window, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, q_sb, q_ss,
                                k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal,
                                window, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
