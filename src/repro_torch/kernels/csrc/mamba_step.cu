// Mamba-1 decode step, the mixer's single-token recurrence after its
// projections, in two kernels (a GEMM, x_proj, sits between them):
//
//   mamba_conv_step: xc = silu(sum_k conv_in[k] * w[k] + conv_b) over the
//     window conv_in = [conv state (K - 1 taps), x_new], and the conv
//     state shifted by one tap in place;
//   mamba_ssm_step: dt = softplus(dt_raw + dt_bias), A = -exp(A_log),
//     h = exp(dt * A) * h + (dt * x) * B in place, y = h . C + D * x,
//     out = y * silu(z).
//
// Replaces: the op chain of models/mamba.py mamba_decode, which the JAX
// model (src/repro/models/mamba.py mamba_decode) writes in jnp and which
// has no TPU kernel; the chain moved unchanged to kernels/ref.py
// mamba_conv_step_ref and mamba_ssm_step_ref, the plain versions.
//
// Bound on the H100: at falcon-mamba-7b's decode (B 32, Di 8192, N 16) the
// f32 state is read once and written once, 2 x 16.8 MB a layer, 10.0 us at
// 3.35 TB/s; everything else (A_log, the (B, Di) vectors) adds about 3 %.
// The chain it replaces makes about seven passes over (B, Di, N) f32
// tensors with a read and a write each, and some 25 launches a layer.
//
// Same rounding as the chain, op for op: every product and sum that the
// chain rounds separately is __fmul_rn / __fadd_rn here (no FMA
// contraction), the exponentials are the accurate expf and log1pf that
// torch's CUDA kernels call, softplus has torch's threshold of 20, and the
// activations are rounded to their dtype where the chain stores them
// (the conv sum, + conv_b, silu, y, silu(z), the product). So the state is
// the chain's bits on the card; only y's sum over N (the chain's f32 bmm
// in cuBLAS) and the conv's over K follow another order.
//
// SSM design: a thread owns 4 consecutive states of one channel, so
// G = N / 4 lanes hold a channel and a warp reads 32 x 16 = 512
// contiguous bytes of the state (and of A_log); 128 threads a block, the
// grid (Di / (128 / G), B). B and C of the block's row go to shared
// memory once; a channel's y is summed over its G lanes by shuffles. The
// state's loads and stores are streaming (__ldcs / __stcs: nothing reads
// it again within the step). Chosen on the H100 at B 32 (PERF.md, PR 33),
// in shares of the bound: streaming 0.73 against plain loads and stores
// 0.68 at 256 threads; a block stepping 2, 4 or 8 rows (A computed once
// for them, more loads in flight a thread) 0.67, 0.65, 0.59; in a second
// call 128 threads 0.71, 256 0.685, 512 0.63, 1024 0.59. The conv kernel
// shares the block size; at B 32 it is near a launch's fixed cost.
//
// C entry points (each returns cudaGetLastError()):
//   mamba_conv_step_launch(x_new, conv, w, bias, out, B, Di, K, xn_sb,
//     cv_sb, cv_sk, dtype, conv_dtype, stream): x_new (B, Di) by its row
//     stride, conv (B, K - 1, Di) by its row and tap strides (unit channel
//     stride), w (K, Di) and bias (Di,) contiguous in the activation dtype,
//     out (B, Di) contiguous in the activation dtype; K 2-4; dtype 0 =
//     float32, 1 = bfloat16; conv_dtype the same codes, bfloat16 under a
//     float32 activation allowed (the narrow pool: read widened, written
//     rounded), float32 under bfloat16 not.
//   mamba_ssm_step_launch(dt_raw, dt_bias, a_log, b, c, d, x, z, h, out, B,
//     Di, N, dt_sb, b_sb, c_sb, x_sb, z_sb, h_sb, dtype, stream): dt_raw,
//     b, c, x, z (B, Di or N) by their row strides with unit last stride in
//     the activation dtype; dt_bias (Di,), a_log (Di, N), d (Di,) float32
//     contiguous; h (B, Di, N) float32 by its row stride, contiguous within
//     a row, 16-byte aligned; out (B, Di) contiguous in the activation
//     dtype; N 4, 8 or 16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and read back as float: the value the chain stores
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// torch's silu: x / (1 + exp(-x)) in float
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

template <typename T, typename TP, int K>
__global__ void __launch_bounds__(kThreads)
mamba_conv_step_kernel(const T* __restrict__ x_new, TP* __restrict__ conv,
                       const T* __restrict__ w, const T* __restrict__ bias,
                       T* __restrict__ out, int Di, long long xn_sb,
                       long long cv_sb, long long cv_sk) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (i >= Di) return;
  TP* cv = conv + row * cv_sb + i;
  float win[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) win[k] = to_f(cv[k * cv_sk]);
  win[K - 1] = to_f(x_new[row * xn_sb + i]);
  // in the chain's dtype T: the concatenation is in T, so a narrow pool's
  // taps widen exactly and x_new keeps its value
  float s = __fmul_rn(win[0], to_f(w[i]));
#pragma unroll
  for (int k = 1; k < K; ++k)
    s = __fadd_rn(s, __fmul_rn(win[k], to_f(w[static_cast<long long>(k) * Di
                                              + i])));
  const float v = round_to<T>(__fadd_rn(round_to<T>(s), to_f(bias[i])));
  out[static_cast<long long>(row) * Di + i] = from_f<T>(silu(v));
#pragma unroll
  for (int k = 0; k < K - 1; ++k) cv[k * cv_sk] = from_f<TP>(win[k + 1]);
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
mamba_ssm_step_kernel(const T* __restrict__ dt_raw,
                      const float* __restrict__ dt_bias,
                      const float* __restrict__ a_log,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ dvec,
                      const T* __restrict__ x, const T* __restrict__ z,
                      float* __restrict__ h, T* __restrict__ out, int Di,
                      long long dt_sb, long long b_sb, long long c_sb,
                      long long x_sb, long long z_sb, long long h_sb) {
  constexpr int G = N / 4;                 // lanes a channel
  constexpr int CPB = kThreads / G;        // channels a block
  static_assert(N % 4 == 0 && 32 % G == 0 && N <= kThreads, "N");
  __shared__ __align__(16) float sb[N];
  __shared__ __align__(16) float sc[N];
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  if (tid < N) {
    sb[tid] = to_f(bm[row * b_sb + tid]);
    sc[tid] = to_f(cm[row * c_sb + tid]);
  }
  const int i = blockIdx.x * CPB + tid / G;
  const int part = tid % G;
  const bool live = i < Di;
  float* hp = h + row * h_sb + static_cast<long long>(i) * N + part * 4;
  // the state is read once and written once: streamed past the caches
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f), al = hv;
  float dtv = 0.f, xv = 0.f;
  if (live) {
    hv = __ldcs(reinterpret_cast<const float4*>(hp));
    al = *reinterpret_cast<const float4*>(
        a_log + static_cast<long long>(i) * N + part * 4);
    dtv = __fadd_rn(to_f(dt_raw[row * dt_sb + i]), dt_bias[i]);
    dtv = dtv > 20.f ? dtv : log1pf(expf(dtv));     // torch's softplus
    xv = to_f(x[row * x_sb + i]);
  }
  __syncthreads();                         // B and C of the row are in
  const float dtx = __fmul_rn(dtv, xv);
  float hs[4] = {hv.x, hv.y, hv.z, hv.w};
  const float as[4] = {al.x, al.y, al.z, al.w};
  float ysum = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = part * 4 + k;
    const float da = expf(__fmul_rn(dtv, -expf(as[k])));
    hs[k] = __fadd_rn(__fmul_rn(da, hs[k]), __fmul_rn(dtx, sb[n]));
    ysum = fmaf(hs[k], sc[n], ysum);
  }
  if (live)
    __stcs(reinterpret_cast<float4*>(hp),
           make_float4(hs[0], hs[1], hs[2], hs[3]));
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    ysum += __shfl_xor_sync(0xffffffffu, ysum, o);
  if (live && part == 0) {
    const float y = __fadd_rn(ysum, __fmul_rn(xv, dvec[i]));
    const float g = round_to<T>(silu(to_f(z[row * z_sb + i])));
    out[row * Di + i] = from_f<T>(__fmul_rn(round_to<T>(y), g));
  }
}

template <typename T, typename TP>
cudaError_t conv_launch(int K, const void* x_new, void* conv, const void* w,
                        const void* bias, void* out, int B, int Di,
                        long long xn_sb, long long cv_sb, long long cv_sk,
                        cudaStream_t stream) {
  const dim3 grid((Di + kThreads - 1) / kThreads, B);
#define CONV_ARGS                                                          \
  static_cast<const T*>(x_new), static_cast<TP*>(conv),                    \
      static_cast<const T*>(w), static_cast<const T*>(bias),               \
      static_cast<T*>(out), Di, xn_sb, cv_sb, cv_sk
  switch (K) {
    case 2:
      mamba_conv_step_kernel<T, TP, 2><<<grid, kThreads, 0, stream>>>(
          CONV_ARGS);
      break;
    case 3:
      mamba_conv_step_kernel<T, TP, 3><<<grid, kThreads, 0, stream>>>(
          CONV_ARGS);
      break;
    case 4:
      mamba_conv_step_kernel<T, TP, 4><<<grid, kThreads, 0, stream>>>(
          CONV_ARGS);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef CONV_ARGS
  return cudaGetLastError();
}

template <typename T>
cudaError_t ssm_launch(int N, const void* dt_raw, const void* dt_bias,
                       const void* a_log, const void* b, const void* c,
                       const void* d, const void* x, const void* z, void* h,
                       void* out, int B, int Di, long long dt_sb,
                       long long b_sb, long long c_sb, long long x_sb,
                       long long z_sb, long long h_sb, cudaStream_t stream) {
#define SSM_ARGS                                                           \
  static_cast<const T*>(dt_raw), static_cast<const float*>(dt_bias),       \
      static_cast<const float*>(a_log), static_cast<const T*>(b),          \
      static_cast<const T*>(c), static_cast<const float*>(d),              \
      static_cast<const T*>(x), static_cast<const T*>(z),                  \
      static_cast<float*>(h), static_cast<T*>(out), Di, dt_sb, b_sb, c_sb, \
      x_sb, z_sb, h_sb
  if (N != 4 && N != 8 && N != 16) return cudaErrorInvalidValue;
  const int cpb = kThreads / (N / 4);
  const dim3 grid((Di + cpb - 1) / cpb, B);
  switch (N) {
    case 4:
      mamba_ssm_step_kernel<4, T><<<grid, kThreads, 0, stream>>>(SSM_ARGS);
      break;
    case 8:
      mamba_ssm_step_kernel<8, T><<<grid, kThreads, 0, stream>>>(SSM_ARGS);
      break;
    case 16:
      mamba_ssm_step_kernel<16, T><<<grid, kThreads, 0, stream>>>(SSM_ARGS);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef SSM_ARGS
  return cudaGetLastError();
}

}  // namespace

extern "C" int mamba_conv_step_launch(
    const void* x_new, void* conv, const void* w, const void* bias, void* out,
    int B, int Di, int K, long long xn_sb, long long cv_sb, long long cv_sk,
    int dtype, int conv_dtype, void* stream) {
  if (B < 1 || Di < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && conv_dtype == 1) {
    err = conv_launch<__nv_bfloat16, __nv_bfloat16>(
        K, x_new, conv, w, bias, out, B, Di, xn_sb, cv_sb, cv_sk, s);
  } else if (dtype == 0 && conv_dtype == 0) {
    err = conv_launch<float, float>(K, x_new, conv, w, bias, out, B, Di,
                                    xn_sb, cv_sb, cv_sk, s);
  } else if (dtype == 0 && conv_dtype == 1) {
    err = conv_launch<float, __nv_bfloat16>(K, x_new, conv, w, bias, out, B,
                                            Di, xn_sb, cv_sb, cv_sk, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" int mamba_ssm_step_launch(
    const void* dt_raw, const void* dt_bias, const void* a_log, const void* b,
    const void* c, const void* d, const void* x, const void* z, void* h,
    void* out, int B, int Di, int N, long long dt_sb, long long b_sb,
    long long c_sb, long long x_sb, long long z_sb, long long h_sb, int dtype,
    void* stream) {
  if (B < 1 || Di < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = ssm_launch<float>(N, dt_raw, dt_bias, a_log, b, c, d, x, z, h, out,
                            B, Di, dt_sb, b_sb, c_sb, x_sb, z_sb, h_sb, s);
  } else if (dtype == 1) {
    err = ssm_launch<__nv_bfloat16>(N, dt_raw, dt_bias, a_log, b, c, d, x, z,
                                    h, out, B, Di, dt_sb, b_sb, c_sb, x_sb,
                                    z_sb, h_sb, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
