// One-token GQA decode attention over the model's KV-cache layout.
//
// Replaces: src/repro/kernels/decode_attention.py, _decode_kernel /
// decode_attention_pallas (the TPU kernel walks (B, HKV, C / BC) with the
// cache chunks innermost, carrying online-softmax state in VMEM scratch,
// the G query heads of a group riding along the sublanes so each K/V block
// is read once per group). It is the function of models/attention.py
// decode_attention, which the model runs in every layer at every step.
//
// Bound on the H100: memory. One step reads each valid K and V row once per
// KV group: 4 * hd * KV bytes per valid position per row (bf16), against
// about 4 * hd * H flops per position, far below the tensor-core ridge.
//
// Design: grid (KV, B); a block of 8 warps serves the G <= 8 query heads of
// one KV group of one row, so each K/V row is fetched once for all G heads.
// The cache is read in place in the model's (B, C, KV, hd) layout, by the
// strides the wrapper passes: no transpose or copy per step. Positions are
// cut into tiles of 32; warp w takes tiles w, w + 8, ... For its tile a
// lane owns one position: it reads that K row with 16-byte loads and
// dots it with the G pre-scaled queries held in shared memory. The tile's
// scores update a per-warp online softmax (max and sum by warp shuffles),
// the probabilities go through shared memory, and for P.V each lane owns
// hd / 32 output columns while the warp reads V rows coalesced. The 8 warp
// partials merge through shared memory at the end. Only positions
// < valid_len[b] are read, so ragged rows cost what they hold. All
// arithmetic is f32; output is cast to q's type. q may be f32 over a bf16
// cache (f32 activations over the engine's bf16 slot pool), as the model's
// f32 runs attend. Splitting C across blocks (flash-decoding) to fill more
// SMs at small B is left to later.
//
// C entry point: decode_attention_launch(q, k, v, valid_len, out, B, H, KV,
// C, D, k_sb, k_sc, v_sb, v_sc, dtype, stream): q and out (B, H, D)
// contiguous; k, v with element strides (k_sb, k_sc, D, 1); valid_len (B,)
// int32 on the device; dtype 0 = all float32, 1 = all bfloat16, 2 = float32
// q and out over a bfloat16 cache.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kGMax = 8;
constexpr int kTile = 32;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TQ, typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ valid_len,
              TQ* __restrict__ out, int H, int KV, int C, long long k_sb,
              long long k_sc, long long v_sb, long long v_sc, float scale) {
  constexpr int VE = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int DPL = D / 32;          // output columns per lane
  __shared__ __align__(16) float q_s[kGMax][D];
  __shared__ float p_s[kWarps][kGMax][kTile];
  __shared__ float m_s[kWarps][kGMax];
  __shared__ float l_s[kWarps][kGMax];
  __shared__ float acc_s[kWarps][kGMax][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < kGMax * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    q_s[g][d] = g < G
        ? to_f(q[(static_cast<long long>(b) * H + kvh * G + g) * D + d]) * scale
        : 0.f;
  }
  __syncthreads();

  const int vl = min(max(valid_len[b], 0), C);
  const T* kb = k + b * k_sb + static_cast<long long>(kvh) * D;
  const T* vb = v + b * v_sb + static_cast<long long>(kvh) * D;

  float m[kGMax], l[kGMax], acc[kGMax][DPL];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = warp * kTile; t0 < vl; t0 += kWarps * kTile) {
    const int j = t0 + lane;
    float s[kGMax];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) s[g] = 0.f;
    if (j < vl) {
      const uint4* kr = reinterpret_cast<const uint4*>(kb + j * k_sc);
#pragma unroll
      for (int c = 0; c < D / VE; ++c) {
        const uint4 raw = __ldg(kr + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < VE; ++u) {
          const float kf = to_f(e[u]);
#pragma unroll
          for (int g = 0; g < kGMax; ++g)
            if (g < G) s[g] = fmaf(q_s[g][c * VE + u], kf, s[g]);
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < kGMax; ++g) s[g] = -INFINITY;
    }
    // online softmax over this tile; t0 < vl, so lane 0 holds a real score
    // and the new max is finite
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g < G) {
        const float m_new = fmaxf(m[g], warp_max(s[g]));
        const float p = j < vl ? __expf(s[g] - m_new) : 0.f;
        const float alpha = __expf(m[g] - m_new);
        l[g] = l[g] * alpha + warp_sum(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
        m[g] = m_new;
        p_s[warp][g][lane] = p;
      }
    }
    __syncwarp();
    const int jn = min(kTile, vl - t0);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      const T* vr = vb + (t0 + jj) * v_sc + lane * DPL;
      float vf[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vf[i] = to_f(vr[i]);
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        if (g < G) {
          const float p = p_s[warp][g][jj];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[warp][g][lane * DPL + i] = acc[g][i];
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no position holds m = -inf, l = 0, acc = 0
      const float wt = m_s[w][g] == -INFINITY ? 0.f : __expf(m_s[w][g] - mx);
      den = fmaf(l_s[w][g], wt, den);
      num = fmaf(acc_s[w][g][d], wt, num);
    }
    out[(static_cast<long long>(b) * H + kvh * G + g) * D + d] =
        from_f<TQ>(num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* valid_len, void* out, int B, int H, int KV,
                     int C, long long k_sb, long long k_sc, long long v_sb,
                     long long v_sc, cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_kernel<TQ, T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid_len),
      static_cast<TQ*>(out), H, KV, C, k_sb, k_sc, v_sb, v_sc,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename TQ, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid_len, void* out, int B, int H, int KV,
                   int C, int D, long long k_sb, long long k_sc,
                   long long v_sb, long long v_sc, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<TQ, T, 32>(q, k, v, valid_len, out, B, H, KV, C, k_sb,
                             k_sc, v_sb, v_sc, stream);
    case 64:
      return launch_d<TQ, T, 64>(q, k, v, valid_len, out, B, H, KV, C, k_sb,
                             k_sc, v_sb, v_sc, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid_len,
    void* out, int B, int H, int KV, int C, int D, long long k_sb,
    long long k_sc, long long v_sb, long long v_sc, int dtype,
    void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kGMax || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, float>(q, k, v, valid_len, out, B, H, KV, C, D,
                               k_sb, k_sc, v_sb, v_sc, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, valid_len, out, B,
                                               H, KV, C, D, k_sb, k_sc, v_sb,
                                               v_sc, s);
  } else if (dtype == 2) {
    err = launch<float, __nv_bfloat16>(q, k, v, valid_len, out, B, H, KV, C,
                                       D, k_sb, k_sc, v_sb, v_sc, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
