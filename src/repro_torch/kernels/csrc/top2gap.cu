// Top-1 minus top-2 certainty gap and argmax over the vocab (paper Eq. 5).
//
// Replaces: src/repro/kernels/top2gap.py, _top2gap_kernel / top2gap_pallas
// (the TPU kernel streams (8, 512) vocab blocks through VMEM and carries
// (top1, top2, argmax) in scratch across the sequential vocab grid axis).
//
// Bound on the H100: memory. Each row is read once (B x V x 4 bytes of f32
// logits, 4.9 MB at B = 8, V = 151,936, about 1.5 us at 3.35 TB/s) and the
// work is one compare or two per element, far below the compute roofline.
//
// Design: one block of 1024 threads per row. Each thread walks the row with
// 16-byte loads (four in flight per iteration), in increasing index order,
// keeping its own (m1, m2, i1); the 1024 partial triples then merge with
// warp shuffles and once more through shared memory. The merge rule keeps
// exact ties exact: m2 = max(min(a.m1, b.m1), a.m2, b.m2), so two equal
// maxima give gap 0, and on equal m1 the lower index wins, at every level
// (thread, warp, block). Grid-level splitting of a row across blocks (to
// use more than B of the 132 SMs at small batch) is left to a later change.
//
// C entry point: top2gap_launch(scores, gap, idx, B, V, row_stride, dtype,
// stream) with dtype 0 = float32, 1 = bfloat16; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;

struct Top2 {
  float m1;
  float m2;
  int i1;
};

__device__ __forceinline__ Top2 empty_top2() {
  Top2 t;
  t.m1 = -INFINITY;
  t.m2 = -INFINITY;
  t.i1 = INT_MAX;
  return t;
}

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool take_b = (b.m1 > a.m1) || (b.m1 == a.m1 && b.i1 < a.i1);
  Top2 r;
  r.m1 = take_b ? b.m1 : a.m1;
  r.i1 = take_b ? b.i1 : a.i1;
  r.m2 = fmaxf(fminf(a.m1, b.m1), fmaxf(a.m2, b.m2));
  return r;
}

// Fold element j into a thread's triple. A thread visits its indices in
// increasing order, so ">" keeps the lowest index of a tie in i1 while the
// tied value still lands in m2. The first element is always taken, so a
// row of -inf still reports a real index.
__device__ __forceinline__ void push(Top2& t, float x, int j) {
  if (x > t.m1 || t.i1 == INT_MAX) {
    t.m2 = t.m1;
    t.m1 = x;
    t.i1 = j;
  } else if (x > t.m2) {
    t.m2 = x;
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ void push_vec(Top2& t, const uint4& raw, int j0) {
  constexpr int N = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < N; ++u) push(t, to_f(e[u]), j0 + u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
top2gap_kernel(const T* __restrict__ scores, float* __restrict__ gap,
               int* __restrict__ idx, int V, long long row_stride,
               bool vec_ok) {
  constexpr int N = 16 / sizeof(T);
  const T* x = scores + static_cast<long long>(blockIdx.x) * row_stride;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  Top2 t = empty_top2();
  int tail = 0;
  if (vec_ok) {
    const int nvec = V / N;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    int c = tid;
    for (; c + (kUnroll - 1) * nt < nvec; c += kUnroll * nt) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(xv + c + u * nt);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) push_vec<T>(t, r[u], (c + u * nt) * N);
    }
    for (; c < nvec; c += nt) push_vec<T>(t, __ldg(xv + c), c * N);
    tail = nvec * N;
  }
  for (int j = tail + tid; j < V; j += nt) push(t, to_f(x[j]), j);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.m1 = __shfl_xor_sync(0xffffffffu, t.m1, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, t.m2, off);
    o.i1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
    t = merge(t, o);
  }
  __shared__ Top2 part[32];
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (lane == 0) part[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = lane < (nt >> 5) ? part[lane] : empty_top2();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Top2 o;
      o.m1 = __shfl_xor_sync(0xffffffffu, t.m1, off);
      o.m2 = __shfl_xor_sync(0xffffffffu, t.m2, off);
      o.i1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
      t = merge(t, o);
    }
    if (lane == 0) {
      gap[blockIdx.x] = t.m1 - t.m2;
      idx[blockIdx.x] = t.i1;
    }
  }
}

template <typename T>
cudaError_t launch(const void* scores, void* gap, void* idx, int B, int V,
                   long long row_stride, cudaStream_t stream) {
  const bool vec_ok =
      (reinterpret_cast<uintptr_t>(scores) % 16 == 0) &&
      ((row_stride * static_cast<long long>(sizeof(T))) % 16 == 0);
  top2gap_kernel<T><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(scores), static_cast<float*>(gap),
      static_cast<int*>(idx), V, row_stride, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" int top2gap_launch(const void* scores, void* gap, void* idx,
                              int B, int V, long long row_stride, int dtype,
                              void* stream) {
  if (B < 1 || V < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(scores, gap, idx, B, V, row_stride, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(scores, gap, idx, B, V, row_stride, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
