// Top-1 minus top-2 certainty gap and argmax over the vocab (paper Eq. 5).
//
// Replaces: src/repro/kernels/top2gap.py, _top2gap_kernel / top2gap_pallas
// (the TPU kernel streams (8, 512) vocab blocks through VMEM and carries
// (top1, top2, argmax) in scratch across the sequential vocab grid axis).
//
// Bound on the H100: memory. Each row is read once (B x V x 4 bytes of f32
// logits, 4.9 MB at B = 8, V = 151,936, about 1.5 us at 3.35 TB/s) and the
// work is one compare or two per element, far below the compute roofline.
// One SM alone pulls a row at some tens of GB/s, so the bytes in flight
// have to come from many SMs: at the decode batch (B 1-8) a block per row
// would use 1-8 of the 132.
//
// Design: one launch splits each row across a thread-block cluster of G
// blocks; the grid is G x B blocks, cluster b holding row b. The row's
// 16-byte-aligned body is cut into G contiguous slices of 16-byte
// vectors; block r walks the r-th slice with every load of a thread's
// share in flight at once (8 per thread, predicated), in increasing index
// order, keeping its own (m1, m2, i1).
// The unaligned head of the row (before its first 16-byte boundary: rows
// of a wider buffer, or a view that starts off a boundary) goes to the
// first threads of rank 0 and the tail to those of rank G - 1, so every
// thread still sees its indices in increasing order; slices of short rows
// may be empty. A block's 512 triples merge with warp shuffles and once
// more through shared memory; each block then writes its triple into rank
// 0's shared memory (distributed shared memory), and rank 0 merges the G
// triples and writes gap and index. Two cluster barriers order this: the
// first (every block has started, so rank 0's shared memory may be
// written) is split, its arrive at the top of the kernel and its wait after
// the loads, so only the second (the triples have landed) is exposed; every
// thread of every block reaches both. The merge rule keeps
// exact ties exact: m2 = max(min(a.m1, b.m1), a.m2, b.m2), so two equal
// maxima give gap 0, and on equal m1 the lower index wins, at every level
// (thread, warp, block, cluster); it is associative and commutative, so
// the split changes no result.
//
// G = 16, the largest cluster the H100 schedules (above the portable 8, so
// the kernel allows it once, at its first launch). Against clusters of 8
// on the H100 (PERF.md), 16 was the faster at V 151,936 (the qwen2 vocab,
// most of the launches) at B 8 and B 1, and 8 was faster by about 0.15 us
// at V 65,024 and 0.4 us at V 4,096; one size keeps one instantiation per
// dtype. What is left is mostly fixed cost that a row of 0.6-4.9 MB does
// not amortise: the launch, one cluster barrier and one round trip to
// device memory.
//
// C entry point: top2gap_launch(scores, gap, idx, B, V, row_stride, dtype,
// stream) with dtype 0 = float32, 1 = bfloat16; returns the first CUDA
// error of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 8;
constexpr int kCluster = 16;  // blocks per row (G)

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

__device__ __forceinline__ Top2 warp_merge(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.m1 = __shfl_xor_sync(0xffffffffu, t.m1, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, t.m2, off);
    o.i1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
    t = merge(t, o);
  }
  return t;
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
  constexpr int E = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < E; ++u) push(t, to_f(e[u]), j0 + u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
top2gap_kernel(const T* __restrict__ scores, float* __restrict__ gap,
               int* __restrict__ idx, int V, long long row_stride) {
  constexpr int E = 16 / sizeof(T);     // elements per 16-byte vector
  constexpr int G = kCluster;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / G;
  const T* x = scores + static_cast<long long>(b) * row_stride;
  const int tid = threadIdx.x;

  // the row: `head` elements up to its first 16-byte boundary, nvec
  // vectors, then the tail from body_end
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(x) % 16) / sizeof(T));
  const int head = min(V, mis ? E - mis : 0);
  const int nvec = (V - head) / E;
  const int body_end = head + nvec * E;
  const int per = (nvec + G - 1) / G;
  const int v0 = min(nvec, rank * per);
  const int v1 = min(nvec, v0 + per);

  // first cluster barrier, split: arrive now, wait once the slice is read,
  // so its latency hides behind the loads
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  Top2 t = empty_top2();
  if (rank == 0 && tid < head) push(t, to_f(x[tid]), tid);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (int c = v0 + tid; c < v1; c += kUnroll * kThreads) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c + u * kThreads < v1) r[u] = __ldg(xv + c + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c + u * kThreads < v1)
        push_vec<T>(t, r[u], head + (c + u * kThreads) * E);
  }
  if (rank == G - 1 && body_end + tid < V)
    push(t, to_f(x[body_end + tid]), body_end + tid);

  __shared__ Top2 part[kThreads / 32];
  __shared__ Top2 slots[G];   // rank 0's: one block triple per rank
  const int warp = tid >> 5;
  const int lane = tid & 31;
  t = warp_merge(t);
  if (lane == 0) part[warp] = t;
  __syncthreads();
  // every block of the cluster has started (the arrive at the top), so
  // rank 0's shared memory may be written
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
    t = warp_merge(lane < kThreads / 32 ? part[lane] : empty_top2());
    if (lane == 0) *cluster.map_shared_rank(&slots[rank], 0) = t;
  }
  // release the triple written above; rank 0 acquires all G of them
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (rank == 0 && warp == 0) {
    t = warp_merge(lane < G ? slots[lane] : empty_top2());
    if (lane == 0) {
      gap[b] = t.m1 - t.m2;
      idx[b] = t.i1;
    }
  }
}

template <typename T>
cudaError_t launch(const void* scores, void* gap, void* idx, int B, int V,
                   long long row_stride, cudaStream_t stream) {
  // clusters above 8 blocks are opt-in; allowed once per process
  static const cudaError_t allowed = cudaFuncSetAttribute(
      top2gap_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, top2gap_kernel<T>, static_cast<const T*>(scores),
      static_cast<float*>(gap), static_cast<int*>(idx), V, row_stride);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" int top2gap_launch(const void* scores, void* gap, void* idx,
                              int B, int V, long long row_stride, int dtype,
                              void* stream) {
  if (B < 1 || B > INT_MAX / kCluster || V < 2)
    return static_cast<int>(cudaErrorInvalidValue);
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
