// Pieces shared by the selective scan's forward (mamba_scan.cu) and
// backward (mamba_scan_bwd.cu): the block's geometry, the f32 view of x,
// the fast decay, the cp.async staging of a 32-step run of an operand into
// shared memory and which operands it may copy by 16 bytes. Both
// kernels lay a block out the same way (32 channels, K = 4 consecutive
// states of one channel a thread), so the state entering a run that the
// forward writes is read back by the thread of the backward that owns the
// same 16 bytes.
// kernels/build.py hashes this header into every library's name.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kCh = 32;       // channels per block
constexpr int kRun = 32;      // steps staged per buffer (a run, or chunk)
constexpr int kStates = 4;    // states a thread carries (K)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 16-byte copy of which the first `bytes` come from src and the rest are
// zero-filled (bytes 0: all zeros, src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>   // wait until at most PENDING groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// One operand's rows of run r (steps r * kRun ...) into buf: kRun rows of
// CPR 16-byte chunks, W elements a row in shared memory, from `row` (step
// 0 of the batch row, element 0) at step stride ss, elements e_lo ... of
// which those at or past n, and rows at or past S, are zero-filled. vec:
// the source chunks are 16-byte aligned (cp.async), else element copies.
template <typename T, int CPR, int W, int NT>
__device__ __forceinline__ void stage_run(T* buf, const T* row, long long ss,
                                          int e_lo, int n, int r, int S,
                                          bool vec, int tid) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int TOTAL = kRun * CPR;
#pragma unroll
  for (int j = 0; j < (TOTAL + NT - 1) / NT; ++j) {
    const int e = tid + j * NT;
    if (TOTAL % NT == 0 || e < TOTAL) {
      const int tt = e / CPR, ch = (e % CPR) * E;
      const int t = r * kRun + tt;
      const int m = t < S ? min(max(n - (e_lo + ch), 0), E) : 0;
      const T* src = row + static_cast<long long>(t) * ss + e_lo + ch;
      T* dst = buf + tt * W + ch;
      if (vec) {
        cp_async16(dst, m > 0 ? src : row, m * static_cast<int>(sizeof(T)));
      } else {
#pragma unroll
        for (int u = 0; u < E; ++u) dst[u] = u < m ? src[u] : T(0.f);
      }
    }
  }
}

// K consecutive floats of shared memory (16-byte aligned) into registers
__device__ __forceinline__ void load_k(float (&v)[kStates],
                                       const float* src) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// which operands' rows cp.async may copy: bit 0 dt, 1 x, 2 B, 3 C, 4 dy
template <typename TX>
unsigned aligned_operands(const void* dt, long long dt_sb, long long dt_ss,
                          const void* x, long long x_sb, long long x_ss,
                          const void* b, long long b_sb, long long b_ss,
                          const void* c, long long c_sb, long long c_ss,
                          const void* dy = nullptr, long long dy_sb = 0,
                          long long dy_ss = 0) {
  constexpr long long XE = 16 / sizeof(TX);
  auto aligned = [](const void* p, long long sb, long long ss, long long e) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % e == 0
        && ss % e == 0;
  };
  return (aligned(dt, dt_sb, dt_ss, 4) ? 1u : 0u)
       | (aligned(x, x_sb, x_ss, XE) ? 2u : 0u)
       | (aligned(b, b_sb, b_ss, 4) ? 4u : 0u)
       | (aligned(c, c_sb, c_ss, 4) ? 8u : 0u)
       | (dy != nullptr && aligned(dy, dy_sb, dy_ss, 4) ? 16u : 0u);
}

}  // namespace
