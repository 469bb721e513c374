// The backward of causal (optionally sliding-window) or full flash
// attention with GQA: dq, dk and dv from q, k, v, the forward's output o
// and the output's gradient dO.
//
// Replaces: no TPU kernel. The JAX package trains through jnp attention
// (src/repro/models/attention.py sdpa / sdpa_gqa, lines 76-89) and lets XLA
// differentiate it; its one flash kernel (src/repro/kernels/flash_attention
// .py, flash_attention_pallas) has no backward. The port's training
// forward runs the flash kernel (csrc/flash_attention.cu) on the card, so
// its gradient needs a kernel of its own: this one, behind the
// torch.autograd.Function in kernels/flash_attention.py.
//
// What it computes (scale = 1/sqrt(hd) in f32; query i sees key j iff
// j < Sk and, in the causal form, j <= q_offset + i and (window == 0 or
// j > q_offset + i - window); q_offset places a sequence-parallel chunk of
// the queries among all the keys, and is 0 for a plain call):
//   P_ij  = exp(scale q_i.k_j - lse_i)        lse_i = log sum_j exp(...)
//   dP_ij = dO_i.v_j,   D_i = dO_i.o_i,   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_{i, heads of j's group} dS_ij q_i
//   dv_j  = sum_{i, heads of j's group} P_ij dO_i
//
// Bound on the H100: the five score-sized products (Q.K^T again, dO.V^T,
// dS.K, dS^T.Q and P^T.dO; 10 hd flops per visible query-key pair and
// head, about 2.5x the forward's) are bound by the tensor cores in bf16
// (989 TFLOP/s) at training lengths, or at short ones by the bytes of q,
// k, v, o, dO and the three gradients.
//
// Shape of both designs: two kernels, no atomics, so every output is one
// fixed sum and a run repeats bit for bit.
//  * dq: grid (ceil(Sq / 64), H, B). The block stages its 64-row Q and dO
//    tiles in shared memory, computes D_i from dO and o, walks the visible
//    64-key tiles once for each row's max and sum (the log-sum-exp, which
//    the forward does not keep: recomputing it here leaves the forward and
//    its timings untouched) and once more for dS and dq. lse and D go to a
//    (B, H, Sq) f32 scratch for the second kernel.
//  * dk, dv: grid (ceil(Sk / 64), KV, B). The block stages its 64-key K
//    and V tiles and walks the G query heads of its KV head and, for each,
//    the query tiles that see its keys, so GQA's sum over the group stays
//    in registers.
//  Pad rows (i >= Sq) and pad keys (j >= Sk) of the last tiles are
//  zero-filled and masked; a row with no visible key gets lse = +inf and
//  P = 0, never NaN. Key-tile bounds follow the offset and the window:
//  query tile q0 sees key tiles up to q_offset + q0 + 63 and from
//  (q_offset + q0 - window + 1) rounded down; key tile k0 is seen by query
//  tiles from (k0 - q_offset) rounded down to rows up to
//  k0 + 63 + window - 1 - q_offset.
//
// bf16 (dtype 1): the tensor cores, mma.sync m16n8k16 with f32
// accumulators, 4 warps a block, each owning 16 rows of the 64-row tile.
// Tiles are bf16 in shared memory with rows of hd + 8 elements (16-byte
// loads in; operand fragments read as 32-bit words, conflict-free at hd
// 32, 64, 80 and 128). The score-shaped products (Q.K^T, dO.V^T and, in
// the second kernel, K.Q^T, V.dO^T) take bf16 inputs as they are, so they
// are exact products summed in f32. P and dS are f32 in the accumulators;
// where they feed dV = P^T.dO, dq = dS.K and dk = dS^T.Q they are rounded
// to bf16 operands, as the forward rounds P before P.V: each term moves by
// at most 2^-8 of itself, and dq, dk, dv are those f32 sums rounded once.
// (Split into bf16 hi + lo operands, two products each, the terms kept
// about 2^-16 of themselves, and the kernel took 4-29 % longer at the
// training shapes on an H100 80GB HBM3 at 700 W.) The accumulator fragment
// of two adjacent n-tiles is the A fragment of one k-step, so P and dS go
// from one product to the next without shared memory. hd 80 is ten n-tiles
// of 8 and five k-steps of 16.
//
// f32 (dtype 0; parity runs only): the CUDA cores, 256 threads a block,
// each owning a 4 x 4 patch of the 64 x 64 score tile and 4 x hd/16
// patches of the outputs, f32 tiles with rows of hd + 1 (the 16 rows a
// half-warp reads at one column in 16 banks). TF32 tensor cores would lose
// the f32 parity that path exists for.
//
// C entry point: flash_attention_bwd_launch(q, k, v, o, dout, dq, dk, dv,
// lse, delta, B, Sq, Sk, H, KV, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
// o_sb, o_ss, do_sb, do_ss, causal, window, q_offset, dtype, stream); q,
// o, dout
// (B, Sq, H, D) and k, v (B, Sk, KV, D) with head stride D and element
// stride 1; dq, dk, dv contiguous in the same shapes; lse and delta
// (B, H, Sq) f32 scratch; dtype 0 = float32, 1 = bfloat16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // f32: 16 row groups of 4 x 16 column lanes
constexpr int kPS = kTile + 1; // row stride of the 64 x 64 score tiles

struct Args {
  const void* q; const void* k; const void* v; const void* o;
  const void* dout;
  void* dq; void* dk; void* dv;
  float* lse; float* delta;
  int Sq, Sk, H, KV;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, do_sb, do_ss;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ bool visible(int qi, int kj, const Args& a) {
  if (qi >= a.Sq || kj >= a.Sk) return false;
  if (!a.causal) return true;
  const int pos = a.q_offset + qi;   // the query's position among the keys
  return kj <= pos && (a.window <= 0 || kj > pos - a.window);
}

// rows [row0, row0 + 64) of one head of a (B, S, heads, D) operand (src
// already offset to batch and head) into a 64 x (D + 1) f32 tile; rows at
// or past n are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int row = row0 + r;
    dst[r * LD + c] = row < n ? src[row * row_stride + c] : 0.f;
  }
}

// a 4 x 4 patch of A . B^T: acc[i][j] = sum_d A[ra + i][d] B[rb + 16 j][d]
template <int D>
__device__ __forceinline__ void patch_dot(const float* A, const float* B,
                                          int ra, int rb, float acc[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ra + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = B[(rb + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// reductions over the 16 column lanes that share a row group (a half warp)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (D + 1) + kTile * kPS + 2 * kTile) * 4;
}
template <int D>
constexpr int dkdv_smem_bytes() {
  return (4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile) * 4;
}

// ---------------------------------------------------------------------------
// dq (and each row's lse and D)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;    // dq columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;           // 64 x kPS
  float* row_lse = dSs + kTile * kPS;     // 64
  float* row_delta = row_lse + kTile;     // 64

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x;
  const int tr = 4 * (tid / 16);   // first of this thread's 4 rows
  const int tc = tid % 16;         // column lane

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb
                + static_cast<long long>(h) * D;
  const float* ob = static_cast<const float*>(a.o) + b * a.o_sb
                + static_cast<long long>(h) * D;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb
                 + static_cast<long long>(h) * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb
                + static_cast<long long>(kvh) * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb
                + static_cast<long long>(kvh) * D;

  load_tile<D>(Qs, qb, a.q_ss, q0, a.Sq);
  load_tile<D>(dOs, dob, a.do_ss, q0, a.Sq);
  __syncthreads();
  {  // D_i = dO_i . o_i: four lanes a row
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
    if (q0 + r < a.Sq) {
      const float* orow = ob + (q0 + r) * a.o_ss;
      for (int d = part; d < D; d += 4)
        acc = fmaf(dOs[r * LD + d], orow[d], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) row_delta[r] = acc;
  }

  // key tiles any of this block's rows can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = a.Sk;
  if (a.causal) {
    k_hi = min(a.Sk, a.q_offset + q0 + kTile);
    if (a.window > 0)
      k_lo = max(0, a.q_offset + q0 - a.window + 1) / kTile * kTile;
  }

  // pass 1: each row's max and sum -> lse
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int kt = k_lo; kt < k_hi; kt += kTile) {
    __syncthreads();   // the previous K tile is consumed
    load_tile<D>(Ks, kb, a.k_ss, kt, a.Sk);
    __syncthreads();
    float s[4][4];
    patch_dot<D>(Qs, Ks, tr, tc, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(q0 + tr + i, kt + tc + 16 * j, a)
                      ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
      if (m_new != -INFINITY) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sum += s[i][j] == -INFINITY ? 0.f : __expf(s[i][j] - m_new);
      }
      sum = half_warp_sum(sum);
      if (m_new != -INFINITY) {
        l[i] = l[i] * __expf(m[i] - m_new) + sum;   // 0 * 0 at the start
        m[i] = m_new;
      }
    }
  }
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lse = l[i] > 0.f ? m[i] + __logf(l[i]) : INFINITY;
      row_lse[tr + i] = lse;
      const int qi = q0 + tr + i;
      if (qi < a.Sq) {
        const long long at = (static_cast<long long>(b) * a.H + h) * a.Sq
                             + qi;
        a.lse[at] = lse;
        a.delta[at] = row_delta[tr + i];
      }
    }
  }

  // pass 2: dS and dq
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int kt = k_lo; kt < k_hi; kt += kTile) {
    __syncthreads();   // K, V and dS of the previous tile are consumed
    load_tile<D>(Ks, kb, a.k_ss, kt, a.Sk);
    load_tile<D>(Vs, vb, a.v_ss, kt, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    patch_dot<D>(Qs, Ks, tr, tc, s);
    patch_dot<D>(dOs, Vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds = 0.f;
        if (visible(q0 + tr + i, kt + tc + 16 * j, a)) {
          const float p = __expf(s[i][j] * a.scale - row_lse[tr + i]);
          ds = p * (dp[i][j] - row_delta[tr + i]);
        }
        dSs[(tr + i) * kPS + tc + 16 * j] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * LD + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(tr + i) * kPS + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

  float* dqb = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + i;
    if (qi >= a.Sq) continue;
    float* row = dqb + ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      row[tc + 16 * c] = acc[i][c] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_f32_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;           // 64 keys x kPS queries
  float* dSs = Ps + kTile * kPS;
  float* row_lse = dSs + kTile * kPS;     // the query tile's 64 rows
  float* row_delta = row_lse + kTile;

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g_size = a.H / a.KV;
  const int tid = threadIdx.x;
  const int tr = 4 * (tid / 16);   // first of this thread's 4 keys
  const int tc = tid % 16;         // query / column lane

  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb
                + static_cast<long long>(kvh) * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb
                + static_cast<long long>(kvh) * D;
  load_tile<D>(Ks, kb, a.k_ss, k0, a.Sk);
  load_tile<D>(Vs, vb, a.v_ss, k0, a.Sk);

  // query tiles that can see any of this block's keys: [q_lo, q_hi)
  int q_lo = 0, q_hi = a.Sq;
  if (a.causal) {
    // a multiple of the 64-row query tile
    q_lo = max(0, k0 - a.q_offset) / kTile * kTile;
    if (a.window > 0)
      q_hi = min(a.Sq, max(0, k0 + kTile - 1 + a.window - a.q_offset));
  }

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) { dk[i][c] = 0.f; dv[i][c] = 0.f; }

  for (int g = 0; g < g_size; ++g) {
    const int h = kvh * g_size + g;
    const float* qb = static_cast<const float*>(a.q) + b * a.q_sb
                  + static_cast<long long>(h) * D;
    const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb
                   + static_cast<long long>(h) * D;
    const long long stat = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int qt = q_lo; qt < q_hi; qt += kTile) {
      __syncthreads();   // Q, dO, P and dS of the previous tile consumed
      load_tile<D>(Qs, qb, a.q_ss, qt, a.Sq);
      load_tile<D>(dOs, dob, a.do_ss, qt, a.Sq);
      if (tid < kTile) {
        const int qi = qt + tid;
        row_lse[tid] = qi < a.Sq ? a.lse[stat + qi] : INFINITY;
        row_delta[tid] = qi < a.Sq ? a.delta[stat + qi] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      patch_dot<D>(Ks, Qs, tr, tc, s);    // s[i][j]: key tr+i, query tc+16j
      patch_dot<D>(Vs, dOs, tr, tc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qj = tc + 16 * j;
          float p = 0.f, ds = 0.f;
          if (visible(qt + qj, k0 + tr + i, a)) {
            p = __expf(s[i][j] * a.scale - row_lse[qj]);
            ds = p * (dp[i][j] - row_delta[qj]);
          }
          Ps[(tr + i) * kPS + qj] = p;
          dSs[(tr + i) * kPS + qj] = ds;
        }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float qv[NC], ov[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          qv[c] = Qs[qq * LD + tc + 16 * c];
          ov[c] = dOs[qq * LD + tc + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(tr + i) * kPS + qq];
          const float ds = dSs[(tr + i) * kPS + qq];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[i][c] = fmaf(p, ov[c], dv[i][c]);
            dk[i][c] = fmaf(ds, qv[c], dk[i][c]);
          }
        }
      }
    }
  }

  float* dkb = static_cast<float*>(a.dk);
  float* dvb = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + tr + i;
    if (kj >= a.Sk) continue;
    const long long row = ((static_cast<long long>(b) * a.Sk + kj) * a.KV
                           + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkb[row + tc + 16 * c] = dk[i][c] * a.scale;
      dvb[row + tc + 16 * c] = dv[i][c];
    }
  }
}

template <int D>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t stream) {
  auto dq_fn = flash_bwd_dq_f32_kernel<D>;
  auto dkdv_fn = flash_bwd_dkdv_f32_kernel<D>;
  constexpr int dq_bytes = dq_smem_bytes<D>();
  constexpr int dkdv_bytes = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkdv_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((a.Sq + kTile - 1) / kTile, a.H, B);
  dq_fn<<<dq_grid, kThreads, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkdv_grid((a.Sk + kTile - 1) / kTile, a.KV, B);
  dkdv_fn<<<dkdv_grid, kThreads, dkdv_bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulators)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;                  // 16 rows of a 64-row tile each
constexpr int kMmaThreads = 32 * kWarps;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of a column (rows k and k + 1 of a row-major tile) as one
// operand register, row k in the low half
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, int ld) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  return static_cast<uint32_t>(u[0]) | (static_cast<uint32_t>(u[ld]) << 16);
}

// x0, x1 rounded to a bf16 pair: one 32-bit operand register
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [row0, row0 + 64) of one head into a 64 x (D + 8) bf16 tile, 16
// bytes a load; rows at or past n are zero
template <int D>
__device__ __forceinline__ void load_tile16(bf16* dst, const bf16* src,
                                            long long row_stride, int row0,
                                            int n) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kMmaThreads) {
    const int r = i / CH, c = i - r * CH;
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n)
      v = *reinterpret_cast<const uint4*>(src + row * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = v;
  }
}

// acc[nt] (16 x 8 each, nt < 8) = A[ra .. ra + 16) . B[0 .. 64)^T over D:
// both tiles row-major in D (the score-shaped products)
template <int D>
__device__ __forceinline__ void scores16(const bf16* A, const bf16* B,
                                         int ra, float acc[8][4]) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t af[4];
    af[0] = ld32(A + (ra + g) * LD + k0 + 2 * t);
    af[1] = ld32(A + (ra + g + 8) * LD + k0 + 2 * t);
    af[2] = ld32(A + (ra + g) * LD + k0 + 2 * t + 8);
    af[3] = ld32(A + (ra + g + 8) * LD + k0 + 2 * t + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t bfr[2];
      bfr[0] = ld32(B + (8 * nt + g) * LD + k0 + 2 * t);
      bfr[1] = ld32(B + (8 * nt + g) * LD + k0 + 2 * t + 8);
      mma_bf16(acc[nt], af, bfr);
    }
  }
}

// out[nt] (16 x 8, nt < D / 8) += X . B with X the 16 x 64 score-shaped
// f32 accumulator (each pair of n-tiles one k-step), rounded to bf16
// operands, and B a 64 x D row-major tile (rows the k index)
template <int D>
__device__ __forceinline__ void accum_xb(const float x[8][4], const bf16* B,
                                         float out[D / 8][4]) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t af[4] = {pack2(x[2 * kk][0], x[2 * kk][1]),
                            pack2(x[2 * kk][2], x[2 * kk][3]),
                            pack2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack2(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const bf16* brow = B + (16 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      uint32_t bfr[2];
      bfr[0] = ld_pair(brow + 8 * nt, LD);
      bfr[1] = ld_pair(brow + 8 * LD + 8 * nt, LD);
      mma_bf16(out[nt], af, bfr);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16_kernel(Args a) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * LD;
  bf16* Ks = dOs + kTile * LD;
  bf16* Vs = Ks + kTile * LD;
  float* row_delta = reinterpret_cast<float*>(Vs + kTile * LD);   // 64

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (tid >> 5);          // this warp's rows in the tile
  const int qa = q0 + r0 + g, qb = qa + 8;  // this thread's two rows

  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb
                   + static_cast<long long>(h) * D;
  const bf16* og = static_cast<const bf16*>(a.o) + b * a.o_sb
                   + static_cast<long long>(h) * D;
  const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_sb
                    + static_cast<long long>(h) * D;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb
                   + static_cast<long long>(kvh) * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb
                   + static_cast<long long>(kvh) * D;

  load_tile16<D>(Qs, qg, a.q_ss, q0, a.Sq);
  load_tile16<D>(dOs, dog, a.do_ss, q0, a.Sq);
  __syncthreads();
  {  // D_i = dO_i . o_i: two lanes a row
    const int r = tid >> 1, half = tid & 1;
    float acc = 0.f;
    if (q0 + r < a.Sq) {
      const bf16* orow = og + (q0 + r) * a.o_ss;
      for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
        acc = fmaf(__bfloat162float(dOs[r * LD + d]),
                   __bfloat162float(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) row_delta[r] = acc;
  }

  int k_lo = 0, k_hi = a.Sk;
  if (a.causal) {
    k_hi = min(a.Sk, a.q_offset + q0 + kTile);
    if (a.window > 0)
      k_lo = max(0, a.q_offset + q0 - a.window + 1) / kTile * kTile;
  }

  // pass 1: the two rows' max and sum -> lse
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = k_lo; kt < k_hi; kt += kTile) {
    __syncthreads();
    load_tile16<D>(Ks, kg, a.k_ss, kt, a.Sk);
    __syncthreads();
    float s[8][4];
    scores16<D>(Qs, Ks, r0, s);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = half ? qb : qa;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[nt][2 * half + e];
          v = visible(qi, kt + 8 * nt + 2 * t + e, a) ? v * a.scale
                                                      : -INFINITY;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      float sum = 0.f;
      if (m_new != -INFINITY) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = s[nt][2 * half + e];
            sum += v == -INFINITY ? 0.f : __expf(v - m_new);
          }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (m_new != -INFINITY) {
        l[half] = l[half] * __expf(m[half] - m_new) + sum;
        m[half] = m_new;
      }
    }
  }
  float lse[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    lse[half] = l[half] > 0.f ? m[half] + __logf(l[half]) : INFINITY;
    delta[half] = row_delta[r0 + g + 8 * half];
    const int qi = half ? qb : qa;
    if (t == 0 && qi < a.Sq) {
      const long long at = (static_cast<long long>(b) * a.H + h) * a.Sq + qi;
      a.lse[at] = lse[half];
      a.delta[at] = delta[half];
    }
  }

  // pass 2: dS and dq
  float dq[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
  for (int kt = k_lo; kt < k_hi; kt += kTile) {
    __syncthreads();
    load_tile16<D>(Ks, kg, a.k_ss, kt, a.Sk);
    load_tile16<D>(Vs, vg, a.v_ss, kt, a.Sk);
    __syncthreads();
    float s[8][4], dp[8][4];
    scores16<D>(Qs, Ks, r0, s);
    scores16<D>(dOs, Vs, r0, dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float ds = 0.f;
        if (visible(half ? qb : qa, kt + 8 * nt + 2 * t + (e & 1), a)) {
          const float p = __expf(s[nt][e] * a.scale - lse[half]);
          ds = p * (dp[nt][e] - delta[half]);
        }
        s[nt][e] = ds;
      }
    accum_xb<D>(s, Ks, dq);
  }

  bf16* dqg = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? qb : qa;
    if (qi >= a.Sq) continue;
    bf16* row = dqg + ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(dq[nt][2 * half] * a.scale,
                                dq[nt][2 * half + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_bf16_kernel(Args a) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;
  bf16* dOs = Qs + kTile * LD;
  float* col_lse = reinterpret_cast<float*>(dOs + kTile * LD);   // 64
  float* col_delta = col_lse + kTile;                            // 64

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g_size = a.H / a.KV;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (tid >> 5);            // this warp's keys in the tile
  const int ka = k0 + r0 + g, kb = ka + 8;    // this thread's two keys

  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb
                   + static_cast<long long>(kvh) * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb
                   + static_cast<long long>(kvh) * D;
  load_tile16<D>(Ks, kg, a.k_ss, k0, a.Sk);
  load_tile16<D>(Vs, vg, a.v_ss, k0, a.Sk);

  int q_lo = 0, q_hi = a.Sq;
  if (a.causal) {
    q_lo = max(0, k0 - a.q_offset) / kTile * kTile;
    if (a.window > 0)
      q_hi = min(a.Sq, max(0, k0 + kTile - 1 + a.window - a.q_offset));
  }

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dk[nt][e] = 0.f; dv[nt][e] = 0.f; }

  for (int gi = 0; gi < g_size; ++gi) {
    const int h = kvh * g_size + gi;
    const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb
                     + static_cast<long long>(h) * D;
    const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_sb
                      + static_cast<long long>(h) * D;
    const long long stat = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int qt = q_lo; qt < q_hi; qt += kTile) {
      __syncthreads();
      load_tile16<D>(Qs, qg, a.q_ss, qt, a.Sq);
      load_tile16<D>(dOs, dog, a.do_ss, qt, a.Sq);
      if (tid < kTile) {
        const int qi = qt + tid;
        col_lse[tid] = qi < a.Sq ? a.lse[stat + qi] : INFINITY;
        col_delta[tid] = qi < a.Sq ? a.delta[stat + qi] : 0.f;
      }
      __syncthreads();
      float p[8][4];
      scores16<D>(Ks, Qs, r0, p);   // p[nt][e]: key ka/kb, query 8nt+2t+e&1
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * nt + 2 * t + (e & 1);
          p[nt][e] = visible(qt + qc, (e >> 1) ? kb : ka, a)
                         ? __expf(p[nt][e] * a.scale - col_lse[qc]) : 0.f;
        }
      accum_xb<D>(p, dOs, dv);
      float ds[8][4];
      scores16<D>(Vs, dOs, r0, ds);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[nt][e] = p[nt][e] * (ds[nt][e] - col_delta[8 * nt + 2 * t +
                                                        (e & 1)]);
      accum_xb<D>(ds, Qs, dk);
    }
  }

  bf16* dkg = static_cast<bf16*>(a.dk);
  bf16* dvg = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = half ? kb : ka;
    if (kj >= a.Sk) continue;
    const long long row = ((static_cast<long long>(b) * a.Sk + kj) * a.KV
                           + kvh) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + row + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(dk[nt][2 * half] * a.scale,
                                dk[nt][2 * half + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + row + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(dv[nt][2 * half], dv[nt][2 * half + 1]);
    }
  }
}

template <int D>
constexpr int bf16_smem_bytes() {
  return 4 * kTile * (D + 8) * 2 + 2 * kTile * 4;
}

template <int D>
cudaError_t launch_bf16(const Args& a, int B, cudaStream_t stream) {
  auto dq_fn = flash_bwd_dq_bf16_kernel<D>;
  auto dkdv_fn = flash_bwd_dkdv_bf16_kernel<D>;
  constexpr int bytes = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkdv_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((a.Sq + kTile - 1) / kTile, a.H, B);
  dq_fn<<<dq_grid, kMmaThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dkdv_grid((a.Sk + kTile - 1) / kTile, a.KV, B);
  dkdv_fn<<<dkdv_grid, kMmaThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_f32<32>(a, B, stream);
    case 64: return launch_f32<64>(a, B, stream);
    case 80: return launch_f32<80>(a, B, stream);
    case 128: return launch_f32<128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_bf16<32>(a, B, stream);
    case 64: return launch_bf16<64>(a, B, stream);
    case 80: return launch_bf16<80>(a, B, stream);
    case 128: return launch_bf16<128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int Sq, int Sk, int H, int KV, int D, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, long long o_sb, long long o_ss, long long do_sb,
    long long do_ss, int causal, int window, int q_offset, int dtype,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || B > 65535 ||
      H > 65535 || q_offset < 0 || (causal && q_offset + Sq != Sk) ||
      (!causal && q_offset != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.Sq = Sq; a.Sk = Sk; a.H = H; a.KV = KV;
  a.q_sb = q_sb; a.q_ss = q_ss; a.k_sb = k_sb; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_ss = v_ss; a.o_sb = o_sb; a.o_ss = o_ss;
  a.do_sb = do_sb; a.do_ss = do_ss;
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_f32(a, B, D, s)
                  : dtype == 1 ? dispatch_bf16(a, B, D, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
