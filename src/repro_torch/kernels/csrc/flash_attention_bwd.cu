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
// k, v, o, dO and the three gradients. A design of two kernels without
// atomics runs seven: the dq kernel needs S and dP again.
//
// Shape of both designs: two kernels, no atomics, so every output is one
// fixed sum and a run repeats bit for bit. Key-tile bounds follow the
// offset and the window: query tile q0 sees key tiles up to
// q_offset + q0 + 63 and from (q_offset + q0 - window + 1) rounded down;
// key tile k0 is seen by query tiles from (k0 - q_offset) rounded down to
// rows up to k0 + 63 + window - 1 - q_offset. Pad rows (i >= Sq) and pad
// keys (j >= Sk) of the last tiles are zero-filled, and masked wherever
// they could reach a written output; a row with no visible key has
// lse = +inf and P = 0, never NaN.
//
// bf16 (dtype 1; wgmma + TMA). The forward kernel writes each row's
// log-sum-exp (csrc/flash_attention.cu, the lse output) and the backward
// reads it, so no kernel walks the keys for it. Both kernels are one
// consumer warpgroup (128 threads) that owns a 64-row tile, and one
// producer warp whose lane 0 keeps TMA loads of 64-row tiles in a 2-stage
// ring of swizzled shared-memory tiles (csrc/hopper.cuh, the forward's
// layout and helpers), each stage's arrival reported to an mbarrier and
// its release to another.
//  * dq: grid (H, B, ceil(Sq / 64)), the query tile counted down so the
//    blocks with the most causal key tiles start first. The block loads
//    its Q and dO tiles once and computes D_i = dO_i . o_i (written to a
//    (B, H, Sq) f32 scratch for the second kernel); per streamed K and V
//    tile it runs S = Q.K^T and dP = dO.V^T as SS wgmma (m64n64k16, both
//    operands K-major in shared memory), forms dS = P (dP - D_i) with
//    P = 2^(S scale log2 e - lse_i log2 e) in the f32 accumulators, packs
//    dS into bf16 A fragments and runs dQ += dS.K as RS wgmma (K as the
//    MN-major B operand: N = hd, five k-steps of an n80 product at hd 80).
//    dq is staged in bf16 in the Q tile's buffer and written by TMA.
//  * dk, dv: grid (G' x KV, B, ceil(Sk / 64)), the key tile slowest. A
//    block owns a 64-key tile of one kv head and walks ceil(G / G') of
//    its query heads over the query tiles that see its keys; the
//    producer streams Q and dO tiles and each tile's 64 rows' log-sum-exp
//    and D into the ring. S^T = K.Q^T and dP^T = V.dO^T are SS wgmma;
//    P^T and dS^T are packed from the accumulators into bf16 A fragments,
//    and dV += P^T.dO, dK += dS^T.Q are RS wgmma with dO and Q as MN-major
//    B operands.
//    G' = 1 where KV x B x ceil(Sk / 64) blocks already give every SM two
//    (h2o-danube's 4,200 keys): the block walks all G heads and writes dk
//    and dv from its registers. Otherwise (qwen2's 2 kv heads over 512
//    keys: 128 blocks for 132 SMs) the G' = min(G, 8) blocks of a kv head,
//    8 the portable cluster size, form a thread-block cluster along the
//    grid's first axis; after the walk each block's f32 dk and dv partials
//    go to its shared memory, and every block sums a share of the
//    elements over the cluster's blocks through distributed shared memory
//    in rank order (query heads g = 0..G-1) and writes them: a fixed
//    order, no atomics.
//  The elementwise work between the products (an exp2 and three flops an
//  element) is what a tile waits on most, so each tile takes one of three
//  copies of that loop (Mask): no check, the key tail, or the causal and
//  window edges, and only the tiles that cross one pay for its check.
//  The score-shaped products take bf16 inputs as they are, so they are
//  exact products summed in f32. P and dS are f32 in the accumulators;
//  where they feed dV = P^T.dO, dq = dS.K and dk = dS^T.Q they are rounded
//  once to bf16 operands, as the forward rounds P before P.V: each term
//  moves by at most 2^-8 of itself, and dq, dk, dv are those f32 sums
//  rounded once.
//
// f32 (dtype 0; parity runs only): the CUDA cores, 256 threads a block,
// each owning a 4 x 4 patch of the 64 x 64 score tile and 4 x hd/16
// patches of the outputs, f32 tiles with rows of hd + 1 (the 16 rows a
// half-warp reads at one column in 16 banks). TF32 tensor cores would lose
// the f32 parity that path exists for. The dq kernel walks the visible key
// tiles twice, once for each row's log-sum-exp (written to ``lse``) and
// once for dS and dq; the dk, dv kernel (grid (ceil(Sk / 64), KV, B))
// walks the G query heads of its kv head in turn.
//
// C entry point: flash_attention_bwd_launch(q, k, v, o, dout, dq, dk, dv,
// lse, delta, B, Sq, Sk, H, KV, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
// o_sb, o_ss, do_sb, do_ss, causal, window, q_offset, dtype, stream); q,
// o, dout (B, Sq, H, D) and k, v (B, Sk, KV, D) with head stride D and
// element stride 1, 16-byte aligned rows; dq, dk, dv contiguous in the
// same shapes; lse and delta (B, H, Sq) f32: bf16 reads the forward's
// log-sum-exp from lse, f32 writes its own there; delta is scratch; dtype
// 0 = float32, 1 = bfloat16.

#include <cooperative_groups.h>
#include <climits>
#include <cmath>

#include "hopper.cuh"

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
  int heads_per_block, cluster;   // bf16 dk/dv: GQA heads over a cluster
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
// bf16: wgmma + TMA, the dk/dv partials of a GQA group summed over a cluster
// ---------------------------------------------------------------------------

constexpr int kStages = 2;                     // ring depth of streamed tiles
constexpr int kConsumers = 128;                // one warpgroup: a 64-row tile
constexpr int kMmaThreads = kConsumers + 32;   // + the producer warp
constexpr int kMaxCluster = 8;                 // the portable cluster size
constexpr int kPartLD = 8;                     // pad of a partial's f32 rows
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// Built with -DFLASH_BWD_PHASES (profiling/flash_bwd_phases.py only),
// thread 0 of each consumer warpgroup adds the clock64() cycles of each
// phase of its walk to g_phases (slots: dq kernel 0-7, dk/dv kernel
// 8-15, as that script names them); otherwise the stamps compile away.
#ifdef FLASH_BWD_PHASES
__device__ unsigned long long g_phases[16];
#define PHASE_CLOCK(x) const long long x = clock64()
#define PHASE_ADD(slot, t)                                               \
  (threadIdx.x == 0 ? (void)atomicAdd(&g_phases[slot],                    \
                                      static_cast<unsigned long long>(t)) \
                    : (void)0)
#else
#define PHASE_CLOCK(x) ((void)0)
#define PHASE_ADD(slot, t) ((void)0)
#endif

// barrier 1 over the consumer warpgroup only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// a generic pointer to the shared-memory byte at address ``addr``
__device__ __forceinline__ void* smem_ptr(uint8_t* smem_raw, uint32_t addr) {
  return smem_raw + (addr - smem_u32(smem_raw));
}

// What a score tile masks. The zero-filled pad rows need no mask but one:
// a query row past Sq has lse = +inf, so P = 0; a pad key's row of S is 0,
// and in the dk/dv kernel it feeds only dk and dv rows past Sk, which are
// not written; but in the dq kernel its P = 2^(-lse log2 e) could
// overflow, and inf . 0 is NaN, so a tile holding the key tail masks it.
enum Mask { kNone, kKeyTail, kCausal };

// keep iff key position d = kj - (q_offset + qi) is seen: d <= 0 and,
// with a window, d > -window (neg_w: -window, or INT_MIN for none)
__device__ __forceinline__ bool seen(int d, int neg_w) {
  return d <= 0 && d > neg_w;
}

// dS = P (dP - D) in place of dP over a 64 x 64 score tile of the dq
// kernel, the thread's rows qi0 and qi0 + 8 (their lse in log2 units and
// D), its keys kj0 + 8 j + {0, 1}; P = 2^(s scale log2 e - lse log2 e).
// One copy of the loop a Mask keeps the checks out of the tiles that need
// none.
template <Mask M>
__device__ __forceinline__ void dq_grad_scores(
    const float (&s)[32], float (&dp)[32], const float (&lse2)[2],
    const float (&dlt)[2], float scale_log2, int qi0, int kj0, int neg_w,
    const Args& a) {
  const int d0 = kj0 - a.q_offset - qi0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1, c = e & 1;
      float p = fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse2[hr]));
      if ((M == kKeyTail && kj0 + 8 * j + c >= a.Sk)
          || (M == kCausal && !seen(d0 + 8 * j + c - 8 * hr, neg_w)))
        p = 0.f;
      dp[4 * j + e] = p * (dp[4 * j + e] - dlt[hr]);
    }
  }
}

// P^T in place of S^T and dS^T = P^T (dP^T - D) in place of dP^T over a
// 64 x 64 tile of the dk/dv kernel, the thread's keys kj0 and kj0 + 8, its
// queries qc0 + 8 j + {0, 1}, whose lse (log2 units) and D the stage's
// rows hold (rl); only the causal and windowed forms mask (kNone or
// kCausal)
template <Mask M>
__device__ __forceinline__ void dkdv_grad_scores(
    float (&s)[32], float (&dp)[32], const float* rl, float scale_log2,
    int qc0, int kj0, int cq, int neg_w, const Args& a) {
  const int d0 = kj0 - a.q_offset - qc0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(rl + 8 * j + cq);
    const float2 d2 = *reinterpret_cast<const float2*>(
        rl + kTileRows + 8 * j + cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1;
      float p = fast_exp2(fmaf(s[4 * j + e], scale_log2,
                               -(c ? l2.y : l2.x)));
      if (M == kCausal && !seen(d0 + 8 * (e >> 1) - 8 * j - c, neg_w))
        p = 0.f;
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - (c ? d2.y : d2.x));
    }
  }
}

// dq: the Q and dO tiles, a kStages ring of K and V tiles, 1024-byte
// alignment slack for the 128-byte swizzle, the mbarriers and 64 D_i
template <int D>
constexpr int dq_smem_bytes_bf16() {
  return (2 + 2 * kStages) * Geo<D>::TILE_BYTES + 1024 + 64 + kTileRows * 4;
}

// dk/dv: the K and V tiles and a kStages ring of Q and dO tiles, whose
// memory holds the block's f32 dk and dv partials (2 x 64 x (D +
// kPartLD)) after the walk; then the ring's rows' log-sum-exp and D,
// 1024-byte alignment slack and the mbarriers
template <int D>
__host__ __device__ constexpr int dkdv_tiles_bytes() {
  constexpr int tiles = (2 + 2 * kStages) * Geo<D>::TILE_BYTES;
  constexpr int parts = 2 * kTileRows * (D + kPartLD) * 4;
  return tiles > parts ? tiles : parts;
}
template <int D>
constexpr int dkdv_smem_bytes_bf16() {
  return dkdv_tiles_bytes<D>() + kStages * kTileRows * 8 + 1024 + 64;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdq,
                         const Args a) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + G::TILE_BYTES;
  const uint32_t k_s = base + 2 * G::TILE_BYTES;          // + stage * TILE
  const uint32_t v_s = k_s + kStages * G::TILE_BYTES;     // + stage * TILE
  const uint32_t q_full = v_s + kStages * G::TILE_BYTES;
  auto full = [&](int st) { return q_full + 8u * (1 + st); };
  auto empty = [&](int st) { return q_full + 8u * (1 + kStages + st); };
  float* row_delta = static_cast<float*>(smem_ptr(smem_raw, q_full + 64));

  // the query tile is the slowest grid axis, counted down, so the blocks
  // with the most causal key tiles are launched first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTileRows;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (a.H / a.KV);
  // keys this block's rows can see: [k_lo, k_hi), walked in 64-key tiles
  int k_hi = a.Sk, k_lo = 0;
  if (a.causal) {
    k_hi = min(a.Sk, a.q_offset + q0 + kTileRows);
    if (a.window > 0) k_lo = max(0, a.q_offset + q0 - a.window + 1);
  }
  const int t_lo = k_lo / kTileRows;
  const int n_tiles = (k_hi + kTileRows - 1) / kTileRows - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one lane issues every TMA load of the block
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, 2 * G::TILE_BYTES);
#pragma unroll
      for (int c = 0; c < G::NCH; ++c) {
        tma_load(&tq, q_s + c * G::CHUNK_BYTES, q_full, c * G::CC, h, q0, b);
        tma_load(&tdo, do_s + c * G::CHUNK_BYTES, q_full, c * G::CC, h, q0,
                 b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * G::TILE_BYTES);
        const int kt = (t_lo + i) * kTileRows;
#pragma unroll
        for (int c = 0; c < G::NCH; ++c) {
          tma_load(&tk, k_s + st * G::TILE_BYTES + c * G::CHUNK_BYTES,
                   full(st), c * G::CC, kvh, kt, b);
          tma_load(&tv, v_s + st * G::TILE_BYTES + c * G::CHUNK_BYTES,
                   full(st), c * G::CC, kvh, kt, b);
        }
      }
    }
    return;
  }

  // consumers: thread t holds rows lr and lr + 8 of the wgmma fragments,
  // columns 8 j + cq + {0, 1} of every 8-column block j
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int lr = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.Sq;
  PHASE_CLOCK(t_start);

  {  // D_i = dO_i . o_i, two threads a row, 16 bytes at a time: o's row
     // from device memory, in flight while the Q and dO tiles land, dO's
     // from its tile; D goes to the dk/dv kernel through a.delta
    const int r = tid >> 1, half = tid & 1, qi = q0 + r;
    uint4 ov[D / 16];
    const uint4* orow = reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(a.o) + b * a.o_sb + qi * a.o_ss
        + static_cast<long long>(h) * D + half * (D / 2));
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      ov[c] = qi < a.Sq ? orow[c] : make_uint4(0u, 0u, 0u, 0u);
    mbar_wait(q_full, 0);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const uint4 dv = *static_cast<const uint4*>(smem_ptr(
          smem_raw, do_s + swizzled<D>(r, half * (D / 2) + 8 * c)));
      const bf16* oe = reinterpret_cast<const bf16*>(&ov[c]);
      const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc = fmaf(__bfloat162float(de[e]), __bfloat162float(oe[e]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      row_delta[r] = acc;
      if (qi < a.Sq) a.delta[stat + qi] = acc;
    }
  }
  consumer_sync();
  // each row's log-sum-exp in log2 units (+inf past Sq: P = 0) and D
  float lse2[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + lr + 8 * hr;
    lse2[hr] = qi < a.Sq ? a.lse[stat + qi] * kLog2e : INFINITY;
    dlt[hr] = row_delta[lr + 8 * hr];
  }
  const float scale_log2 = a.scale * kLog2e;
  const int neg_w = a.window > 0 ? -a.window : INT_MIN;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  PHASE_CLOCK(t_walk);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    PHASE_CLOCK(t0);
    mbar_wait(full(st), (i / kStages) & 1);
    PHASE_CLOCK(t1);
    const uint32_t ks = k_s + st * G::TILE_BYTES;
    const uint32_t vs = v_s + st * G::TILE_BYTES;

    // S = Q . K^T and dP = dO . V^T (64 x 64, f32)
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) { s[j] = 0.f; dp[j] = 0.f; }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<D>(q_s, kk), desc_kmajor<D>(ks, kk),
                   kk > 0 ? 1 : 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<D>(do_s, kk), desc_kmajor<D>(vs, kk),
                   kk > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait0();
    PHASE_CLOCK(t2);

    // dS = P (dP - D), P = 2^(s scale log2 e - lse log2 e); only the tiles
    // that cross the diagonal, the window's start or the keys' end mask
    const int kt = (t_lo + i) * kTileRows;
    const int p0 = a.q_offset + q0;   // the key position of the tile's row 0
    if (a.causal && (kt + kTileRows - 1 > p0
                     || (a.window > 0 && kt < p0 + kTileRows - a.window)))
      dq_grad_scores<kCausal>(s, dp, lse2, dlt, scale_log2, q0 + lr,
                              kt + cq, neg_w, a);
    else if (kt + kTileRows > a.Sk)
      dq_grad_scores<kKeyTail>(s, dp, lse2, dlt, scale_log2, q0 + lr,
                               kt + cq, neg_w, a);
    else
      dq_grad_scores<kNone>(s, dp, lse2, dlt, scale_log2, q0 + lr, kt + cq,
                            neg_w, a);
    uint32_t ds[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // k-step j / 2 covers 8-column blocks 2 (j / 2) and 2 (j / 2) + 1
      ds[j / 2][2 * (j % 2) + 0] = pack_bf16(dp[4 * j + 0], dp[4 * j + 1]);
      ds[j / 2][2 * (j % 2) + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
    }

    PHASE_CLOCK(t3);
    // dQ += dS . K (K as the MN-major B operand, keys along K)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dq, ds[kk], desc_mnmajor<D>(ks, kk));
    wgmma_commit();
    wgmma_wait0();
    mbar_arrive(empty(st));   // this thread's reads of the stage are done
    PHASE_ADD(0, t1 - t0);
    PHASE_ADD(1, t2 - t1);
    PHASE_ADD(2, t3 - t2);
    PHASE_ADD(3, clock64() - t3);
  }
  PHASE_ADD(4, n_tiles);
  PHASE_ADD(5, 1);
  PHASE_ADD(6, t_walk - t_start);
  PHASE_CLOCK(t_end);

  // dq scale in bf16 into the Q tile's buffer (free once every warp's
  // last wgmma has read it), swizzled as the tensor map stores it, then one
  // TMA store per column chunk; rows past Sq are clipped
  consumer_sync();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t v2 = pack_bf16(dq[4 * j + 2 * hr] * a.scale,
                                    dq[4 * j + 2 * hr + 1] * a.scale);
      asm volatile("st.shared.b32 [%0], %1;\n"
                   :: "r"(q_s + swizzled<D>(lr + 8 * hr, 8 * j + cq)),
                      "r"(v2)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < G::NCH; ++c)
      tma_store(&tdq, q_s + c * G::CHUNK_BYTES, c * G::CC, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  PHASE_ADD(7, clock64() - t_end);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 2 : 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Args a) {
  using G = Geo<D>;
  constexpr int LDP = D + kPartLD;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + G::TILE_BYTES;
  const uint32_t q_s = base + 2 * G::TILE_BYTES;          // + stage * TILE
  const uint32_t do_s = q_s + kStages * G::TILE_BYTES;    // + stage * TILE
  const uint32_t stats = base + dkdv_tiles_bytes<D>();   // + stage * 512
  const uint32_t kv_full = stats + kStages * kTileRows * 8;
  auto full = [&](int st) { return kv_full + 8u * (1 + st); };
  auto empty = [&](int st) { return kv_full + 8u * (1 + kStages + st); };
  // a stage's 64 query rows: log-sum-exp in log2 units, then D
  auto row_lse = [&](int st) {
    return static_cast<float*>(smem_ptr(smem_raw,
                                        stats + st * kTileRows * 8));
  };
  float* part = static_cast<float*>(smem_ptr(smem_raw, base));

  // blockIdx.x: the kv head's cluster of blocks, each walking heads_per_
  // block of its G query heads; the key tile is the slowest axis, so the
  // first tiles, which causal queries see most, are launched first
  const int kvh = blockIdx.x / a.cluster;
  const int rank = blockIdx.x % a.cluster;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTileRows;
  const int g_size = a.H / a.KV;
  const int g_lo = rank * a.heads_per_block;
  const int g_hi = min(g_size, g_lo + a.heads_per_block);
  // query tiles that can see any of this block's keys: [q_lo, q_hi)
  int q_lo = 0, q_hi = a.Sq;
  if (a.causal) {
    q_lo = max(0, k0 - a.q_offset) / kTileRows * kTileRows;
    if (a.window > 0)
      q_hi = min(a.Sq, max(0, k0 + kTileRows - 1 + a.window - a.q_offset));
  }
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + kTileRows - 1) / kTileRows
                              : 0;
  const int n_tiles = max(0, g_hi - g_lo) * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1 + 32);   // the TMA lane's and each lane's stats
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid >= kConsumers) {
    // producer warp: lane 0 issues the TMA loads; every lane loads two
    // rows' log-sum-exp and D of each query tile into its stage
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * G::TILE_BYTES);
#pragma unroll
      for (int c = 0; c < G::NCH; ++c) {
        tma_load(&tk, k_s + c * G::CHUNK_BYTES, kv_full, c * G::CC, kvh, k0,
                 b);
        tma_load(&tv, v_s + c * G::CHUNK_BYTES, kv_full, c * G::CC, kvh, k0,
                 b);
      }
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int h = kvh * g_size + g_lo + i / n_q;
      const int qt = q_lo + (i % n_q) * kTileRows;
      mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full(st), 2 * G::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < G::NCH; ++c) {
          tma_load(&tq, q_s + st * G::TILE_BYTES + c * G::CHUNK_BYTES,
                   full(st), c * G::CC, h, qt, b);
          tma_load(&tdo, do_s + st * G::TILE_BYTES + c * G::CHUNK_BYTES,
                   full(st), c * G::CC, h, qt, b);
        }
      }
      const long long stat = (static_cast<long long>(b) * a.H + h) * a.Sq;
      float* rl = row_lse(st);
      for (int r = lane; r < kTileRows; r += 32) {
        const int qi = qt + r;
        rl[r] = qi < a.Sq ? a.lse[stat + qi] * kLog2e : INFINITY;
        rl[kTileRows + r] = qi < a.Sq ? a.delta[stat + qi] : 0.f;
      }
      mbar_arrive(full(st));
    }
  } else {
    // consumers: thread t holds keys lr and lr + 8 of the tile, queries
    // 8 j + cq + {0, 1} of every 8-column block j
    const int lr = warp * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const float scale_log2 = a.scale * kLog2e;
    const int neg_w = a.window > 0 ? -a.window : INT_MIN;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) { dk[i] = 0.f; dv[i] = 0.f; }

    PHASE_CLOCK(t_start);
    mbar_wait(kv_full, 0);
    PHASE_ADD(14, clock64() - t_start);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      PHASE_CLOCK(t0);
      mbar_wait(full(st), (i / kStages) & 1);
      PHASE_CLOCK(t1);
      const uint32_t qs = q_s + st * G::TILE_BYTES;
      const uint32_t dos = do_s + st * G::TILE_BYTES;
      const int qt = q_lo + (i % n_q) * kTileRows;

      // S^T = K . Q^T and dP^T = V . dO^T (64 keys x 64 queries, f32)
      float s[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) { s[j] = 0.f; dp[j] = 0.f; }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_kmajor<D>(k_s, kk), desc_kmajor<D>(qs, kk),
                     kk > 0 ? 1 : 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_kmajor<D>(v_s, kk), desc_kmajor<D>(dos, kk),
                     kk > 0 ? 1 : 0);
      wgmma_commit();
      wgmma_wait0();
      PHASE_CLOCK(t2);

      // P^T and dS^T = P^T (dP^T - D), each rounded once to a bf16 A
      // fragment; only tiles that cross the diagonal or the window's start
      // mask (Mask: the tails need none here)
      if (a.causal && (k0 + kTileRows - 1 > a.q_offset + qt
                       || (a.window > 0
                           && k0 <= a.q_offset + qt + kTileRows - 1
                                        - a.window)))
        dkdv_grad_scores<kCausal>(s, dp, row_lse(st), scale_log2, qt + cq,
                                  k0 + lr, cq, neg_w, a);
      else
        dkdv_grad_scores<kNone>(s, dp, row_lse(st), scale_log2, qt + cq,
                                k0 + lr, cq, neg_w, a);
      uint32_t ap[4][4], as[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ap[j / 2][2 * (j % 2) + 0] = pack_bf16(s[4 * j + 0], s[4 * j + 1]);
        ap[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        as[j / 2][2 * (j % 2) + 0] = pack_bf16(dp[4 * j + 0], dp[4 * j + 1]);
        as[j / 2][2 * (j % 2) + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
      }

      PHASE_CLOCK(t3);
      // dV += P^T . dO and dK += dS^T . Q (dO and Q as MN-major B
      // operands, queries along K)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dv, ap[kk], desc_mnmajor<D>(dos, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dk, as[kk], desc_mnmajor<D>(qs, kk));
      wgmma_commit();
      wgmma_wait0();
      mbar_arrive(empty(st));
      PHASE_ADD(8, t1 - t0);
      PHASE_ADD(9, t2 - t1);
      PHASE_ADD(10, t3 - t2);
      PHASE_ADD(11, clock64() - t3);
    }
    PHASE_ADD(12, n_tiles);
    PHASE_ADD(13, 1);

    if (a.cluster == 1) {
      // the block holds the whole sum: dk and dv go straight to memory
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int kj = k0 + lr + 8 * hr;
        if (kj >= a.Sk) continue;
        const long long row = ((static_cast<long long>(b) * a.Sk + kj)
                               * a.KV + kvh) * D + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + row + 8 * j)
              = pack_bf16(dk[4 * j + 2 * hr] * a.scale,
                          dk[4 * j + 2 * hr + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + row + 8 * j)
              = pack_bf16(dv[4 * j + 2 * hr], dv[4 * j + 2 * hr + 1]);
        }
      }
      return;
    }
    // the block's partials, f32, over the tiles' memory (every wgmma and
    // TMA load of the walk is done once all consumers are here)
    consumer_sync();
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int at = (lr + 8 * hr) * LDP + 8 * j + cq;
        *reinterpret_cast<float2*>(part + at) =
            make_float2(dk[4 * j + 2 * hr], dk[4 * j + 2 * hr + 1]);
        *reinterpret_cast<float2*>(part + kTileRows * LDP + at) =
            make_float2(dv[4 * j + 2 * hr], dv[4 * j + 2 * hr + 1]);
      }
    }
  }

  if (a.cluster == 1) return;   // the producer warp: nothing to sum
  // the cluster's partials summed in rank order (query heads g = 0..G-1),
  // each block summing and writing its share of the 16-byte chunks: one
  // fixed order for every element, no atomics
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int CH = kTileRows * D / 4;   // float4 chunks of one partial
  bf16* dkg = static_cast<bf16*>(a.dk);
  bf16* dvg = static_cast<bf16*>(a.dv);
  for (int i = rank * kMmaThreads + tid; i < 2 * CH;
       i += a.cluster * kMmaThreads) {
    const int m = i / CH;                  // 0: dk, 1: dv
    const int row = (i - m * CH) / (D / 4);
    const int col = 4 * (i - m * CH - row * (D / 4));
    const int kj = k0 + row;
    if (kj >= a.Sk) continue;
    const int at = m * kTileRows * LDP + row * LDP + col;
    // every rank's chunk in flight at once, then summed in rank order
    float4 x[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < a.cluster)
        x[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, r) + at);
    float4 acc = x[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < a.cluster) {
        acc.x += x[r].x; acc.y += x[r].y; acc.z += x[r].z; acc.w += x[r].w;
      }
    const float sc = m == 0 ? a.scale : 1.f;
    const uint2 out = make_uint2(pack_bf16(acc.x * sc, acc.y * sc),
                                 pack_bf16(acc.z * sc, acc.w * sc));
    const long long row_at = ((static_cast<long long>(b) * a.Sk + kj) * a.KV
                              + kvh) * D + col;
    *reinterpret_cast<uint2*>((m == 0 ? dkg : dvg) + row_at) = out;
  }
  // no block leaves while another reads its partials
  cluster.sync();
}

template <int D>
cudaError_t launch_bf16(const Args& a0, int B, cudaStream_t stream) {
  if (encoder() == nullptr) return cudaErrorNotSupported;
  Args a = a0;
  // Where a block per (kv head, key tile) leaves the card short of two
  // blocks an SM, the query heads of a kv head get a block each, up to the
  // portable cluster size (past it each block walks heads_per_block of
  // them in turn); otherwise one block walks all G (no partials to sum).
  const int g_size = a.H / a.KV;
  const long long serial_blocks = static_cast<long long>(a.KV) * B
                                  * ((a.Sk + kTileRows - 1) / kTileRows);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  a.heads_per_block = serial_blocks >= 2LL * sms
      ? g_size : (g_size + kMaxCluster - 1) / kMaxCluster;
  a.cluster = (g_size + a.heads_per_block - 1) / a.heads_per_block;
  CUtensorMap tq, tdo, tk, tv, tdq;
  if (!make_map<D>(&tq, a.q, B, a.Sq, a.H, a.q_sb, a.q_ss)
      || !make_map<D>(&tdo, a.dout, B, a.Sq, a.H, a.do_sb, a.do_ss)
      || !make_map<D>(&tk, a.k, B, a.Sk, a.KV, a.k_sb, a.k_ss)
      || !make_map<D>(&tv, a.v, B, a.Sk, a.KV, a.v_sb, a.v_ss)
      || !make_map<D>(&tdq, a.dq, B, a.Sq, a.H,
                      static_cast<long long>(a.Sq) * a.H * D,
                      static_cast<long long>(a.H) * D))
    return cudaErrorInvalidValue;
  auto dq_fn = flash_bwd_dq_bf16_kernel<D>;
  auto dkdv_fn = flash_bwd_dkdv_bf16_kernel<D>;
  // once per instantiation (at its first, eager launch)
  static const cudaError_t allowed = [&]() {
    cudaError_t err = cudaFuncSetAttribute(
        dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dq_smem_bytes_bf16<D>());
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        dkdv_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dkdv_smem_bytes_bf16<D>());
  }();
  if (allowed != cudaSuccess) return allowed;
  const dim3 dq_grid(a.H, B, (a.Sq + kTileRows - 1) / kTileRows);
  dq_fn<<<dq_grid, kMmaThreads, dq_smem_bytes_bf16<D>(), stream>>>(
      tq, tdo, tk, tv, tdq, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.KV * a.cluster, B,
                     (a.Sk + kTileRows - 1) / kTileRows);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = dkdv_smem_bytes_bf16<D>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dkdv_fn, tq, tdo, tk, tv, a);
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
      H > 65535 || (Sq + 63) / 64 > 65535 || (Sk + 63) / 64 > 65535 ||
      q_offset < 0 || (causal && q_offset + Sq != Sk) ||
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
  a.heads_per_block = a.cluster = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_f32(a, B, D, s)
                  : dtype == 1 ? dispatch_bf16(a, B, D, s)
                               : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

#ifdef FLASH_BWD_PHASES
// copies the phase sums out to ``out`` (16 u64) and zeroes them
extern "C" int flash_attention_bwd_phases(unsigned long long* out) {
  const unsigned long long zero[16] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_phases, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
