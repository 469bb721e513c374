// Causal (optionally sliding-window) or full flash attention with GQA; the
// full (non-causal) form also over keys of a length of their own (the
// encoder-decoder's cross attention: Sq decoder queries over Sk encoder
// keys).
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention_pallas (the TPU kernel runs the grid (B, H, S/BQ, S/BK)
// with KV blocks innermost, carrying online-softmax state in VMEM scratch;
// its K/V index map sends query head h to KV head h // G). It is the
// function of models/attention.py prefill_attention / attention_forward,
// which the model runs in every layer at every prefill, and of the
// encoder's self-attention and the decoder's cross attention (is_causal
// False).
//
// Bound on the H100: at prefill lengths of a few hundred tokens the causal
// score and P.V products (4 * hd flops per query-key pair and head) are
// bound by the tensor cores (989 TFLOP/s in bf16) or, at short lengths, by
// the bytes of q, k, v and the output. Either way the products must run on
// the tensor cores: on the CUDA cores (67 TFLOP/s in f32) the causal
// products of one B 8, S 256 prefill alone need longer than a library
// call takes for the whole function.
//
// bf16 design (dtype 1; wgmma + TMA): grid (H, B, ceil(S / 64)), the
// query tile on the slowest axis and counted down, so the blocks with the
// most causal key tiles launch first and the light ones fill in behind. A
// block is one consumer warpgroup (128 threads) that owns a 64-row query
// tile of one head, and one producer warp. The producer issues TMA loads
// of the query tile once and of 64-key K and V tiles of KV head h / G into
// a 2-stage shared-memory ring, each completion reported to an mbarrier;
// the consumers release a stage through a second mbarrier. Tiles land
// 128-byte swizzled (64-byte at hd 32, 32-byte at hd 80), hd 128 as two
// 64-column boxes, hd 80 as five 16-column ones. Per
// key tile the warpgroup runs S = Q.K^T on wgmma (m64n64k16, Q and K from
// shared memory, f32 accumulators), scales the f32 scores (so no rounding
// is added to q), updates the online softmax in registers (row max and sum
// across the four lanes that share a row), rounds P to bf16 straight from
// the accumulator fragment into the register A operand, and runs O += P.V
// on wgmma with V from shared memory in the transposed (MN-major) layout.
// Rounding P to bf16 before P.V is what the JAX model does too. Key tiles
// past the causal limit or before the window's start are not loaded; only
// tiles that cross the diagonal, the window's start or the end of the
// sequence are masked.
// A row's key-tile walk and reduction order do not depend on S (no split
// over keys), so the real rows of a right-padded bucket are bit-identical
// to an unpadded call. The normalised O tile is staged in bf16 in the Q
// tile's buffer (in the swizzled layout) and written by one TMA store per
// column chunk: 16-byte rows instead of scattered 4-byte stores. q, k, v
// and the output are read and written in the model's (B, S, heads, hd)
// layout through one 4-D tensor map each (hd, heads, S, B), encoded on the
// host per call from the strides the wrapper passes; the TMA unit
// zero-fills rows past S on loads and clips them on the store, so no
// transpose or copy is made. hd 32, 64, 80 and 128. hd 80 (h2o-danube) has
// 160-byte rows, which no 128-byte swizzle atom divides: its tiles are
// stored as five 16-column chunks with the 32-byte swizzle (five TMA boxes
// a tile), so Q.K^T takes its five k-steps from the five chunks and P.V is
// one m64n80k16 wgmma whose B operand strides over them.
// Queries run to S and keys to Sk: the key-tile walk, the tail mask and
// the K/V tensor maps use Sk, the query tiles and the Q and output maps S.
// In the causal and windowed forms query row i stands at position
// q_offset + i of the keys (a sequence-parallel chunk of the queries over
// all the keys, models/attention.py): it sees key j iff j <= q_offset + i
// and (window == 0 or j > q_offset + i - window), and the key-tile bounds
// move with it; these forms need Sk == q_offset + S (the wrapper raises
// otherwise). q_offset 0 with Sk == S is the arithmetic of a plain call.
//
// f32 design (dtype 0; parity runs only): CUDA cores, one thread per query
// row, 32-key K/V tiles staged in shared memory, online softmax in f32.
// TF32 tensor cores would lose the f32 parity that path exists for. At
// hd 128 the per-thread query and accumulator rows exceed the register
// file and ptxas spills them to local memory: correct, and slow.
//
// The log-sum-exp (optional): where ``lse`` is not null the launch also
// writes each query row's natural log of the sum of exp(scaled score) over
// the keys it sees, (B, H, S) f32, +inf for a row that sees none; the
// backward kernel (csrc/flash_attention_bwd.cu) reads it instead of
// walking the keys once more. The bf16 design keeps its running max and
// sum in log2 units, so a row's value is (m + log2 l) ln 2. Where ``lse``
// is null nothing else changes: the output is the same bits.
//
// C entry point: flash_attention_launch(q, k, v, out, lse, B, S, Sk, H, KV,
// D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal, window,
// q_offset, dtype, stream);
// head stride D and element stride 1 for every tensor; dtype 0 = float32,
// 1 = bfloat16; lse null or (B, H, S) f32 contiguous.

#include <cmath>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;   // query rows (threads) per block
constexpr int kKeys = 32;   // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kRows)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse,
                 int S, int Sk, int H, int KV, long long q_sb, long long q_ss,
                 long long k_sb, long long k_ss, long long v_sb,
                 long long v_ss, long long o_sb, long long o_ss, int causal,
                 int window, int q_offset, float scale) {
  constexpr int CHUNKS = D / 4;           // 16-byte loads per row
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
    const float4* src = reinterpret_cast<const float4*>(
        q + b * q_sb + qi * q_ss + static_cast<long long>(h) * D);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const float4 x = __ldg(src + c);
      qr[4 * c + 0] = x.x * scale;
      qr[4 * c + 1] = x.y * scale;
      qr[4 * c + 2] = x.z * scale;
      qr[4 * c + 3] = x.w * scale;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  // keys this block's rows can see: [k_lo, k_hi)
  int k_hi = Sk, k_lo = 0;
  if (causal) {
    k_hi = min(Sk, q_offset + q0 + kRows);
    if (window > 0)
      k_lo = max(0, q_offset + q0 - window + 1) / kKeys * kKeys;
  }
  const float* kb = k + b * k_sb + static_cast<long long>(kvh) * D;
  const float* vb = v + b * v_sb + static_cast<long long>(kvh) * D;

  for (int kt = k_lo; kt < k_hi; kt += kKeys) {
    __syncthreads();   // the previous tile is consumed
    for (int i = tid; i < kKeys * CHUNKS; i += kRows) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const int kj = kt + r;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(&k_s[r][0])[c] =
          kj < Sk ? __ldg(reinterpret_cast<const float4*>(kb + kj * k_ss) + c)
                 : z;
      reinterpret_cast<float4*>(&v_s[r][0])[c] =
          kj < Sk ? __ldg(reinterpret_cast<const float4*>(vb + kj * v_ss) + c)
                 : z;
    }
    __syncthreads();
    if (!row_ok) continue;

    float s[kKeys];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int kj = kt + r;
      bool keep = kj < Sk;
      if (causal) {
        keep = keep && kj <= q_offset + qi;
        if (window > 0) keep = keep && kj > q_offset + qi - window;
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
    float* dst = out + b * o_sb + qi * o_ss + static_cast<long long>(h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = acc[d] * inv;
    if (lse != nullptr)
      lse[(static_cast<long long>(b) * H + h) * S + qi] =
          l > 0.f ? m + logf(l) : INFINITY;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int S, int Sk, int H,
                       int KV, long long q_sb, long long q_ss, long long k_sb,
                       long long k_ss, long long v_sb, long long v_ss,
                       long long o_sb, long long o_ss, int causal, int window,
                       int q_offset, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_f32_kernel<D><<<grid, kRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Sk,
      H, KV, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, causal, window,
      q_offset, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 64;            // query rows per block
constexpr int kBN = 64;            // keys per tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kConsumers = 128;    // one warpgroup
constexpr int kThreads = kConsumers + 32;   // + the producer warp

// the query tile, a kStages ring of K and V tiles, 1024-byte alignment
// slack for the 128-byte swizzle, and the mbarriers
template <int D>
constexpr int smem_bytes() {
  return (1 + 2 * kStages) * Geo<D>::TILE_BYTES + 1024 + 64;
}

// barrier 1 over the consumer warpgroup only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to,
                  float* __restrict__ lse, int S, int Sk,
                  int H, int KV, int causal, int window, int q_offset,
                  float scale_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + G::TILE_BYTES;             // + stage * TILE
  const uint32_t v_s = k_s + kStages * G::TILE_BYTES;    // + stage * TILE
  const uint32_t q_full = v_s + kStages * G::TILE_BYTES;
  // full[st] at q_full + 8 (1 + st), empty[st] at q_full + 8 (1 + kStages
  // + st)
  auto full = [&](int st) { return q_full + 8u * (1 + st); };
  auto empty = [&](int st) { return q_full + 8u * (1 + kStages + st); };

  // the query tile is the slowest grid axis, counted down, so the blocks
  // with the most causal key tiles are launched first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  // keys this block's rows can see: [k_lo, k_hi), walked in 64-key tiles
  int k_hi = Sk, k_lo = 0;
  if (causal) {
    k_hi = min(Sk, q_offset + q0 + kBM);
    if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  }
  const int t_lo = k_lo / kBN;
  const int n_tiles = (k_hi + kBN - 1) / kBN - t_lo;

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
      mbar_expect_tx(q_full, G::TILE_BYTES);
#pragma unroll
      for (int c = 0; c < G::NCH; ++c)
        tma_load(&tq, q_s + c * G::CHUNK_BYTES, q_full, c * G::CC, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * G::TILE_BYTES);
        const int kt = (t_lo + i) * kBN;
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

  // consumers: thread t holds rows r0 and r0 + 8 of the wgmma fragments,
  // columns 8 j + cq + {0, 1} of every 8-column block j
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    mbar_wait(full(st), (i / kStages) & 1);
    const uint32_t ks = k_s + st * G::TILE_BYTES;
    const uint32_t vs = v_s + st * G::TILE_BYTES;

    // S = Q . K^T (64 x 64, f32)
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<D>(q_s, kk), desc_kmajor<D>(ks, kk),
                   kk > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait0();

    // mask the tiles that cross an edge; the row max is taken on the raw
    // scores (the scale is positive) and scaled once per row
    const int kt = (t_lo + i) * kBN;
    const int p0 = q_offset + q0;   // the key position of the tile's row 0
    const bool mask = kt + kBN > Sk
        || (causal && (kt + kBN - 1 > p0
                       || (window > 0 && kt < p0 + kBM - window)));
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (mask) {
          const int key = kt + 8 * j + cq + (e & 1);
          const int row = r0 + 8 * (e >> 1);
          bool keep = key < Sk;
          if (causal) {
            keep = keep && key <= q_offset + row;
            if (window > 0) keep = keep && key > q_offset + row - window;
          }
          if (!keep) s[4 * j + e] = -INFINITY;
        }
        if (e < 2) mx0 = fmaxf(mx0, s[4 * j + e]);
        else mx1 = fmaxf(mx1, s[4 * j + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // running maxima in log2 units of the scaled scores
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    // a row with no visible key yet keeps p = 0 and alpha = 0 (no NaN)
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = fast_exp2(m0 - mu0), al1 = fast_exp2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;

    // P = 2^(s * scale_log2 - m) in f32 for the row sums, rounded to bf16
    // into the A fragments: k-step kk covers 8-column blocks 2 kk, 2 kk + 1
    uint32_t a[4][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = fast_exp2(fmaf(s[4 * j + 0], scale_log2, -mu0));
      const float p01 = fast_exp2(fmaf(s[4 * j + 1], scale_log2, -mu0));
      const float p10 = fast_exp2(fmaf(s[4 * j + 2], scale_log2, -mu1));
      const float p11 = fast_exp2(fmaf(s[4 * j + 3], scale_log2, -mu1));
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      a[j / 2][2 * (j % 2) + 0] = pack_bf16(p00, p01);
      a[j / 2][2 * (j % 2) + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    if (al0 != 1.f || al1 != 1.f) {   // a row max moved
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
    }

    // O += P . V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, a[kk], desc_mnmajor<D>(vs, kk));
    wgmma_commit();
    wgmma_wait0();
    mbar_arrive(empty(st));   // this thread's reads of the stage are done
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
  if (lse != nullptr && (lane & 3) == 0) {
    // natural log from the log2-unit max and sum
    const long long row0 = (static_cast<long long>(b) * H + h) * S;
    if (r0 < S)
      lse[row0 + r0] = l0 > 0.f ? (m0 + log2f(l0)) * 0.6931471805599453f
                                : INFINITY;
    if (r0 + 8 < S)
      lse[row0 + r0 + 8] = l1 > 0.f ? (m1 + log2f(l1)) * 0.6931471805599453f
                                    : INFINITY;
  }
  // O in bf16 into the Q tile's buffer (free once every warp's last
  // wgmma has read it), in the swizzled layout of the output's tensor map,
  // then one TMA store per column chunk: 16-byte rows instead of 4-byte
  // scattered stores, and rows past S are clipped by the TMA unit
  consumer_sync();
  const int lr = warp * 16 + (lane >> 2);   // row r0 inside the tile
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cq;
      const uint32_t off = (col / G::CC) * G::CHUNK_BYTES
                         + (lr + 8 * hr) * G::SW + (col % G::CC) * 2;
      // the TMA swizzle: 16-byte chunk bits XOR the 128-byte line bits
      const uint32_t swz = off ^ (((off >> 7) & (G::SW / 16 - 1)) << 4);
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          o[4 * j + 2 * hr] * inv[hr], o[4 * j + 2 * hr + 1] * inv[hr]);
      asm volatile("st.shared.b32 [%0], %1;\n"
                   :: "r"(q_s + swz),
                      "r"(*reinterpret_cast<const uint32_t*>(&v2))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < G::NCH; ++c)
      tma_store(&to, q_s + c * G::CHUNK_BYTES, c * G::CC, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int S, int Sk, int H,
                        int KV, long long q_sb, long long q_ss, long long k_sb,
                        long long k_ss, long long v_sb, long long v_ss,
                        long long o_sb, long long o_ss, int causal,
                        int window, int q_offset, cudaStream_t stream) {
  if (encoder() == nullptr) return cudaErrorNotSupported;
  // The tensor maps are encoded on the host and passed by value, so a
  // CUDA graph that captures this launch keeps them, with the addresses
  // of q, k, v and out baked in. That is right only because every tensor
  // a captured call passes here has a fixed address in its engine's graph
  // pool, which each replay overwrites in place.
  CUtensorMap tq, tk, tv, to;
  if (!make_map<D>(&tq, q, B, S, H, q_sb, q_ss)
      || !make_map<D>(&tk, k, B, Sk, KV, k_sb, k_ss)
      || !make_map<D>(&tv, v, B, Sk, KV, v_sb, v_ss)
      || !make_map<D>(&to, out, B, S, H, o_sb, o_ss))
    return cudaErrorInvalidValue;
  // once per instantiation (at its first, eager launch), not at every
  // launch
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid(H, B, (S + kBM - 1) / kBM);
  flash_bf16_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      tq, tk, tv, to, lse, S, Sk, H, KV, causal, window, q_offset,
      1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int S, int Sk, int H, int KV, int D, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long o_sb, long long o_ss, int causal, int window, int q_offset,
    int dtype, void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || KV < 1 || H % KV != 0 || B > 65535
      || H > 65535 || (S + 63) / 64 > 65535 || q_offset < 0
      || (causal && q_offset + S != Sk) || (!causal && q_offset != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, out, static_cast<float*>(lse), B, S, Sk, H, \
                   KV, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, \
                   causal, window, q_offset, s
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (D) {
      case 32: err = launch_f32<32>(FLASH_ARGS); break;
      case 64: err = launch_f32<64>(FLASH_ARGS); break;
      case 80: err = launch_f32<80>(FLASH_ARGS); break;
      case 128: err = launch_f32<128>(FLASH_ARGS); break;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: err = launch_bf16<32>(FLASH_ARGS); break;
      case 64: err = launch_bf16<64>(FLASH_ARGS); break;
      case 80: err = launch_bf16<80>(FLASH_ARGS); break;
      case 128: err = launch_bf16<128>(FLASH_ARGS); break;
    }
  }
#undef FLASH_ARGS
  return static_cast<int>(err);
}
