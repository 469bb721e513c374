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
// about 4 * hd * H flops per position, some 7 flops per byte, far below the
// tensor-core ridge (295). What the work needs is bytes in flight on many
// SMs, not arithmetic; a grid of one block per (KV head, row) keeps B x KV
// SMs busy (16 of 132 at B 8, KV 2) and each of them walks its positions as
// a chain of dependent loads.
//
// Design: flash-decoding inside one launch. Each (KV head, row) gets a
// thread-block cluster of 8 blocks; block r of the cluster takes the r-th
// of 8 equal slices of the positions < valid_len[b], so the grid is
// (KV x 8, B) blocks. A block brings its slice's K and V rows into shared
// memory with 16-byte cp.async copies, in 32-position tiles through a ring
// of 2-4 stages (every tile of a 64-position slice is in flight at once;
// longer slices stream), stored with an XOR swizzle of the 16-byte chunks
// so that a lane per position reads its row without bank conflicts. Warp g
// serves query head g of the group (G <= 8), so each K/V row is fetched
// once for all G heads: lane j dots row j of the tile with the pre-scaled
// query (f32, in shared memory), one warp max and one warp sum update the
// head's online softmax, and for P.V each lane owns hd / 32 output columns
// while the warp reads V rows from shared memory. Scores, softmax and P.V
// run in f32 on the CUDA cores: the work is memory-bound, so tensor cores
// buy nothing. The 8 partial (max, sum, accumulator) triples of a cluster
// merge through distributed shared memory into rank 0, which writes the
// output; a block with an empty slice still reaches both cluster barriers.
// The cache is read in place in the model's (B, C, KV, hd) layout, by the
// strides the wrapper passes: no transpose, copy or host-side descriptor
// per step. Only positions < valid_len[b] are read, so ragged rows cost
// what they hold. q may be f32 over a bf16 cache (f32 activations over the
// engine's bf16 slot pool), as the model's f32 runs attend. hd 32, 64, 80,
// 128. Where 32 divides hd a lane owns hd / 32 neighbouring output
// columns; at hd 80 (h2o-danube) it owns columns lane, lane + 32 and, for
// lanes below 16, lane + 64, and a row of 160 (or 320) bytes, which no
// 128-byte line holds whole, is swizzled within each line by the line's
// index instead of the row's. The columns-32-apart loop serves every hd,
// but where 32 divides hd it is 3-20 % slower than the neighbouring
// columns (an H100 80GB HBM3 at 700 W, repro_torch.profiling.decode_ab),
// so both are kept.
//
// The merging block may also write each row's log-sum-exp of its scaled
// scores, lse = mx + log(den) in f32, the partial a sharded flash-decode
// (models/attention.py decode_attention_sharded) combines across cache
// shards. A row with no valid position (valid_len 0, a shard whose chunk
// lies past the newest token) has mx = -inf and den = 0 in every block: its
// output is 0 / 1e-30 = 0 and its lse -inf, never NaN. Writing the lse
// changes no arithmetic of the output.
//
// C entry point: decode_attention_launch(q, k, v, valid_len, out, lse, B,
// H, KV, C, D, k_sb, k_sc, v_sb, v_sc, dtype, stream): q and out (B, H, D)
// contiguous; lse (B, H) f32 contiguous, or null (not written); k, v with
// element strides (k_sb, k_sc, D, 1); valid_len (B,) int32 on the device;
// dtype 0 = all float32, 1 = all bfloat16, 2 = float32 q and out over a
// bfloat16 cache.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;     // blocks per cluster: slices of the positions
constexpr int kWarps = 8;     // one per query head of the group
constexpr int kGMax = 8;
constexpr int kTile = 32;     // positions per shared-memory tile (a lane each)
constexpr int kRingBytes = 32 * 1024;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Tile geometry for element type T and head width D: RB bytes per row,
// NST ring stages, SMEM dynamic shared-memory bytes.
template <typename T, int D>
struct Geo {
  static constexpr int RB = D * static_cast<int>(sizeof(T));
  static constexpr int CH = RB / 16;               // 16-byte chunks per row
  static constexpr int PLANE = kTile * RB;         // K (or V) of one tile
  static constexpr int STAGE = 2 * PLANE;
  static constexpr int NST = kRingBytes / STAGE > 4 ? 4
                           : kRingBytes / STAGE < 2 ? 2
                           : kRingBytes / STAGE;
  // output columns per lane: D / 32 neighbours where 32 divides D (SPLIT),
  // else ceil(D / 32) columns 32 apart, the last one not every lane's
  static constexpr bool SPLIT = D % 32 == 0;
  static constexpr int DPL = (D + 31) / 32;
  // q_s, part_acc: kGMax x D f32; p_s: kWarps x kTile; part_m, part_l
  static constexpr int SMEM = NST * STAGE + 2 * kGMax * D * 4
                            + kWarps * kTile * 4 + 2 * kGMax * 4;
};

// byte offset of chunk c of tile row j: the chunk's index inside its
// 128-byte line is XORed with the row (rows of a whole number of lines) or
// with the line (64-byte rows, two to a line, and hd 80's rows, which
// straddle lines), so the 8 lanes of a phase that read chunk c of 8
// consecutive rows hit different bank groups; either key permutes the
// chunks of a line among themselves
template <int RB>
__device__ __forceinline__ int swz(int j, int c) {
  const int o = j * RB + c * 16;
  const int key = RB % 128 == 0 ? (j & 7) : ((o >> 7) & 7);
  return (o & ~127) | ((((o >> 4) & 7) ^ key) << 4);
}

template <typename TQ, typename T, int D>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kWarps * 32)
decode_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ valid_len,
              TQ* __restrict__ out, float* __restrict__ lse, int H, int KV,
              int C, long long k_sb,
              long long k_sc, long long v_sb, long long v_sc, float scale) {
  using G_ = Geo<T, D>;
  constexpr int VE = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int DPL = G_::DPL;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + G_::NST * G_::STAGE);
  float* part_acc = q_s + kGMax * D;
  float* p_s = part_acc + kGMax * D;
  float* part_m = p_s + kWarps * kTile;
  float* part_l = part_m + kGMax;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.x / kSplit;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int g = tid >> 5;              // this warp's query head
  const int lane = tid & 31;

  for (int i = tid; i < kGMax * D; i += blockDim.x) {
    const int gg = i / D, d = i % D;
    q_s[i] = gg < G
        ? to_f(q[(static_cast<long long>(b) * H + kvh * G + gg) * D + d])
              * scale
        : 0.f;
  }

  // this block's slice of the valid positions: [lo, hi)
  const int vl = min(max(valid_len[b], 0), C);
  const int per = (vl + kSplit - 1) / kSplit;
  const int lo = min(vl, rank * per);
  const int hi = min(vl, lo + per);
  const int n_t = (hi - lo + kTile - 1) / kTile;
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(
      k + b * k_sb + static_cast<long long>(kvh) * D);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(
      v + b * v_sb + static_cast<long long>(kvh) * D);
  const long long k_row = k_sc * static_cast<long long>(sizeof(T));
  const long long v_row = v_sc * static_cast<long long>(sizeof(T));

  // every thread copies its share of tile t's K and V rows into stage st
  auto load = [&](int t, int st) {
    uint8_t* dst = ring + st * G_::STAGE;
    const int t0 = lo + t * kTile;
    for (int i = tid; i < 2 * kTile * G_::CH; i += blockDim.x) {
      const int plane = i / (kTile * G_::CH);
      const int rem = i % (kTile * G_::CH);
      const int j = rem / G_::CH, c = rem % G_::CH;
      if (t0 + j >= hi) continue;
      const uint8_t* src = plane == 0 ? kb + (t0 + j) * k_row
                                      : vb + (t0 + j) * v_row;
      cp_async16(dst + plane * G_::PLANE + swz<G_::RB>(j, c), src + c * 16);
    }
  };

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

#pragma unroll
  for (int t = 0; t < G_::NST - 1; ++t) {
    if (t < n_t) load(t, t);
    cp_async_commit();
  }
  __syncthreads();   // q_s is written
  for (int t = 0; t < n_t; ++t) {
    const int nt = t + G_::NST - 1;
    if (nt < n_t) load(nt, nt % G_::NST);
    cp_async_commit();
    cp_async_wait<G_::NST - 1>();   // tile t's copies of this thread landed
    __syncthreads();                // ... and every other thread's
    const uint8_t* kst = ring + (t % G_::NST) * G_::STAGE;
    const uint8_t* vst = kst + G_::PLANE;
    const int t0 = lo + t * kTile;
    if (g < G) {   // warp-uniform
      float sc = -INFINITY;
      if (t0 + lane < hi) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < G_::CH; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              kst + swz<G_::RB>(lane, c));
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int u = 0; u < VE; ++u)
            dot = fmaf(q_s[g * D + c * VE + u], to_f(e[u]), dot);
        }
        sc = dot;
      }
      // t0 < hi, so lane 0 holds a real score and the new max is finite
      const float m_new = fmaxf(m, warp_max(sc));
      const float p = t0 + lane < hi ? __expf(sc - m_new) : 0.f;
      const float alpha = __expf(m - m_new);   // 0 while m is still -inf
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
      m = m_new;
      p_s[g * kTile + lane] = p;
      __syncwarp();
      const int jn = min(kTile, hi - t0);
      if constexpr (G_::SPLIT) {
        const int byte = lane * DPL * static_cast<int>(sizeof(T));
#pragma unroll 4
        for (int jj = 0; jj < jn; ++jj) {
          const T* vr = reinterpret_cast<const T*>(
              vst + swz<G_::RB>(jj, byte >> 4) + (byte & 15));
          const float pj = p_s[g * kTile + jj];
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            acc[i] = fmaf(pj, to_f(vr[i]), acc[i]);
        }
      } else {
#pragma unroll 4
        for (int jj = 0; jj < jn; ++jj) {
          const float pj = p_s[g * kTile + jj];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int byte = (lane + 32 * i) * static_cast<int>(sizeof(T));
            if (lane + 32 * i < D)
              acc[i] = fmaf(pj, to_f(*reinterpret_cast<const T*>(
                  vst + swz<G_::RB>(jj, byte >> 4) + (byte & 15))), acc[i]);
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();   // the stage is consumed before it is refilled
  }

  // this block's partial; a block with an empty slice holds m = -inf,
  // l = 0, acc = 0
  if (g < G) {
    if (lane == 0) {
      part_m[g] = m;
      part_l[g] = l;
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int col = G_::SPLIT ? lane * DPL + i : lane + 32 * i;
      if (col < D) part_acc[g * D + col] = acc[i];
    }
  }
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int gg = i / D;
      float mr[kSplit];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kSplit; ++r) {
        mr[r] = cluster.map_shared_rank(part_m, r)[gg];
        mx = fmaxf(mx, mr[r]);
      }
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int r = 0; r < kSplit; ++r) {
        const float wt = mr[r] == -INFINITY ? 0.f : __expf(mr[r] - mx);
        den = fmaf(cluster.map_shared_rank(part_l, r)[gg], wt, den);
        num = fmaf(cluster.map_shared_rank(part_acc, r)[i], wt, num);
      }
      out[(static_cast<long long>(b) * H + kvh * G) * D + i] =
          from_f<TQ>(num / fmaxf(den, 1e-30f));
      if (lse != nullptr && i % D == 0)
        lse[static_cast<long long>(b) * H + kvh * G + gg] =
            den > 0.f ? mx + logf(den) : -INFINITY;
    }
  }
  cluster.sync();   // no block leaves while rank 0 reads its partial
}

template <typename TQ, typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* valid_len, void* out, void* lse, int B,
                     int H, int KV, int C, long long k_sb, long long k_sc,
                     long long v_sb, long long v_sc, cudaStream_t stream) {
  constexpr int smem = Geo<T, D>::SMEM;
  // once per instantiation (at its first, eager launch), not at every
  // launch: a launch inside a CUDA-graph capture then makes no other API
  // call
  static const cudaError_t allowed = cudaFuncSetAttribute(
      decode_kernel<TQ, T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid(KV * kSplit, B);
  decode_kernel<TQ, T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid_len),
      static_cast<TQ*>(out), static_cast<float*>(lse), H, KV, C, k_sb, k_sc,
      v_sb, v_sc,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename TQ, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid_len, void* out, void* lse, int B, int H,
                   int KV, int C, int D, long long k_sb, long long k_sc,
                   long long v_sb, long long v_sc, cudaStream_t stream) {
  switch (D) {
#define DECODE_CASE(DD)                                                     \
    case DD:                                                              \
      return launch_d<TQ, T, DD>(q, k, v, valid_len, out, lse, B, H, KV, C, \
                                 k_sb, k_sc, v_sb, v_sc, stream);
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(80)
    DECODE_CASE(128)
#undef DECODE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid_len,
    void* out, void* lse, int B, int H, int KV, int C, int D,
    long long k_sb, long long k_sc, long long v_sb, long long v_sc,
    int dtype, void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || H % KV != 0 || H / KV > kGMax
      || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, float>(q, k, v, valid_len, out, lse, B, H, KV, C, D,
                               k_sb, k_sc, v_sb, v_sc, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, valid_len, out, lse,
                                               B, H, KV, C, D, k_sb, k_sc,
                                               v_sb, v_sc, s);
  } else if (dtype == 2) {
    err = launch<float, __nv_bfloat16>(q, k, v, valid_len, out, lse, B, H,
                                       KV, C, D, k_sb, k_sc, v_sb, v_sc, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
