// The attention backward for Hopper (sm_90a) in bf16 at head dim 64: one
// TMA + wgmma kernel that both backward sources launch, and the one delta
// kernel of every backward launch.
//
// It replaces, for every bf16 head-dim-64 launch (every head on the port's
// paths: DiT 24 x 64, UNet 5/10/20 x 64):
//   - K2: the Pallas kernel opendwm_tpu/ops/flash_tail.py:_backward (:125,
//     body _bwd_kernel :85), launched by flash_tail.cu with q_seq = kv_seq
//     and no causal mask;
//   - the K7 backward: the stock Pallas flash attention backward,
//     _flash_attention_bwd_dkv and _flash_attention_bwd_dq
//     (jax/experimental/pallas/ops/tpu/flash_attention.py:941, :1287, jax
//     0.9.0), launched by flash_attention.cu with its causal flag.
// Both launch the same kernel, so at K2's shapes the K7 backward gives K2's
// dK and dV bit for bit. It computes what the bodies it replaces compute:
// P = exp2(S * scale * log2(e) - lse) from the forward's row log-sum-exp;
// dV = P^T dO with P rounded to bf16; dP = dO V^T; dS = P (dP - delta)
// scale rounded to bf16, with delta = rowsum(dO o O); dQ = dS K and
// dK = dS^T Q; fp32 accumulators, bf16 outputs. Keys past kv_seq and
// queries past q_seq get P = 0; causal masking is top-left (key j visible
// to query i iff j <= i) and the query tiles wholly before a key tile are
// never loaded.
//
// What bounds it on this card. Per (batch, head) the work is 5 products of
// Sq x Skv x 64 (10 Sq Skv 64 flops) against ~8 (Sq + Skv) 64 bytes of
// q/k/v/o/dO and gradients: the tensor cores' rate on paper. At head dim 64
// the elementwise work between the products (an exponential and ~8 ALU
// instructions a score) costs as much as the products, so only wgmma, fed
// from shared memory and overlapped with that work, comes near the rate.
// The mma.sync bodies this replaces made 7 products where the math needs 5
// (S and dP in both the dk/dv and the dq kernel), gathered every
// transposed B fragment with scalar shared loads, and loaded each tile
// between two __syncthreads().
//
// The design:
//   - One pass, 5 products. One block owns one (batch * head, 128-key
//     block): two consumer warpgroups of one 64-key tile each. Its K and V
//     tiles are loaded once by TMA; a producer warp streams the 64-query Q
//     and dO tiles, with their lse and delta rows, through a kStages ring
//     that both consumers read (4-D tensor maps over BSHD, 128-byte
//     swizzle, zero fill past the ends, as in the forward). The blocks of
//     one (batch, head) are neighbours in launch order and start at
//     different query tiles, so they share Q and dO in L2 and spread their
//     dQ sums.
//   - Keys as the M dimension. A consumer warpgroup computes S^T = K Q^T
//     and dP^T = V dO^T with wgmma, both operands K-major in shared memory.
//     P^T and dS^T then sit in registers in the C layout, which is wgmma's
//     register A layout for dV += P^T dO and dK += dS^T Q, with dO and Q
//     the MN-major shared B operands (the transpose bit, as V in the
//     forward). dK and dV stay in registers over the whole query loop.
//   - dQ. dS^T goes to shared memory once in bf16 (two buffers a consumer,
//     so one barrier a tile orders the writes against the last tile's
//     reads); dQ_i = dS K is one wgmma chain with dS and K both read
//     MN-major. Each consumer adds its 64 x 64 share into an fp32
//     workspace (batch * heads, q_seq rounded up to 64, 64) with
//     red.global.add.f32, in the C fragment's order (entry i of thread c of
//     a tile at i * 128 + c, so a warp's 32 adds cover 128 contiguous
//     bytes); dq_convert_kernel then writes the bf16 dQ in BSHD. The delta
//     kernel zeroes the workspace.
//   - Determinism. The fp32 sums of dQ arrive in an order that changes
//     between runs, so dQ may differ in its last bits from run to run
//     (within 2^-7 in relative norm of any other order, one bf16 ulp); dK
//     and dV are owned by one warpgroup each, summed in a fixed order, and
//     are the same bits every run.
//   - Masks only where needed: the last key tile (keys >= kv_seq), the last
//     query tile (queries >= q_seq; TMA zero-fills their Q and dO rows, but
//     exp2(0 - lse) of a row that does not exist is not 0, so lse and delta
//     are read in bounds and the padded columns of P^T are forced to 0
//     before any product) and, under the causal mask, the diagonal tiles.
//     A key tile wholly past kv_seq (the second of a ragged block, e.g. at
//     168 keys) only releases the ring.
//   - Block shape (PERF.md has the times of the others): two consumer
//     warpgroups and one producer warp, one block an SM, 3 stages. A
//     consumer holds dK, dV, S, dP, dQ and P or dS in flight (~160
//     registers); ptxas gives every warp the launch's registers whatever a
//     setmaxnreg split says, so one consumer warpgroup at two blocks an SM
//     (128 a thread) spilled and serialized its wgmma and was 1.4-2.4x
//     slower. Issuing S and dP of the next tile before the dQ adds needs
//     more registers than the 168 ptxas took here, spilled, and was slower.
//   - Refuse, don't hang: a ring wait that never completes traps; a build
//     whose registers or shared memory do not fit the launch fails at the
//     launch with an error.
//
// The launches it takes are Sm90BwdTakes's (bf16, head dim 64, the tensors
// that TMA reads or writes 16-byte aligned); the others keep the mma.sync
// and FMA bodies of flash_bwd.cuh. Both take the delta kernel below.

#pragma once

#include "sm90.cuh"

namespace {
namespace bwd90 {

using namespace sm90;

// A block: kConsumers consumer warpgroups of one 64-key tile each (warps
// 0-3 and 4-7: a warpgroup starts at a multiple of 4 warps), then one
// producer warp. One block an SM and no setmaxnreg: every thread may take
// up to 65536 / 288 registers (ptxas takes 168), what a consumer needs
// for dK, dV, S, dP, dQ and P in flight.
constexpr int kConsumers = 2;
constexpr int kBlockKeys = kConsumers * kTileRows;  // 128
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kStages = 3;  // Q/dO tiles in flight
constexpr int kWsTile = kTileRows * kD;  // fp32 dQ entries of a query tile

// Shared memory (bytes from a 1024-byte-aligned base).
struct Smem {
  // kConsumers K tiles, then their V tiles; dK and dV after the loop
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kConsumers * kTileBytes;
  static constexpr uint32_t kQ = kV + kConsumers * kTileBytes;  // + stage
  static constexpr uint32_t kDo = kQ + kStages * kTileBytes;
  // two dS^T buffers a consumer
  static constexpr uint32_t kDs = kDo + kStages * kTileBytes;
  // per stage: the 64 rows' lse, then their delta (fp32)
  static constexpr uint32_t kStats = kDs + 2 * kConsumers * kTileBytes;
  static constexpr uint32_t kBar = kStats + kStages * 2 * kTileRows * 4;
  // kv, full[kStages], empty[kStages]
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr size_t kDynamic = kBytes + 1024;  // base alignment
};

struct Params {
  CUtensorMap q, k, v, dout, dk, dv;  // (64, heads, seq, batch) bf16 maps
  const float* lse;    // (batch * heads, q_seq), log2 domain
  const float* delta;  // (batch * heads, q_seq)
  float* dq_ws;        // (batch * heads, q_tiles * kWsTile), zeroed
  int q_seq, kv_seq, heads, q_tiles, kv_blocks;
  float scale, scale_log2;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[(b * heads + h) * q_seq + s] = sum_d dO[b, s, h, d] * O[b, s, h, d],
// one warp a row; with a workspace, the block's threads also zero its n4
// float4s (grid-stride).
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, int rows, int q_seq,
                             int heads, int head_dim, float4* ws,
                             long long n4) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = tid; i < n4; i += static_cast<long long>(gridDim.x) *
                                          blockDim.x)
    ws[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int row = static_cast<int>(tid >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps only
  const size_t base = static_cast<size_t>(row) * head_dim;
  float acc = 0.0f;
  for (int c = lane; c < head_dim; c += 32)
    acc += to_float(o[base + c]) * to_float(dout[base + c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int b = row / (q_seq * heads);
    const int rem = row - b * q_seq * heads;
    const int s = rem / heads;
    const int h = rem - s * heads;
    delta[(static_cast<size_t>(b) * heads + h) * q_seq + s] = acc;
  }
}

// One launch of the delta kernel: 8 warps a block.
template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int batch,
                 int q_seq, int heads, int head_dim, float* ws, long long n4,
                 cudaStream_t stream) {
  const int rows = batch * q_seq * heads;
  delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
      q_seq, heads, head_dim, reinterpret_cast<float4*>(ws), n4);
  return static_cast<int>(cudaGetLastError());
}

// s: the warp's scores S^T of a tile in the C layout (s[4n + i]: key
// key0 + 8 * (i >> 1), query q0 + 8n + 2t + (i & 1)), turned into P^T from
// the tile's lse; with kMask, 0 where the key is past kv_seq, the query
// past q_seq or (kCausal) the key after the query.
template <bool kMask, bool kCausal>
__device__ __forceinline__ void probs(float (&s)[32], const float* lse,
                                      int key0, int q0, int kv_seq,
                                      int q_seq, float scale_log2, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * n + 2 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p = ex2(s[4 * n + i] * scale_log2 - ((i & 1) ? l.y : l.x));
      if constexpr (kMask) {
        const int key = key0 + 8 * (i >> 1);
        const int query = q0 + 8 * n + 2 * t + (i & 1);
        if (key >= kv_seq || query >= q_seq || (kCausal && key > query))
          p = 0.0f;
      }
      s[4 * n + i] = p;
    }
  }
}

// C-layout scores as wgmma's register A operand in bf16: the 16-column
// slice j is the A fragment of column slices 2j and 2j + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[j][x] = pack_bf16(s[8 * j + 2 * x], s[8 * j + 2 * x + 1]);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ Params p) {
  using L = Smem;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_full = bar_kv + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  // Key blocks of one (batch, head) are neighbours in launch order.
  const int bh = blockIdx.x / p.kv_blocks;
  const int kb = blockIdx.x - bh * p.kv_blocks;
  const int k0 = kb * kBlockKeys;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  // Key tiles wholly past kv_seq (a ragged block's last ones) idle.
  const int key_tiles = min(kConsumers, (p.kv_seq - k0 + kTileRows - 1) /
                                            kTileRows);
  // Causal (top-left): the query tiles before the block's first key see
  // none of its keys.
  const int qt_begin = kCausal ? min(k0 / kTileRows, p.q_tiles) : 0;
  const int n_tiles = p.q_tiles - qt_begin;
  // Tile `it` of the loop is query tile qt_begin + (it + rot) % n_tiles.
  const int rot = n_tiles > 0 ? kb % n_tiles : 0;
  auto query_tile = [&](int it) {
    const int r = it + rot;
    return qt_begin + (r >= n_tiles ? r - n_tiles : r);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      // the loads' expected bytes, and the producer warp's lanes (lse, delta)
      mbar_init(bar_full + 8 * s, 33);
      mbar_init(bar_empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = warp_uniform(threadIdx.x / 128);  // kConsumers: producer
  if (role == kConsumers) {
    // The producer warp: the block's K and V tiles once, then the ring.
    const int lane = threadIdx.x & 31;
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_kv, 2 * key_tiles * kTileBytes);
      for (int c = 0; c < key_tiles; ++c) {
        tma_load(base + L::kK + c * kTileBytes, &p.k, bar_kv, h,
                 k0 + c * kTileRows, b);
        tma_load(base + L::kV + c * kTileBytes, &p.v, bar_kv, h,
                 k0 + c * kTileRows, b);
      }
    }
    const float* lse = p.lse + static_cast<size_t>(bh) * p.q_seq;
    const float* delta = p.delta + static_cast<size_t>(bh) * p.q_seq;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int q0 = query_tile(it) * kTileRows;
      mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(bar_full + 8 * s, 2 * kTileBytes);
        tma_load(base + L::kQ + s * kTileBytes, &p.q, bar_full + 8 * s, h,
                 q0, b);
        tma_load(base + L::kDo + s * kTileBytes, &p.dout, bar_full + 8 * s,
                 h, q0, b);
      }
      float* stats =
          reinterpret_cast<float*>(smem + L::kStats) + s * 2 * kTileRows;
      for (int j = lane; j < kTileRows; j += 32) {
        const bool in = q0 + j < p.q_seq;
        stats[j] = in ? lse[q0 + j] : 0.0f;
        stats[kTileRows + j] = in ? delta[q0 + j] : 0.0f;
      }
      mbar_arrive(bar_full + 8 * s);
    }
    return;
  }

  // Consumer warpgroup `role`: keys kw0 .. kw0 + 63.
  const int ctid = threadIdx.x - 128 * role;
  const int warp = ctid >> 5;
  const int lane = ctid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bar_id = 1 + role;  // the warpgroup's named barrier
  const int kw0 = k0 + role * kTileRows;
  if (role >= key_tiles) {  // no key of the tile exists: only release
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      mbar_arrive(bar_empty + 8 * s);
    }
    return;
  }
  const int key0 = kw0 + 16 * warp + g;  // this thread's keys: + 0, + 8
  const uint32_t sK = base + L::kK + role * kTileBytes;
  const uint32_t sV = base + L::kV + role * kTileBytes;
  const bool key_edge = kw0 + kTileRows > p.kv_seq;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
  if (n_tiles > 0) mbar_wait(bar_kv, 0);

  float sc[32], dp[32], dq[32];
  uint32_t pa[4][4], da[4][4];
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int qt = query_tile(it);
    const int q0 = qt * kTileRows;
    const uint32_t sQ = base + L::kQ + s * kTileBytes;
    const uint32_t sDo = base + L::kDo + s * kTileBytes;
    const float* stats =
        reinterpret_cast<const float*>(smem + L::kStats) + s * 2 * kTileRows;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);

    // S^T = K Q^T, then dP^T = V dO^T: 64 keys x 64 queries.
    wgmma_fence();
    wgmma_ss<false>(sc, kmajor_desc(sK, 0), kmajor_desc(sQ, 0));
#pragma unroll
    for (int k = 1; k < kD / 16; ++k)
      wgmma_ss<true>(sc, kmajor_desc(sK, k), kmajor_desc(sQ, k));
    wgmma_commit();
    wgmma_ss<false>(dp, kmajor_desc(sV, 0), kmajor_desc(sDo, 0));
#pragma unroll
    for (int k = 1; k < kD / 16; ++k)
      wgmma_ss<true>(dp, kmajor_desc(sV, k), kmajor_desc(sDo, k));
    wgmma_commit();

    // P^T while the tensor cores finish dP^T; then dV += P^T dO.
    wgmma_wait<1>();
    pin(sc);
    if (key_edge || q0 + kTileRows > p.q_seq ||
        (kCausal && q0 < kw0 + kTileRows))
      probs<true, kCausal>(sc, stats, key0, q0, p.kv_seq, p.q_seq,
                           p.scale_log2, t);
    else
      probs<false, kCausal>(sc, stats, key0, q0, p.kv_seq, p.q_seq,
                            p.scale_log2, t);
    pack_a(pa, sc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs(dv, pa[j], mnmajor_desc(sDo, j));
    wgmma_commit();

    // dS^T = P^T (dP^T - delta) scale while dV runs; then dK += dS^T Q.
    wgmma_wait<1>();
    pin(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(
          stats + kTileRows + 8 * n + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[4 * n + i] = sc[4 * n + i] *
                        (dp[4 * n + i] - ((i & 1) ? dl.y : dl.x)) * p.scale;
    }
    pack_a(da, dp);
    unsigned char* ds_tile =
        smem + L::kDs + (2 * role + (it & 1)) * kTileBytes;
    store_tile_bf16(ds_tile, dp, warp, g, t);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs(dk, da[j], mnmajor_desc(sQ, j));
    wgmma_commit();

    // dQ of the tile = dS K, with dS (the stored dS^T) and K MN-major;
    // every warp's rows of dS^T are in shared memory after the barrier.
    fence_async_smem();
    bar_sync(bar_id, 128);
    const uint32_t sDs = smem_addr(ds_tile);
    wgmma_fence();
    wgmma_ss<false, true>(dq, mnmajor_desc(sDs, 0), mnmajor_desc(sK, 0));
#pragma unroll
    for (int j = 1; j < 4; ++j)
      wgmma_ss<true, true>(dq, mnmajor_desc(sDs, j), mnmajor_desc(sK, j));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq);
    pin(dk);
    pin(dv);
    mbar_arrive(bar_empty + 8 * s);  // Q, dO, lse and delta are read

    // The warpgroup's share of dQ into the workspace tile.
    float* ws = p.dq_ws +
                (static_cast<size_t>(bh) * p.q_tiles + qt) * kWsTile + ctid;
#pragma unroll
    for (int i = 0; i < 32; ++i) atomicAdd(ws + i * 128, dq[i]);
  }

  // Epilogue: dK and dV in bf16 into the K and V tiles once every warp's
  // products are done, then one TMA store each (rows past kv_seq
  // dropped).
  bar_sync(bar_id, 128);
  store_tile_bf16(smem + L::kK + role * kTileBytes, dk, warp, g, t);
  store_tile_bf16(smem + L::kV + role * kTileBytes, dv, warp, g, t);
  fence_async_smem();
  bar_sync(bar_id, 128);
  if (ctid == 0) {
    tma_store(&p.dk, sK, h, kw0, b);
    tma_store(&p.dv, sV, h, kw0, b);
  }
}

// dQ in bf16 BSHD from the workspace: one thread a pair of entries (i,
// i + 1 with i = 4n + 2r: row 16w + g + 8r, columns 8n + 2t and 8n + 2t + 1
// of the tile) of one consumer thread c = 32w + 4g + t.
__global__ void dq_convert_kernel(const float* __restrict__ ws,
                                  __nv_bfloat16* __restrict__ dq, int q_seq,
                                  int heads, int q_tiles, long long pairs) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= pairs) return;
  const long long tile = e >> 11;  // 16 pairs x 128 threads a tile
  const int r = static_cast<int>(e & 2047);
  const int pair = r >> 7;
  const int c = r & 127;
  const int i = 2 * pair;  // = 4n + 2 * (pair & 1)
  const int n = pair >> 1;
  const int row = 16 * (c >> 5) + ((c & 31) >> 2) + 8 * (pair & 1);
  const int col = 8 * n + 2 * (c & 3);
  const int bh = static_cast<int>(tile / q_tiles);
  const int q = static_cast<int>(tile - static_cast<long long>(bh) * q_tiles) *
                    kTileRows + row;
  if (q >= q_seq) return;
  const float* src = ws + tile * kWsTile + c;
  const int b = bh / heads;
  const int h = bh - b * heads;
  *reinterpret_cast<uint32_t*>(
      dq + ((static_cast<size_t>(b) * q_seq + q) * heads + h) * kD + col) =
      pack_bf16(src[i * 128], src[(i + 1) * 128]);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Whether a backward launch runs this body: Sm90Takes over the tensors that
// TMA reads (q, k, v, dO) or writes (dk, dv).
inline bool Sm90BwdTakes(int is_bf16, int head_dim, const void* q,
                         const void* k, const void* v, const void* dout,
                         const void* dk, const void* dv) {
  return Sm90Takes(is_bf16, head_dim, {q, k, v, dout, dk, dv});
}

// Entries of the dQ workspace of a launch: (batch * heads, q_seq rounded up
// to 64, 64) fp32.
inline long long workspace_entries(int batch, int q_seq, int heads) {
  return static_cast<long long>(batch) * heads *
         ((q_seq + kTileRows - 1) / kTileRows) * kWsTile;
}

// One backward on this body (Sm90BwdTakes holds): q, dout, o (batch, q_seq,
// heads, 64), k, v (batch, kv_seq, heads, 64), bf16; lse (batch * heads,
// q_seq) from the forward; delta fp32 scratch like lse; dq_ws fp32 scratch
// of workspace_entries; dq, dk, dv the outputs. The delta kernel (which
// zeroes the workspace), the kernel, then the dQ conversion. Returns a
// cudaError_t.
template <bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, float* dq_ws,
           void* dq, void* dk, void* dv, int batch, int q_seq, int kv_seq,
           int heads, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_sm90_kernel<kCausal>;
  static const cudaError_t ready = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem::kDynamic));
  if (ready != cudaSuccess) return static_cast<int>(ready);
  Params p;
  if (!make_map(&p.q, q, batch, q_seq, heads) ||
      !make_map(&p.k, k, batch, kv_seq, heads) ||
      !make_map(&p.v, v, batch, kv_seq, heads) ||
      !make_map(&p.dout, dout, batch, q_seq, heads) ||
      !make_map(&p.dk, dk, batch, kv_seq, heads) ||
      !make_map(&p.dv, dv, batch, kv_seq, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = lse;
  p.delta = delta;
  p.dq_ws = dq_ws;
  p.q_seq = q_seq;
  p.kv_seq = kv_seq;
  p.heads = heads;
  p.q_tiles = (q_seq + kTileRows - 1) / kTileRows;
  p.kv_blocks = (kv_seq + kBlockKeys - 1) / kBlockKeys;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  const long long blocks = static_cast<long long>(p.kv_blocks) * batch * heads;
  const long long entries = workspace_entries(batch, q_seq, heads);
  if (blocks > (1LL << 31) - 1 || entries / 2 / 256 > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_delta<__nv_bfloat16>(o, dout, delta, batch, q_seq, heads,
                                        kD, dq_ws, entries / 4, stream);
  if (err != 0) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, Smem::kDynamic, stream>>>(
      p);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const long long pairs = entries / 2;
  dq_convert_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0,
                      stream>>>(dq_ws, static_cast<__nv_bfloat16*>(dq), q_seq,
                                heads, p.q_tiles, pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd90
}  // namespace
