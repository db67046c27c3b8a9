// The tilings K5 and K6 of the tail-masked attention for Hopper (sm_90a) in
// bf16 at head dim 64: K1's function under the tiling experiment's shares of
// work, on the TMA + wgmma mainloop of flash_fwd_sm90.cuh.
//
// It replaces, for every bf16 head-dim-64 launch with q, k, v and o 16-byte
// aligned (Sm90Takes, sm90.cuh, the rule K1's forward follows):
//   - K5: tail_hpack of perf/exp_tailvar.py (:75, pallas_call :88, body
//     _hpack_kernel :54), whose grid step takes all query rows of nh
//     batch-heads;
//   - K6: tail_qsplit (:119, pallas_call :132, body _qsplit_kernel :99),
//     whose grid step takes bq query rows of one batch-head (bq 128 or 256,
//     cut by 128 until it divides S padded to 128).
// Every other launch (fp32, other head dims, unaligned pointers) keeps the
// mma.sync and FMA bodies of flash_tail.cu.
//
// The arithmetic is K1's. Each consumer warpgroup runs attend_rows and
// finish_rows of flash_fwd_sm90.cuh on 64 query rows, as
// flash_fwd_sm90_kernel does: S by 4 wgmma m64n64k16, the online softmax in
// the log2 domain, P in registers as the A operand, O += P V with V
// MN-major, the products issued one tile apart, keys >= S masked on the
// last tile only. So every row gets K1's bits. (The TPU kernels take a
// whole softmax row at once; this is K1's online softmax over 64-key
// tiles, which rounds p against the running max, a bf16 rounding apart.)
//
// What bounds it is K1's bound: the tensor cores' rate on paper, the
// softmax's exponentials and ALU work beside them in practice. Only the
// schedule differs:
//   - Block shape: one producer warp that issues TMA (its warpgroup gives
//     its registers up with setmaxnreg) and two consumer warpgroups that
//     own 128 query rows at a time, a "group": 384 threads, one block an
//     SM, 168 registers a thread at launch. The consumers read one K/V
//     ring; a stage's empty barrier waits for both (256 arrivals), so a K/V
//     tile brought from L2 into shared memory serves 128 query rows, where
//     in K1 it serves 64.
//   - Work: a block walks its work items, (batch-head, group) pairs, in
//     order: K6 the bq / 128 groups of its rows of one batch-head, K5 the
//     ceil(S / 128) groups of each of its nh batch-heads. Every item
//     streams its head's K/V through the ring again, from L2 (one head's
//     K/V at S 602 is 154 KB); keeping it resident in shared memory for
//     K6's second group, as the TPU kernel does, measured no faster on the
//     card (PERF.md).
//   - Ping-pong: the consumers take turns issuing their products (two
//     named barriers, Turns below), so that one's softmax runs while the
//     other's products do. It changes no bit; on the card it made K6 3-4%
//     faster and K5 no faster (PERF.md).
//   - The ring never drains between items. The ring position runs on over
//     the items (a consumer knows each tile's stage and phase from it), and
//     the producer runs ahead across group and head boundaries: it loads
//     the next item's Q into the second of two Q buffers and the next
//     item's K/V into stages as they free up.
//   - Epilogue: each consumer writes its 64 rows of O / l into its half of
//     the item's Q buffer, stores them with one TMA store (which drops rows
//     past S) and releases the buffer, while the next item's tiles are
//     already arriving.
//   - Rows past S: the second warpgroup of a group may own only rows past S
//     (the last group at S 448: rows 448-511; at S 20: rows 64-127). Its Q
//     tile is not loaded and it computes nothing, but it still waits for
//     every stage of the item and releases it, or the ring would stall.
//   - The grid is the TPU grid: B*H/nh blocks for K5 (216 at nh 4 for 132
//     SMs at (36, 602, 24): 1.64 waves, the tiling's cost) and B*H times
//     the row blocks for K6; the row blocks of one batch-head are
//     neighbours in launch order, so they share its K/V in L2.
//   - Refuse, don't hang: a ring wait that never completes traps; the
//     launcher checks once that ptxas gave the kernel exactly the
//     registers its setmaxnreg split assumes.

#pragma once

#include "flash_fwd_sm90.cuh"

namespace {
namespace tiling90 {

using namespace sm90;

constexpr int kConsumers = 2;
constexpr int kGroupRows = kConsumers * kTileRows;  // 128
constexpr int kThreads = 128 + kConsumers * 128;    // 384
constexpr int kStages = 8;                          // K/V tiles in flight
// Named barriers: 1 + c orders consumer c's epilogue; kTurnBar + c is
// where consumer c waits for its turn.
constexpr int kTurnBar = 3;

// Registers a thread at launch (65536 / 384, rounded down to the
// allocation's multiple of 8), and after setmaxnreg: the producer's 4 warps
// drop to 24 and the two consumer warpgroups share what they free.
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;  // 168
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs =
    ((kConsumers + 1) * kLaunchRegs - kProducerRegs) / kConsumers / 8 * 8;
static_assert(kConsumerRegs % 8 == 0 && kConsumerRegs <= 256,
              "setmaxnreg takes a multiple of 8 up to 256");

// Shared memory (bytes from a 1024-byte-aligned base).
template <int kRing>
struct Smem {
  // two Q buffers of kConsumers tiles; each consumer's O after its rows
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + 2 * kConsumers * kTileBytes;
  static constexpr uint32_t kV = kK + kRing * kTileBytes;
  static constexpr uint32_t kBar = kV + kRing * kTileBytes;
  // q_full[2], q_empty[2], full[kRing], empty[kRing]
  static constexpr uint32_t kBytes = kBar + 8 * (4 + 2 * kRing);
  static constexpr size_t kDynamic = kBytes + 1024;  // base alignment
};

// The turns of attend_rows (flash_fwd_sm90.cuh): consumer c issues its
// products after the other has issued its own (take: wait on its barrier,
// where the other arrives) and then lets the other issue (pass), so one
// consumer's softmax runs while the other's products do.
struct Turns {
  int mine, other;  // named barriers
  __device__ __forceinline__ void take() const {
    bar_sync(mine, kConsumers * 128);
  }
  __device__ __forceinline__ void pass() const {
    bar_arrive(other, kConsumers * 128);
  }
};

struct Params {
  CUtensorMap q, k, v, o;  // (64, heads, seq, batch) bf16 maps
  // a block takes nh batch-heads and `rows` query rows of each; row_blocks
  // blocks cover the sequence
  int seq, heads, nh, rows, row_blocks, kv_tiles;
  float scale_log2;
};

template <int kRing>
__global__ void __launch_bounds__(kThreads, 1)
    tail_tiling_sm90_kernel(const __grid_constant__ Params p) {
  using L = Smem<kRing>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q_full = base + L::kBar;     // + 8 * buffer
  const uint32_t bar_q_empty = bar_q_full + 16;   // + 8 * buffer
  const uint32_t bar_full = bar_q_empty + 16;     // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kRing;  // + 8 * stage

  // The block takes batch-heads [x nh, (x + 1) nh) and query rows
  // [row0, min(row0 + rows, seq)) of each: `groups` groups a batch-head.
  // Work item w is group w % groups of batch-head x nh + w / groups.
  const int x = blockIdx.x / p.row_blocks;
  const int row0 = (blockIdx.x - x * p.row_blocks) * p.rows;
  const int groups =
      (min(p.rows, p.seq - row0) + kGroupRows - 1) / kGroupRows;
  const int items = p.nh * groups;
  auto item = [&](int w, int& b, int& h, int& q0) {
    const int i = w / groups;
    const int bh = x * p.nh + i;
    b = bh / p.heads;
    h = bh - b * p.heads;
    q0 = row0 + (w - i * groups) * kGroupRows;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar_q_full + 8 * i, 1);
      mbar_init(bar_q_empty + 8 * i, kConsumers);  // one thread a consumer
    }
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = warp_uniform(threadIdx.x / 128);  // 0: producer
  if (role == 0) {
    // Producer warpgroup: warp 0 keeps the Q buffers and the ring full;
    // warps 1-3 only give their registers up.
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int pos = 0;  // ring position of the next K/V tile
      for (int w = 0; w < items; ++w) {
        int b, h, q0;
        item(w, b, h, q0);
        const int buf = w & 1;
        mbar_wait(bar_q_empty + 8 * buf, ((w >> 1) & 1) ^ 1);
        if (lane == 0) {
          // Q tiles wholly past S are not loaded: their consumer idles.
          const int tiles =
              min(kConsumers, (p.seq - q0 + kTileRows - 1) / kTileRows);
          mbar_expect_tx(bar_q_full + 8 * buf, tiles * kTileBytes);
          for (int c = 0; c < tiles; ++c)
            tma_load(base + L::kQ + (buf * kConsumers + c) * kTileBytes,
                     &p.q, bar_q_full + 8 * buf, h, q0 + c * kTileRows, b);
        }
        for (int it = 0; it < p.kv_tiles; ++it, ++pos) {
          const int s = pos % kRing;
          mbar_wait(bar_empty + 8 * s, ((pos / kRing) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(bar_full + 8 * s, 2 * kTileBytes);
            tma_load(base + L::kK + s * kTileBytes, &p.k, bar_full + 8 * s,
                     h, it * kTileRows, b);
            tma_load(base + L::kV + s * kTileBytes, &p.v, bar_full + 8 * s,
                     h, it * kTileRows, b);
          }
        }
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int wg = role - 1;  // the consumer's tile of each group
    const int ctid = threadIdx.x - 128 * role;
    const int warp = ctid >> 5;
    const int lane = ctid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const fwd90::Ring ring = {base + L::kK, base + L::kV, bar_full,
                              bar_empty, nullptr};
    const int no_ids[2] = {0, 0};
    // Every item has kv_tiles + 1 issue points in each consumer; consumer
    // 0 takes the first turn, and consumes consumer 1's last pass at the
    // end.
    const Turns turns = {kTurnBar + wg, kTurnBar + 1 - wg};
    if (wg == 1) bar_arrive(kTurnBar, kConsumers * 128);
    for (int w = 0, first = 0; w < items; ++w, first += p.kv_tiles) {
      int b, h, q0;
      item(w, b, h, q0);
      q0 += wg * kTileRows;
      const int buf = w & 1;
      const uint32_t q_off = L::kQ + (buf * kConsumers + wg) * kTileBytes;
      if (q0 < p.seq) {
        const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
        float o[32], m_run[2], l_run[2];
        mbar_wait(bar_q_full + 8 * buf, (w >> 1) & 1);
        fwd90::attend_rows<kRing, false, false>(
            o, m_run, l_run, base + q_off, ring, first, p.kv_tiles, q0, rows,
            no_ids, p.seq, p.scale_log2, t, turns);
        fwd90::finish_rows<false>(o, m_run, l_run, smem + q_off, nullptr, 0,
                                  rows, p.seq, warp, g, t);
        bar_sync(1 + wg, 128);
        if (ctid == 0) tma_store(&p.o, base + q_off, h, q0, b);
      } else {
        // Rows wholly past S: release the item's stages in ring order,
        // and take and pass the item's turns.
        for (int it = 0; it < p.kv_tiles; ++it) {
          const int pos = first + it;
          mbar_wait(bar_full + 8 * (pos % kRing), (pos / kRing) & 1);
          turns.take();
          turns.pass();
          mbar_arrive(bar_empty + 8 * (pos % kRing));
        }
        turns.take();
        turns.pass();
      }
      // The buffer is free once the store has read it (tma_store waits).
      if (ctid == 0) mbar_arrive(bar_q_empty + 8 * buf);
    }
    if (wg == 0) bar_sync(kTurnBar, kConsumers * 128);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// One launch: q, k, v, o (batch, seq, heads, 64) bf16, 16-byte aligned
// (Sm90Takes); blocks of nh batch-heads (heads % nh == 0) x `rows` query
// rows (K5: nh, rows = seq; K6: nh = 1, rows = bq). Returns a cudaError_t.
inline int launch(const void* q, const void* k, const void* v, void* o,
                  int batch, int seq, int heads, float scale, int nh,
                  int rows, cudaStream_t stream) {
  auto kernel = tail_tiling_sm90_kernel<kStages>;
  // setmaxnreg moves registers that were allocated at launch, so ptxas must
  // have given the kernel exactly kLaunchRegs a thread; checked once.
  static const cudaError_t ready = [kernel] {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<kStages>::kDynamic));
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    return attr.numRegs == kLaunchRegs ? cudaSuccess
                                      : cudaErrorInvalidConfiguration;
  }();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  Params p;
  if (!make_map(&p.q, q, batch, seq, heads) ||
      !make_map(&p.k, k, batch, seq, heads) ||
      !make_map(&p.v, v, batch, seq, heads) ||
      !make_map(&p.o, o, batch, seq, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  p.seq = seq;
  p.heads = heads;
  p.nh = nh;
  p.rows = rows;
  p.row_blocks = (seq + rows - 1) / rows;
  p.kv_tiles = (seq + kTileRows - 1) / kTileRows;
  p.scale_log2 = scale * kLog2e;
  const long long blocks =
      static_cast<long long>(batch) * heads / nh * p.row_blocks;
  if (blocks > (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads,
           Smem<kStages>::kDynamic, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tiling90
}  // namespace
