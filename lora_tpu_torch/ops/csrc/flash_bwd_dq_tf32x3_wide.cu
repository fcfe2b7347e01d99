// Flash-attention dQ backward for Hopper (sm_90a), f32, non-causal, for
// wide heads (96 < D <= 160):
//     dQ = scale * sum_j dS_j K_j
// with Q~ = f32(q) * scale formed by the wrapper, P = exp(Q~ K^T - L) in f32
// from the forward's f32 logsumexp L, dS = P o (dO V^T - delta) in f32,
// delta = rowsum(dO o O) in f32 (the wrapper's). Every product runs on the
// tensor cores as 3xTF32 (hi.hi + hi.lo + lo.hi of tf32 splits, three tf32
// wgmmas into one f32 accumulator, as in flash_bwd_dq_tf32x3.cu); nothing is
// rounded to a lower dtype. dQ comes back in f32 in the layout of the tensor
// it is written to. The sum order is fixed and nothing is atomic: the result
// is the same from run to run.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (:178-207, driven by _bwd :258-300, scaled at :334) for f32
// inputs with 96 < D <= 160, which runs its dots at Precision.HIGHEST, and
// computes what it and ops/flash_attention.py::flash_bwd_dq_reference
// compute. flash_bwd_dq_tf32x3.cu takes D <= 96; flash_bwd.cu's flash_bwd_dq
// (mma.sync) takes D > MAX_DP and strides of 0 (ops/flash_attention.py
// _dq_route picks the kernel from dtype, D and layout alone).
//
// What bounds it on an H100 at SD-1.5's 16x16 level (B = 1, H = 8,
// T = S = 256, D = 160): three products per score (S, dP, dQ), each three
// tf32 products: 3 * 6*B*H*T*S*D = 1.51 GFLOP, 0.0031 ms at 494.7 TFLOP/s
// dense TF32; the bytes (q, k, v, dO, L and delta read once, dQ written
// once: ~6.6 MB) take ~0.002 ms. Both are far below what one CTA takes to
// walk S in kv tiles: at this level the time is the latency of that serial
// walk, and the number of CTAs that share it.
//
// Why not flash_bwd_dq_tf32x3.cu widened: one CTA there holds Q~ and dO hi
// and lo (16 * 64 * DP bytes: 163,840 at DP = 160) beside a ring whose
// stages carry K, V and K^T hi and lo (24 * BN * DP bytes: 61,440 at
// BN = 16), so not two stages fit SMEM_MAX at DP = 160; one consumer
// warpgroup would hold DP / 2 running dQ and DP / 2 per-tile registers a
// thread beside the scores; and 64 q rows a CTA give 32 CTAs on 132 SMs at
// B = 1, H = 8, T = 256.
//
// Design: a cluster of two CTAs per 64 q rows of one head, split by score
// product, with dQ's columns shared by the pair, so each CTA holds half the
// resident operands and half the accumulators, runs the same number of
// products, and the level gets 64 CTAs:
//   * Rank 0, the Q side: Q~ hi / lo resident; streams K hi / lo (kv rows
//     by D); per kv tile S = Q~ K^T (3 x DP/8 wgmma m64nBNk8, both operands
//     in shared memory), the last tile's columns >= S masked to -inf, then
//     P = exp2(S log2(e) - L log2(e)) on the fragments (one FFMA and one
//     ex2.approx a score).
//   * Rank 1, the dO side: dO hi / lo resident; streams V hi / lo; per kv
//     tile dP = dO V^T the same way.
//   * The exchange, both ways, thread for thread: S and dP are m64nBN f32
//     accumulators with one fragment layout, so thread t of rank 0 writes
//     its BN / 2 P registers (16 bytes at a time, consecutive threads on
//     consecutive 16 bytes) into a slot of rank 1's shared memory, thread t
//     of rank 1 its dP registers into a slot of rank 0's, and each reads
//     exactly its own registers back from its own slot. Two slots of
//     RX_BYTES = 64 * BN * 4 bytes each way. The stores are st.async: each
//     counts its 16 bytes on the receiver's `r_full[slot]` mbarrier, whose
//     only arrival is the receiver's own expect_tx of RX_BYTES, and the
//     receiver waits on it (acquire at cluster scope). No thread arrives
//     remotely or fences: flash_bwd_dkv_tf32x3_wide.cu's protocol (plain
//     remote stores, then a remote arrival at cluster scope from each of
//     128 threads, and a second barrier to free the slot) took 0.0310 ms
//     of device time here at the 16x16 level against 0.0225 for this one
//     on an H100 (chip_variants.py times both, and what each part of the
//     kernel costs). Nor is a barrier needed to free a slot: the peer
//     writes tile j + 2 into slot j & 1 only after it has received this
//     CTA's tile j + 1, which this CTA sends after it has read and used
//     tile j from that slot. The two serial chains are the same length, so
//     neither waits long.
//   * Both CTAs then hold the same P and dP floats and form the same
//     dS = P o (dP - delta), each for itself, and split it into tf32 hi and
//     lo register-A fragments, all of them before the run of wgmmas that
//     reads them (a register A written inside a run serialises it: ptxas
//     C7513).
//   * Each CTA computes its own columns of dQ: dQ[:, cols] += dS K^T'[cols]
//     (3 x BN/8 wgmma m64nNRk8, B the wrapper's pi-permuted, kv-innermost
//     K^T, the "dq" part of _tf32x3_operands: 8-row boxes of D, kv along
//     k). DP / 2 is not a multiple of 8 at DP = 104, 120, 136, 152, so the
//     split goes by boxes: rank 0 takes the first NB0 = ceil(DP / 16) and
//     rank 1 the other DP / 8 - NB0 (NR = 8 * its boxes columns). Each CTA
//     streams only its own K^T rows (one TMA box of 8 kv columns by NR D
//     rows per k8 step).
//   * Per-tile accumulator: each kv tile's dQ product goes to a fresh
//     accumulator that is added into the running sum with round-to-nearest
//     FADDs (flash_bwd_dkv_tf32x3.cu's finding: the tensor cores' own f32
//     accumulation is not round-to-nearest and drifts over all of S).
//   * Cluster barriers: one after the mbarriers are initialised (no remote
//     arrival before both CTAs' barriers exist), one before either CTA
//     exits (no CTA leaves while its peer may still write its shared memory
//     or arrive on its barriers).
//   * Each CTA keeps flash_bwd_dkv_tf32x3_wide.cu's pipeline with one
//     consumer warpgroup (threads 0-127, 64 q rows) and a producer warp
//     (warp 4) whose lane 0 issues every TMA load: the resident operand
//     once, the stage's streamed operand and K^T boxes through a ring of
//     `full` / `empty` mbarriers. 4-D f32 tensor maps (cols, rows, H, B)
//     from each tensor's strides (the UNet's transposed views are read,
//     and dQ written, in place), 8-column boxes (32-byte rows, the 32-byte
//     swizzle): one box per k8 step. L * log2(e) (rank 0) and delta (both)
//     are per q row: each consumer thread loads those of its two rows once
//     per CTA into registers, 0 past T.
//   * Ragged tails. Q~ and dO rows past T are TMA's zero fill with L and
//     delta 0: S = 0, P = 1, dP = 0, so dS = 0; the store clips those rows.
//     K and V rows past S are zero too, but there P = exp(-L), which is not
//     0 and overflows f32 for L below about -88, and an inf dS times a zero
//     K^T column is NaN. So rank 0 masks the last tile's columns >= S to
//     -inf before the exponential (P = 0, dS = 0), as
//     flash_bwd_dq_tf32x3.cu does, and rank 1 receives those zeros.
//   * Epilogue: each CTA multiplies its columns of dQ by `scale` in f32,
//     writes them into its resident hi rows in shared memory (no longer
//     read), then one TMA store per box, clipped at T, in q's layout.
//
// Shared memory (BN = 32 kv rows a stage at every DP): the resident operand
// hi and lo take 512 * DP bytes, a stage 256 * DP (K or V hi and lo) plus
// 2 * 4 * 256 * NB0 (the K^T boxes, sized for rank 0's share), the two
// receive slots 2 * 64 * BN * 4, the mbarriers 8 * (2 * STAGES + 3), and
// 1024 bytes of alignment slack; the ring is as deep as that leaves room
// for, at most 4. Registers a consumer thread, in arrays (rank 0's, the
// larger share): NR / 2 running dQ, NR / 2 per-tile accumulator, BN / 2 own
// scores, BN / 2 received, BN hi and lo of the register A: 8 * NB0 + 2 * BN.
// Per instance:
//   DP   stages   shared memory (bytes)   registers (arrays)
//   104  3        193608                  120
//   112  3        203848                  120
//   120  3        220232                  128
//   128  3        230472                  128
//   136  2        193592                  136
//   144  2        201784                  136
//   152  2        214072                  144
//   160  2        222264                  144
// (tests/test_torch_port_tf32x3_wide_dq.py recomputes both from the
// constants below.) 160 threads a CTA, so ptxas may give each up to 255
// registers.
//
// Not taken: the split inside the kernel after TMA lands (the wrapper's
// split is shared with flash_bwd_dkv_tf32x3_wide.cu, which reads it at the
// same D); the next kv tile's S / dP under this tile's dQ product;
// ping-pong of warpgroups.
//
// Entry point: flash_bwd_dq_tf32x3_wide(...) below, a plain C function for
// ctypes with flash_bwd_dq_tf32x3's arguments. It encodes the thirteen TMA
// tensor maps on the host (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint: sm90.cuh), launches on the given stream and
// returns cudaGetLastError() after the launch; it does not synchronise and
// allocates nothing.

#include <math.h>

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BOX = 8;        // f32 columns per TMA box: one k8 step, 32-byte rows
constexpr int MIN_DP = 104;   // the narrowest D instantiated: wider than flash_bwd_dq_tf32x3.cu's
constexpr int MAX_DP = 160;   // the widest D instantiated (a multiple of 8)
constexpr int BM = 64;        // q rows of a cluster pair: one consumer warpgroup each
constexpr int BN = 32;        // kv rows per stage
constexpr int S_ALIGN = 64;   // the transposed copy's kv columns: S rounded up to this
constexpr int THREADS = 160;  // consumer warpgroup, producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

template <int DP>
struct Cfg {
  static constexpr int KB = DP / BOX;          // boxes per row
  static constexpr int NB0 = (KB + 1) / 2;     // rank 0's dQ column boxes
  static constexpr int NB1 = KB - NB0;         // rank 1's
  static constexpr int NK = BN / BOX;          // k8 steps of dQ per tile
  static constexpr int BOX_Q = BM * BOX;       // elements of one Q~ or dO box
  static constexpr int BOX_KV = BN * BOX;      // of one K or V box (kv rows)
  static constexpr int BOX_T = NB0 * BOX * BOX;  // of one K^T box (NB0 * 8 D rows)
  // shared memory of a stage: hi and lo of K (rank 0) or V (rank 1) and of
  // the K^T boxes
  static constexpr int STAGE_BYTES = (2 * KB * BOX_KV + 2 * NK * BOX_T) * 4;
  // TMA bytes of a stage: rank 0's K^T boxes fill their slots (NB0 boxes
  // of 8 D rows), rank 1's hold NB1 (the full boxes are counted even where
  // TMA zero-fills past the edge)
  static constexpr uint32_t TX0 = STAGE_BYTES;
  static constexpr uint32_t TX1 = (2 * KB * BOX_KV + 2 * NK * NB1 * BOX * BOX) * 4;
  static constexpr int X_BYTES = 2 * KB * BOX_Q * 4;  // the resident operand, hi and lo
  static constexpr int RX_BYTES = BM * BN * 4;       // the scores a CTA receives per tile
  static constexpr int P_BYTES = 2 * RX_BYTES;        // the two receive slots
  // ring depth: what shared memory holds beside the resident operand and
  // the slots (and 1024 bytes of alignment slack, 256 of barriers), at most 4
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - X_BYTES - P_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(DP % BOX == 0 && DP >= MIN_DP && DP <= MAX_DP && STAGES >= 2 &&
                    S_ALIGN % BN == 0,
                "tile");
};

// Shared memory of one CTA from a 1024-byte aligned base; the same layout
// in both CTAs of the pair, so a peer's address is this CTA's offset
// (cluster_map). Every box is a multiple of 256 bytes, the 32-byte
// swizzle's period.
template <int DP>
struct Smem {
  using C = Cfg<DP>;
  float x[2][C::KB][C::BOX_Q];               // Q~ (rank 0) or dO (rank 1) hi, lo; dQ in x[0]
  float b[C::STAGES][2][C::KB][C::BOX_KV];   // K (rank 0) or V (rank 1) hi, lo
  float kt[C::STAGES][2][C::NK][C::BOX_T];   // this rank's rows of K^T hi, lo (pi)
  float p[2][C::NK][128 * 4];                // received P (rank 1) or dP (rank 0) slots
  uint64_t full[C::STAGES];
  uint64_t empty[C::STAGES];
  uint64_t x_full;
  uint64_t r_full[2];  // the peer's RX_BYTES have landed in this CTA's slot
};

template <int DP>
constexpr size_t kSmemBytes = sizeof(Smem<DP>) + 1024;  // + alignment slack

// The thirteen tensor maps, by rank: the resident operand (Q~, dO), the
// streamed one (K, V) and this rank's rows of K^T, each hi and lo; and dQ
struct Maps {
  CUtensorMap x[2][2], b[2][2], kt[2][2], dq;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The consumer warpgroup of one rank, whose dQ columns are NB boxes from box
// c0: the kv loop, the exchange, and the epilogue
template <int DP, int NB>
__device__ __forceinline__ void consume(Smem<DP>& s, const Maps& m, uint32_t rank, int c0,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, int q0, int h, int b,
                                        int T, int S, float scale) {
  using C = Cfg<DP>;
  constexpr int KB = C::KB;
  constexpr int NK = C::NK;
  constexpr int NR = NB * BOX;  // dQ columns of this rank
  constexpr int STAGES = C::STAGES;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // accumulator fragments: warp w holds rows 16w + g and 16w + g + 8 of the
  // 64 q rows, columns 8i + 2t and 8i + 2t + 1 of each n8 block i (kv
  // columns of the tile for S and dP, this rank's D columns for dQ)
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;

  // L * log2(e) and delta of this thread's rows r0 and r0 + 8, 0 past T
  const int row = q0 + r0;
  const long long bh = blockIdx.y;
  const float l0 = row < T ? lse[bh * T + row] * LOG2E : 0.f;
  const float l1 = row + 8 < T ? lse[bh * T + row + 8] * LOG2E : 0.f;
  const float d0 = row < T ? delta[bh * T + row] : 0.f;
  const float d1 = row + 8 < T ? delta[bh * T + row + 8] : 0.f;

  // descriptors (32-byte swizzle: 8-row groups of 32-byte rows, 256 bytes
  // apart), all K-major: the resident hi / lo as the A of S or dP, box kb
  // one k8 step further; the streamed K or V as their B; this rank's K^T
  // boxes as the B of dQ, box nk one k8 step (8 kv rows) further
  constexpr uint32_t X_STEP = C::BOX_Q * 4 / 16;  // descriptor units (16 bytes)
  constexpr uint32_t B_STEP = C::BOX_KV * 4 / 16;
  constexpr uint32_t T_STEP = C::BOX_T * 4 / 16;
  uint64_t xd[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) xd[x] = smem_desc(s.x[x][0], 16, 256, DESC_SWIZZLE_32B);
  // the peer's receive slots (this CTA writes them) and the peer's barriers
  // that count those bytes, slot 1 eight bytes after slot 0
  const uint32_t peer = rank ^ 1;
  const uint32_t peer_p = cluster_map(s.p, peer);
  const uint32_t peer_full = cluster_map(s.r_full, peer);

  float sum[NR / 2];  // this rank's columns of dQ
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) sum[i] = 0.f;
  const int n_tiles = (S + BN - 1) / BN;
  int stage = 0;
  uint32_t phase = 0;

  mbar_wait(&s.x_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(&s.full[stage], phase);
    uint64_t bd[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) bd[x] = smem_desc(s.b[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
    // S = Q~ K^T (rank 0) or dP = dO V^T (rank 1): hi.hi, hi.lo, lo.hi per
    // k8 step into a fresh accumulator (scale-d 0 first)
    float sc[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      wgmma_ss_tf32(sc, xd[0] + kb * X_STEP, bd[0] + kb * B_STEP, kb);
      wgmma_ss_tf32(sc, xd[0] + kb * X_STEP, bd[1] + kb * B_STEP, 1);
      wgmma_ss_tf32(sc, xd[1] + kb * X_STEP, bd[0] + kb * B_STEP, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if (rank == 0) {
      // P = exp2(S log2(e) - L log2(e)), L per q row; the last tile's
      // columns >= S first to -inf (P = 0 there)
      const int valid = S - j * BN;
      if (valid < BN) {
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          const int col = 8 * i + 2 * t;
          if (col >= valid) sc[4 * i] = sc[4 * i + 2] = -INFINITY;
          if (col + 1 >= valid) sc[4 * i + 1] = sc[4 * i + 3] = -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        sc[4 * i] = ex2(fmaf(sc[4 * i], LOG2E, -l0));
        sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], LOG2E, -l0));
        sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], LOG2E, -l1));
        sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], LOG2E, -l1));
      }
    }

    // the exchange: this thread's scores into the peer's slot, each 16
    // bytes counted on the peer's r_full[slot]; then the peer's from this
    // CTA's slot, once all RX_BYTES of them have landed
    const int slot = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    if (tid == 0) mbar_expect_tx(&s.r_full[slot], C::RX_BYTES);
#pragma unroll
    for (int i = 0; i < NK; ++i)
      st_async_v4(peer_p + ((slot * NK + i) * 128 + tid) * 16,
                  make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]),
                  peer_full + 8 * slot);
    mbar_wait_cluster(&s.r_full[slot], parity);
    float4 rv[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i) rv[i] = reinterpret_cast<const float4*>(s.p[slot][i])[tid];

    // dS = P o (dP - delta), the same floats in the same order on both
    // ranks: P is rank 0's own and rank 1's received, dP the other way
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const float4 own = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
      const float4 pv = rank == 0 ? own : rv[i];
      const float4 dv = rank == 0 ? rv[i] : own;
      sc[4 * i] = pv.x * (dv.x - d0);
      sc[4 * i + 1] = pv.y * (dv.y - d0);
      sc[4 * i + 2] = pv.z * (dv.z - d1);
      sc[4 * i + 3] = pv.w * (dv.w - d1);
    }
    // dS as tf32 register-A fragments, hi and lo: the k8 step i takes
    // accumulator registers (d0, d2, d1, d3) of n8 block i (pi)
    uint32_t ah[BN / 2], al[BN / 2];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int src = 4 * i + ((r & 1) << 1) + (r >> 1);  // 0, 2, 1, 3
        split_tf32(sc[src], ah[4 * i + r], al[4 * i + r]);
      }
    }
    fence_u32(ah);  // every A register is written before the wgmmas start
    fence_u32(al);

    // dQ[:, this rank's columns] += dS K^T' (B: this rank's K^T boxes) into
    // a fresh accumulator added into the sum with round-to-nearest FADDs
    uint64_t td[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) td[x] = smem_desc(s.kt[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
    float acc[NR / 2];
    wgmma_fence();
#pragma unroll
    for (int nk = 0; nk < NK; ++nk) {
      wgmma_rs_tf32(acc, ah + 4 * nk, td[0] + nk * T_STEP, nk);
      wgmma_rs_tf32(acc, ah + 4 * nk, td[1] + nk * T_STEP, 1);
      wgmma_rs_tf32(acc, al + 4 * nk, td[0] + nk * T_STEP, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) sum[i] += acc[i];
    fence_u32(ah);
    fence_u32(al);
    if (lane == 0) mbar_arrive(&s.empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // epilogue: dQ * scale in f32 into the resident hi rows (32-byte swizzle:
  // 16-byte chunk c of row r at c ^ ((r >> 2) & 1)), then a TMA store per
  // box, clipped at T
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the resident reads are done
  const int swz = (r0 >> 2) & 1;  // the same for r0 + 8
  const int off = r0 * 32 + (((t >> 1) ^ swz) << 4) + ((t & 1) << 3);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    uint8_t* o = reinterpret_cast<uint8_t*>(s.x[0][i]) + off;
    *reinterpret_cast<float2*>(o) = make_float2(sum[4 * i] * scale, sum[4 * i + 1] * scale);
    *reinterpret_cast<float2*>(o + 8 * 32) =
        make_float2(sum[4 * i + 2] * scale, sum[4 * i + 3] * scale);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < NB; ++i) tma_store_4d(&m.dq, s.x[0][i], (c0 + i) * BOX, q0, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // the stores have read shared memory before the CTA exits
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

template <int DP>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
    flash_bwd_dq_tf32x3_wide_kernel(const __grid_constant__ Maps m,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta, int H, int T, int S,
                                    float scale) {
  using C = Cfg<DP>;
  constexpr int KB = C::KB;
  constexpr int NK = C::NK;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Smem<DP>& s = *reinterpret_cast<Smem<DP>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const uint32_t rank = cluster_ctarank();  // 0: S, P; 1: dP. Both: dS, their dQ columns
  const int q0 = (blockIdx.x >> 1) * BM;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int n_tiles = (S + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);   // the TMA thread's expect_tx arrival
      mbar_init(&s.empty[i], 4);  // one arrival per consumer warp
    }
    mbar_init(&s.x_full, 1);
    // this CTA's expect_tx arrival; the peer's asynchronous stores count
    // their bytes
    for (int i = 0; i < 2; ++i) mbar_init(&s.r_full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both CTAs' barriers exist before any remote arrival

  if (threadIdx.x >= 128) {
    // ---- producer warp: lane 0 issues every TMA load ----
    if (threadIdx.x == 128) {
      const uint32_t tx = rank == 0 ? C::TX0 : C::TX1;
      const int kt_row = rank == 0 ? 0 : C::NB0 * BOX;  // this rank's first D row of K^T
      mbar_expect_tx(&s.x_full, C::X_BYTES);
      for (int x = 0; x < 2; ++x)
        for (int kb = 0; kb < KB; ++kb)
          tma_load_4d(s.x[x][kb], &m.x[rank][x], &s.x_full, kb * BOX, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        uint64_t* bar = &s.full[stage];
        mbar_expect_tx(bar, tx);
        for (int x = 0; x < 2; ++x) {
          for (int kb = 0; kb < KB; ++kb)
            tma_load_4d(s.b[stage][x][kb], &m.b[rank][x], bar, kb * BOX, j * BN, h, b);
          for (int nk = 0; nk < NK; ++nk)
            tma_load_4d(s.kt[stage][x][nk], &m.kt[rank][x], bar, j * BN + nk * BOX, kt_row, h,
                        b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else if (rank == 0) {
    consume<DP, C::NB0>(s, m, rank, 0, lse, delta, q0, h, b, T, S, scale);
  } else {
    consume<DP, C::NB1>(s, m, rank, C::NB0, lse, delta, q0, h, b, T, S, scale);
  }
  // neither CTA leaves while its peer may still write its shared memory or
  // arrive on its barriers
  cluster_sync();
}

constexpr int MAX_DEVICES = 64;

// The instance's shared-memory limit, raised once per device
template <int DP>
cudaError_t prepare() {
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_dq_tf32x3_wide_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes<DP>);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ptrs: hi, lo of Q~, dO, K, V, K^T (10), then dQ; st: their (batch, head,
// row) element strides, 3 each
template <int DP>
cudaError_t launch(EncodeTiled fn, const void* const* ptrs, const float* lse, const float* delta,
                   const long long* st, int B, int H, int T, int S, int D, float scale,
                   cudaStream_t stream) {
  using C = Cfg<DP>;
  const cudaError_t e = prepare<DP>();
  if (e != cudaSuccess) return e;
  static_assert(kSmemBytes<DP> <= SMEM_MAX, "shared memory");
  const int Sp = (S + S_ALIGN - 1) / S_ALIGN * S_ALIGN;  // the transposed copy's kv columns
  Maps m;
  bool ok = true;
  for (int x = 0; x < 2; ++x) {
    // rank 0: Q~ resident, K and its K^T rows streamed; rank 1: dO, V and
    // the other K^T rows
    ok = ok && encode_bhtd(fn, &m.x[0][x], ptrs[x], st + 3 * x, B, H, T, D, BM, F32) &&
         encode_bhtd(fn, &m.x[1][x], ptrs[2 + x], st + 3 * (2 + x), B, H, T, D, BM, F32) &&
         encode_bhtd(fn, &m.b[0][x], ptrs[4 + x], st + 3 * (4 + x), B, H, S, D, BN, F32) &&
         encode_bhtd(fn, &m.b[1][x], ptrs[6 + x], st + 3 * (6 + x), B, H, S, D, BN, F32) &&
         encode_bhtd(fn, &m.kt[0][x], ptrs[8 + x], st + 3 * (8 + x), B, H, D, Sp,
                     C::NB0 * BOX, F32) &&
         encode_bhtd(fn, &m.kt[1][x], ptrs[8 + x], st + 3 * (8 + x), B, H, D, Sp,
                     C::NB1 * BOX, F32);
  }
  ok = ok && encode_bhtd(fn, &m.dq, ptrs[10], st + 30, B, H, T, D, BM, F32);
  if (!ok) return cudaErrorInvalidValue;
  // two CTAs (one cluster) per BM q rows of each head
  const dim3 grid(2 * ((T + BM - 1) / BM), B * H);
  flash_bwd_dq_tf32x3_wide_kernel<DP><<<grid, THREADS, kSmemBytes<DP>, stream>>>(m, lse, delta, H,
                                                                                 T, S, scale);
  return cudaGetLastError();
}

}  // namespace

// Arguments as flash_bwd_dq_tf32x3's: q~ (f32(q) * scale), dout, k, v, each
// as hi and lo (tf32 bit patterns: the wrapper's _split_tf32), and the
// pi-permuted transposed copy of k, hi and lo, (B, H, D, S') with S' = S
// rounded up to S_ALIGN, zeros past S; dq the f32 output. Every tensor has
// a unit last stride. strides: 33 element strides, (batch, head, row) for
// each of the eleven tensors in that order, each positive and a multiple of
// 4 (TMA's 16-byte global strides); 16-byte aligned bases. lse and delta:
// (B, H, T) f32 contiguous. bm: q rows per cluster pair, BM (64) only. scale
// multiplies dQ in the epilogue (Q~ carries it into the scores). Returns a
// cudaError_t: cudaErrorInvalidValue for what the kernel does not take (the
// wrapper routes those calls elsewhere first) or a map that cannot be
// encoded.
extern "C" int flash_bwd_dq_tf32x3_wide(const void* qh, const void* ql, const void* oh,
                                        const void* ol, const void* kh, const void* kl,
                                        const void* vh, const void* vl, const void* kth,
                                        const void* ktl, const void* lse, const void* delta,
                                        void* dq, const long long* strides, int B, int H, int T,
                                        int S, int D, int bm, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1 || S < 1 || D < MIN_DP || D > MAX_DP || D % 8 != 0 ||
      (long long)B * H > 65535 || bm != BM) {
    return (int)cudaErrorInvalidValue;
  }
  const void* const ptrs[11] = {qh, ql, oh, ol, kh, kl, vh, vl, kth, ktl, dq};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 33; ++i) {
    if (strides[i] <= 0 || strides[i] % 4 != 0) return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define DQ_WIDE_CASE(DP_) \
  case DP_:               \
    return (int)launch<DP_>(fn, ptrs, L, Dl, strides, B, H, T, S, D, scale, st);
    DQ_WIDE_CASE(104)
    DQ_WIDE_CASE(112)
    DQ_WIDE_CASE(120)
    DQ_WIDE_CASE(128)
    DQ_WIDE_CASE(136)
    DQ_WIDE_CASE(144)
    DQ_WIDE_CASE(152)
    DQ_WIDE_CASE(160)
#undef DQ_WIDE_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The instance that takes head dim D: out = {DP, BN, STAGES, dynamic shared
// memory bytes, BM, rank 0's dQ column boxes}. Returns 0, or
// cudaErrorInvalidValue for a D no instance takes.
extern "C" int flash_bwd_dq_tf32x3_wide_config(int D, int* out) {
  switch (D) {
#define DQ_WIDE_CONFIG(DP_)         \
  case DP_:                         \
    out[0] = DP_;                   \
    out[1] = BN;                    \
    out[2] = Cfg<DP_>::STAGES;      \
    out[3] = (int)kSmemBytes<DP_>;  \
    out[4] = BM;                    \
    out[5] = Cfg<DP_>::NB0;         \
    return 0;
    DQ_WIDE_CONFIG(104)
    DQ_WIDE_CONFIG(112)
    DQ_WIDE_CONFIG(120)
    DQ_WIDE_CONFIG(128)
    DQ_WIDE_CONFIG(136)
    DQ_WIDE_CONFIG(144)
    DQ_WIDE_CONFIG(152)
    DQ_WIDE_CONFIG(160)
#undef DQ_WIDE_CONFIG
  }
  return (int)cudaErrorInvalidValue;
}
