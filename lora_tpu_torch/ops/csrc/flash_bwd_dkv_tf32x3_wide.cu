// Flash-attention dK/dV backward for Hopper (sm_90a), f32, non-causal, for
// wide heads (96 < D <= 160):
//     dV = sum_i P_i^T dO_i,     dK = sum_i dS_i^T Q~_i
// with Q~ = f32(q) * scale formed by the wrapper, P = exp(Q~ K^T - L) in f32
// from the forward's f32 logsumexp L, dS = P o (dO V^T - delta) in f32,
// delta = rowsum(dO o O) in f32 (the wrapper's). Every product runs on the
// tensor cores as 3xTF32 (hi.hi + hi.lo + lo.hi of tf32 splits, three tf32
// wgmmas into one f32 accumulator, as in flash_bwd_dkv_tf32x3.cu); nothing
// is rounded to a lower dtype. dK and dV come back in f32 in k's and v's
// layouts. The sum order is fixed and nothing is atomic: the result is the
// same from run to run.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel (:210-255, driven by _bwd :258-332) for f32 inputs with
// 96 < D <= 160, which runs its dots at Precision.HIGHEST, and computes what
// it and ops/flash_attention.py::flash_bwd_dkv_reference compute.
// flash_bwd_dkv_tf32x3.cu takes D <= 96; flash_bwd.cu's flash_bwd_dkv
// (mma.sync) takes D > MAX_DP and strides of 0 (ops/flash_attention.py
// _bwd_route picks the kernel from dtype, D and layout alone).
//
// What bounds it on an H100 at SD-1.5's 16x16 level (B = 1, H = 8,
// T = S = 256, D = 160): four products per score (S^T, dP^T, dV, dK), each
// three tf32 products: 3 * 8*B*H*T*S*D = 2.01 GFLOP, 0.0041 ms at 494.7
// TFLOP/s dense TF32; the bytes (q, k, v, dO, L and delta read once, dK and
// dV written once: ~8 MB) take ~0.0025 ms. Both are far below what one CTA
// takes to walk T in q tiles: at this level the time is the latency of that
// serial walk, and the number of CTAs that share it.
//
// Why not flash_bwd_dkv_tf32x3.cu widened: one CTA there holds K and V hi
// and lo (16 * 64 * DP bytes: 163,840 at DP = 160) beside a ring whose
// stages carry Q~, dO, Q~^T and dO^T hi and lo (32 * BQ * DP bytes), so two
// stages do not fit SMEM_MAX at DP = 160 even at BQ = 8; one consumer
// warpgroup would hold DP / 2 dK, DP / 2 dV and DP / 2 per-tile registers
// a thread (~260 with the scores, above 255); and 64 kv rows a CTA give 32
// CTAs on 132 SMs at B = 1, H = 8, S = 256.
//
// Design: a cluster of two CTAs per 64 kv rows of one head, split by
// product, so each CTA holds half the resident operands and half the
// accumulators, and the level gets 64 CTAs:
//   * Rank 0, the K side: K hi / lo resident; streams Q~ hi / lo (q rows by
//     D) and dO^T hi / lo (D rows by q); per q tile S^T = K Q~^T (3 x DP/8
//     wgmma m64nBQk8, both operands in shared memory), P^T =
//     exp2(S^T log2(e) - L log2(e)) on the fragments (one FFMA and one
//     ex2.approx a score); hands P^T to rank 1; dV += P^T dO (3 x BQ/8
//     wgmma m64nDPk8, P^T as register A). It owns dV.
//   * Rank 1, the V side: V hi / lo resident; streams dO hi / lo and Q~^T
//     hi / lo; per q tile dP^T = V dO^T, then waits for the tile's P^T,
//     dS^T = P^T o (dP^T - delta) in f32, dK += dS^T Q~ (dS^T as register
//     A). It owns dK.
//   * P^T passes thread for thread: S^T and dP^T are m64nBQ f32
//     accumulators with one fragment layout, so thread t of rank 0 writes
//     its BQ / 2 P^T registers (st.shared::cluster, 16 bytes at a time,
//     consecutive threads on consecutive 16 bytes) into a slot of rank 1's
//     shared memory, and thread t of rank 1 reads exactly its own registers
//     back. Two slots of 64 * BQ * 4 bytes (4 KB at BQ = 16): rank 0 waits
//     on its `p_empty[slot]` before it writes, then arrives on rank 1's
//     `p_full[slot]` (a remote mbarrier arrival, release at cluster scope;
//     128 arrivals, one a thread); rank 1 waits on `p_full[slot]` (acquire
//     at cluster scope), reads, and frees the slot with a remote arrival on
//     rank 0's `p_empty[slot]`. Rank 0 can run two tiles ahead; neither
//     waits on the other otherwise, and the two serial chains are the same
//     length, so rank 1's wait is short.
//   * Cluster barriers: one after the mbarriers are initialised (no remote
//     arrival before both CTAs' barriers exist), one before either CTA
//     exits (no CTA leaves while its peer may still write its shared
//     memory or arrive on its barriers).
//   * Each CTA keeps flash_bwd_dkv_tf32x3.cu's pipeline with one consumer
//     warpgroup (threads 0-127, 64 kv rows): a producer warp (warp 4) whose
//     lane 0 issues every TMA load, the resident operand once and the
//     stage's two streamed operands through a ring of `full` / `empty`
//     mbarriers; a staging warp (warp 5) that writes L * log2(e) (rank 0)
//     or delta (rank 1) of the stage's q rows, 0 past T, and arrives on the
//     same `full` barrier. 4-D f32 tensor maps (cols, rows, H, B) from each
//     tensor's strides, 8-column boxes (32-byte rows, the 32-byte swizzle):
//     one box per k8 step, D padded to DP with zeros in shared memory only.
//   * tf32 wgmma has no transpose bits, so dV and dK read the wrapper's
//     transposed, pi-permuted copies dO^T and Q~^T (B, H, D, T') as their
//     B (flash_bwd_dkv_tf32x3.cu's operands, the same twelve tensors: the
//     "dkv" part of _tf32x3_operands); with pi, the A registers of k8 step
//     i are the accumulator registers (d0, d2, d1, d3) of n8 block i, split
//     into hi and lo in registers before the run of wgmmas that reads them
//     (a register A written inside a run serialises it: ptxas C7513).
//   * Per-tile accumulator: each q tile's dV or dK product goes to a fresh
//     accumulator that is added into the running sum with round-to-nearest
//     FADDs (flash_bwd_dkv_tf32x3.cu's finding: the tensor cores' own f32
//     accumulation is not round-to-nearest and drifts over all of T).
//   * Q~ rows past T are TMA's zero fill (in the transposed copies, the
//     wrapper's zeros and TMA's), and their L and delta are staged as 0:
//     P = 1 there against dO = 0 and delta = 0, so dS = 0 and those rows
//     add nothing. kv rows past S give rows that the store clips.
//   * Epilogue: each CTA writes its own output (rank 0 dV, rank 1 dK) in
//     f32 into its resident hi rows in shared memory (no longer read), then
//     one TMA store per box, clipped at S, in k's or v's layout.
//
// Shared memory (BQ = 16 q rows a stage at every DP): the resident operand
// hi and lo take 512 * DP bytes, a stage 16 * BQ * DP (plus BQ * 4 of L or
// delta), the two P^T slots 2 * 64 * BQ * 4, the mbarriers 8 * (2 * STAGES
// + 5), and 1024 bytes of alignment slack; the ring is as deep as that
// leaves room for, at most 4. Registers a consumer thread, in arrays:
// DP / 2 running dV or dK, DP / 2 per-tile accumulator, BQ / 2 scores, BQ
// hi and lo of the register A: DP + 24. Per instance:
//   DP   stages   shared memory (bytes)   registers (arrays)
//   104  4        169320                  128
//   112  4        181608                  136
//   120  4        193896                  144
//   128  4        206184                  152
//   136  4        218472                  160
//   144  4        230760                  168
//   152  3        204056                  176
//   160  3        214296                  184
// (tests/test_torch_port_tf32x3_wide.py recomputes both from the constants
// below.) 192 threads a CTA, so ptxas may give each up to 255 registers.
//
// Not taken: splitting the q range of a kv tile over G cluster pairs (more
// CTAs at B = 1) would need a workspace of partial dK and dV and a second,
// fixed-order pass to stay deterministic; the f32 step is host-bound, so
// the pair's launch stays one. Also left for later: the split inside the
// kernel after TMA lands, and the next q tile's S^T / dP^T under this
// tile's dV / dK products.
//
// Entry point: flash_bwd_dkv_tf32x3_wide(...) below, a plain C function for
// ctypes with flash_bwd_dkv_tf32x3's arguments. It encodes the fourteen TMA
// tensor maps on the host (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint: sm90.cuh), launches on the given stream and
// returns cudaGetLastError() after the launch; it does not synchronise and
// allocates nothing.

#include <math.h>

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BOX = 8;        // f32 columns per TMA box: one k8 step, 32-byte rows
constexpr int MIN_DP = 104;   // the narrowest D instantiated: wider than flash_bwd_dkv_tf32x3.cu's
constexpr int MAX_DP = 160;   // the widest D instantiated (a multiple of 8)
constexpr int BN = 64;        // kv rows of a cluster pair: one consumer warpgroup each
constexpr int BQ = 16;        // q rows per stage
constexpr int T_ALIGN = 32;   // the transposed copies' q columns: T rounded up to this
constexpr int THREADS = 192;  // consumer warpgroup, producer warp, staging warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

template <int DP>
struct Cfg {
  static constexpr int KB = DP / BOX;     // boxes per row
  static constexpr int QB = BQ / BOX;     // k8 steps of dV and dK per tile
  static constexpr int BOX_KV = BN * BOX;  // elements of one K or V box
  static constexpr int BOX_Q = BQ * BOX;   // of one Q~ or dO box (q rows)
  static constexpr int BOX_T = DP * BOX;   // of one Q~^T or dO^T box (D rows)
  // what TMA brings per stage: hi and lo of two streamed operands
  static constexpr int STAGE_BYTES = 16 * BQ * DP;
  static constexpr int X_BYTES = 2 * KB * BOX_KV * 4;  // the resident operand, hi and lo
  static constexpr int P_BYTES = 2 * BN * BQ * 4;      // the two P^T slots
  // ring depth: what shared memory holds beside the resident operand and
  // the P^T slots (and 1024 bytes of alignment slack, 256 of barriers), at
  // most 4
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - X_BYTES - P_BYTES) / (STAGE_BYTES + BQ * 4);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(DP % BOX == 0 && DP >= MIN_DP && DP <= MAX_DP && STAGES >= 2, "tile");
};

// Shared memory of one CTA from a 1024-byte aligned base; the same layout
// in both CTAs of the pair, so a peer's address is this CTA's offset
// (cluster_map). Every box is a multiple of 256 bytes, the 32-byte
// swizzle's period.
template <int DP>
struct Smem {
  using C = Cfg<DP>;
  float x[2][C::KB][C::BOX_KV];                 // K (rank 0) or V (rank 1) hi, lo; the output in x[0]
  float a[C::STAGES][2][C::KB][C::BOX_Q];       // Q~ (rank 0) or dO (rank 1) hi, lo
  float at[C::STAGES][2][C::QB][C::BOX_T];      // dO^T (rank 0) or Q~^T (rank 1) hi, lo (pi)
  float p[2][C::QB][128 * 4];                   // P^T slots (rank 1's), 16 bytes a thread per n8 block
  float vec[C::STAGES][BQ];                     // L * log2(e) (rank 0) or delta (rank 1); 0 past T
  uint64_t full[C::STAGES];
  uint64_t empty[C::STAGES];
  uint64_t kv_full;
  uint64_t p_full[2];   // rank 1's: rank 0's 128 threads have written the slot
  uint64_t p_empty[2];  // rank 0's: rank 1's 128 threads have read the slot
};

template <int DP>
constexpr size_t kSmemBytes = sizeof(Smem<DP>) + 1024;  // + alignment slack

// The fourteen tensor maps, by rank: the resident operand (K, V), the
// streamed one in its own layout (Q~, dO) and the transposed one (dO^T,
// Q~^T), each hi and lo, and the output (dV, dK)
struct Maps {
  CUtensorMap x[2][2], a[2][2], at[2][2], out[2];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_tf32x3_wide_kernel(const __grid_constant__ Maps m,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, int H, int T) {
  using C = Cfg<DP>;
  constexpr int KB = C::KB;
  constexpr int QB = C::QB;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Smem<DP>& s = *reinterpret_cast<Smem<DP>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const uint32_t rank = cluster_ctarank();  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const uint32_t peer = rank ^ 1;
  const int kv0 = (blockIdx.x >> 1) * BN;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int n_tiles = (T + BQ - 1) / BQ;
  const int warp_id = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1 + 32);  // the TMA thread's expect_tx + the staging warp
      mbar_init(&s.empty[i], 4);      // one arrival per consumer warp
    }
    mbar_init(&s.kv_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.p_full[i], 128);   // every thread of rank 0's consumer warpgroup
      mbar_init(&s.p_empty[i], 128);  // every thread of rank 1's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both CTAs' barriers exist before any remote arrival

  if (warp_id == 4) {
    // ---- producer warp: lane 0 issues every TMA load; the full boxes are
    // counted even where TMA zero-fills past the edge ----
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(&s.kv_full, C::X_BYTES);
      for (int x = 0; x < 2; ++x)
        for (int kb = 0; kb < KB; ++kb)
          tma_load_4d(s.x[x][kb], &m.x[rank][x], &s.kv_full, kb * BOX, kv0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        uint64_t* bar = &s.full[stage];
        mbar_expect_tx(bar, C::STAGE_BYTES);
        for (int x = 0; x < 2; ++x) {
          for (int kb = 0; kb < KB; ++kb)
            tma_load_4d(s.a[stage][x][kb], &m.a[rank][x], bar, kb * BOX, j * BQ, h, b);
          for (int qb = 0; qb < QB; ++qb)
            tma_load_4d(s.at[stage][x][qb], &m.at[rank][x], bar, j * BQ + qb * BOX, 0, h, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else if (warp_id == 5) {
    // ---- staging warp: L * log2(e) (rank 0) or delta (rank 1) of each q tile ----
    const int lane = threadIdx.x & 31;
    const float* src = (rank == 0 ? lse : delta) + (long long)blockIdx.y * T;
    const float mul = rank == 0 ? LOG2E : 1.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&s.empty[stage], phase ^ 1);
      for (int i = lane; i < BQ; i += 32) {
        const int row = j * BQ + i;
        s.vec[stage][i] = row < T ? src[row] * mul : 0.f;
      }
      mbar_arrive(&s.full[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- consumer warpgroup: 64 kv rows ----
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // accumulator fragments: warp w holds rows 16w + g and 16w + g + 8 of
    // the 64 kv rows, columns 8i + 2t and 8i + 2t + 1 of each n8 block i (q
    // columns of the tile for S^T and dP^T, D for dV and dK)
    const int g = lane >> 2, t = lane & 3;

    // descriptors (32-byte swizzle: 8-row groups of 32-byte rows, 256 bytes
    // apart), all K-major: the resident hi / lo as the A of S^T or dP^T, box
    // kb one k8 step further; the streamed Q~ or dO as their B; the
    // transposed boxes as the B of dV or dK, box qb one k8 step further
    constexpr uint32_t X_STEP = C::BOX_KV * 4 / 16;  // descriptor units (16 bytes)
    constexpr uint32_t A_STEP = C::BOX_Q * 4 / 16;
    constexpr uint32_t T_STEP = C::BOX_T * 4 / 16;
    uint64_t xd[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) xd[x] = smem_desc(s.x[x][0], 16, 256, DESC_SWIZZLE_32B);
    // the P^T slots in rank 1's shared memory (rank 0 writes them), and the
    // barriers of the peer's that this CTA arrives on, slot 1 eight bytes
    // after slot 0: rank 1's p_full (from rank 0), rank 0's p_empty (from
    // rank 1)
    const uint32_t peer_p = cluster_map(s.p, peer);
    const uint32_t peer_bar = cluster_map(rank == 0 ? s.p_full : s.p_empty, peer);
    uint64_t* own_bar = rank == 0 ? s.p_empty : s.p_full;

    float sum[DP / 2];  // dV (rank 0) or dK (rank 1)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) sum[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;

    mbar_wait(&s.kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&s.full[stage], phase);
      uint64_t ad[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) ad[x] = smem_desc(s.a[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
      // S^T = K Q~^T (rank 0) or dP^T = V dO^T (rank 1): hi.hi, hi.lo,
      // lo.hi per k8 step into a fresh accumulator (scale-d 0 first)
      float sc[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        wgmma_ss_tf32(sc, xd[0] + kb * X_STEP, ad[0] + kb * A_STEP, kb);
        wgmma_ss_tf32(sc, xd[0] + kb * X_STEP, ad[1] + kb * A_STEP, 1);
        wgmma_ss_tf32(sc, xd[1] + kb * X_STEP, ad[0] + kb * A_STEP, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const float* vec = s.vec[stage];
      const int slot = j & 1;
      const uint32_t p_parity = (j >> 1) & 1;
      if (rank == 0) {
        // P^T = exp2(S^T log2(e) - L log2(e)), L per q column
#pragma unroll
        for (int i = 0; i < QB; ++i) {
          const float2 l = *reinterpret_cast<const float2*>(vec + 8 * i + 2 * t);
          sc[4 * i] = ex2(fmaf(sc[4 * i], LOG2E, -l.x));
          sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], LOG2E, -l.y));
          sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], LOG2E, -l.x));
          sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], LOG2E, -l.y));
        }
        // hand P^T to rank 1, thread for thread, once rank 1 has read the
        // slot's previous tile
        mbar_wait_cluster(&own_bar[slot], p_parity ^ 1);
#pragma unroll
        for (int i = 0; i < QB; ++i)
          st_cluster_v4(peer_p + ((slot * QB + i) * 128 + tid) * 16,
                        make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]));
        mbar_arrive_cluster(peer_bar + 8 * slot);
      } else {
        // the tile's P^T from rank 0, then dS^T = P^T o (dP^T - delta)
        mbar_wait_cluster(&own_bar[slot], p_parity);
        float4 pt[QB];
#pragma unroll
        for (int i = 0; i < QB; ++i)
          pt[i] = reinterpret_cast<const float4*>(s.p[slot][i])[tid];
        mbar_arrive_cluster(peer_bar + 8 * slot);  // the slot is free again
#pragma unroll
        for (int i = 0; i < QB; ++i) {
          const float2 d = *reinterpret_cast<const float2*>(vec + 8 * i + 2 * t);
          sc[4 * i] = pt[i].x * (sc[4 * i] - d.x);
          sc[4 * i + 1] = pt[i].y * (sc[4 * i + 1] - d.y);
          sc[4 * i + 2] = pt[i].z * (sc[4 * i + 2] - d.x);
          sc[4 * i + 3] = pt[i].w * (sc[4 * i + 3] - d.y);
        }
      }

      // P^T or dS^T as tf32 register-A fragments, hi and lo: the k8 step i
      // takes accumulator registers (d0, d2, d1, d3) of n8 block i (pi)
      uint32_t ah[BQ / 2], al[BQ / 2];
#pragma unroll
      for (int i = 0; i < QB; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int src = 4 * i + ((r & 1) << 1) + (r >> 1);  // 0, 2, 1, 3
          split_tf32(sc[src], ah[4 * i + r], al[4 * i + r]);
        }
      }
      fence_u32(ah);  // every A register is written before the wgmmas start
      fence_u32(al);

      // dV += P^T dO (rank 0) or dK += dS^T Q~ (rank 1), B the transposed
      // boxes, into a fresh per-tile accumulator added with FADDs
      uint64_t td[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) td[x] = smem_desc(s.at[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
      float acc[DP / 2];
      wgmma_fence();
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) {
        wgmma_rs_tf32(acc, ah + 4 * qb, td[0] + qb * T_STEP, qb);
        wgmma_rs_tf32(acc, ah + 4 * qb, td[1] + qb * T_STEP, 1);
        wgmma_rs_tf32(acc, al + 4 * qb, td[0] + qb * T_STEP, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) sum[i] += acc[i];
      fence_u32(ah);
      fence_u32(al);
      if (lane == 0) mbar_arrive(&s.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: dV or dK in f32 into the resident hi rows (32-byte swizzle:
    // 16-byte chunk c of row r at c ^ ((r >> 2) & 1)), then a TMA store per
    // box, clipped at S
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the resident reads are done
    const int r0 = warp * 16 + g;
    const int swz = (r0 >> 2) & 1;  // the same for r0 + 8
    const int off = r0 * 32 + (((t >> 1) ^ swz) << 4) + ((t & 1) << 3);
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      uint8_t* o = reinterpret_cast<uint8_t*>(s.x[0][i]) + off;
      *reinterpret_cast<float2*>(o) = make_float2(sum[4 * i], sum[4 * i + 1]);
      *reinterpret_cast<float2*>(o + 8 * 32) = make_float2(sum[4 * i + 2], sum[4 * i + 3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (tid == 0) {
      for (int kb = 0; kb < KB; ++kb) tma_store_4d(&m.out[rank], s.x[0][kb], kb * BOX, kv0, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the stores have read shared memory before the CTA exits
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
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
    e = cudaFuncSetAttribute(flash_bwd_dkv_tf32x3_wide_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes<DP>);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ptrs: hi, lo of Q~, dO, K, V, Q~^T, dO^T (12), then dK, dV; st: their
// (batch, head, row) element strides, 3 each
template <int DP>
cudaError_t launch(EncodeTiled fn, const void* const* ptrs, const float* lse, const float* delta,
                   const long long* st, int B, int H, int T, int S, int D, cudaStream_t stream) {
  const cudaError_t e = prepare<DP>();
  if (e != cudaSuccess) return e;
  static_assert(kSmemBytes<DP> <= SMEM_MAX && BQ <= T_ALIGN, "shared memory");
  const int Tp = (T + T_ALIGN - 1) / T_ALIGN * T_ALIGN;  // the transposed copies' q columns
  Maps m;
  bool ok = true;
  for (int x = 0; x < 2; ++x) {
    // rank 0: K resident, Q~ and dO^T streamed; rank 1: V, dO and Q~^T
    ok = ok && encode_bhtd(fn, &m.a[0][x], ptrs[x], st + 3 * x, B, H, T, D, BQ, F32) &&
         encode_bhtd(fn, &m.a[1][x], ptrs[2 + x], st + 3 * (2 + x), B, H, T, D, BQ, F32) &&
         encode_bhtd(fn, &m.x[0][x], ptrs[4 + x], st + 3 * (4 + x), B, H, S, D, BN, F32) &&
         encode_bhtd(fn, &m.x[1][x], ptrs[6 + x], st + 3 * (6 + x), B, H, S, D, BN, F32) &&
         encode_bhtd(fn, &m.at[1][x], ptrs[8 + x], st + 3 * (8 + x), B, H, D, Tp, DP, F32) &&
         encode_bhtd(fn, &m.at[0][x], ptrs[10 + x], st + 3 * (10 + x), B, H, D, Tp, DP, F32);
  }
  ok = ok && encode_bhtd(fn, &m.out[1], ptrs[12], st + 36, B, H, S, D, BN, F32) &&
       encode_bhtd(fn, &m.out[0], ptrs[13], st + 39, B, H, S, D, BN, F32);
  if (!ok) return cudaErrorInvalidValue;
  // two CTAs (one cluster) per BN kv rows of each head
  const dim3 grid(2 * ((S + BN - 1) / BN), B * H);
  flash_bwd_dkv_tf32x3_wide_kernel<DP><<<grid, THREADS, kSmemBytes<DP>, stream>>>(m, lse, delta,
                                                                                  H, T);
  return cudaGetLastError();
}

}  // namespace

// Arguments as flash_bwd_dkv_tf32x3's: q~ (f32(q) * scale), dout, k, v, each
// as hi and lo (tf32 bit patterns: the wrapper's _split_tf32), and the
// pi-permuted transposed copies of q~ and dout, hi and lo, (B, H, D, T')
// with T' = T rounded up to T_ALIGN, zeros past T; dk and dv f32 outputs.
// Every tensor has a unit last stride. strides: 42 element strides,
// (batch, head, row) for each of the fourteen tensors in that order, each
// positive and a multiple of 4 (TMA's 16-byte global strides); 16-byte
// aligned bases. lse and delta: (B, H, T) f32 contiguous. bn: kv rows per
// cluster pair, BN (64) only. scale is not read (Q~ carries it). Returns a
// cudaError_t: cudaErrorInvalidValue for what the kernel does not take (the
// wrapper routes those calls elsewhere first) or a map that cannot be
// encoded.
extern "C" int flash_bwd_dkv_tf32x3_wide(const void* qh, const void* ql, const void* oh,
                                         const void* ol, const void* kh, const void* kl,
                                         const void* vh, const void* vl, const void* qth,
                                         const void* qtl, const void* oth, const void* otl,
                                         const void* lse, const void* delta, void* dk, void* dv,
                                         const long long* strides, int B, int H, int T, int S,
                                         int D, int bn, float scale, void* stream) {
  (void)scale;
  if (B < 1 || H < 1 || T < 1 || S < 1 || D < MIN_DP || D > MAX_DP || D % 8 != 0 ||
      (long long)B * H > 65535 || bn != BN) {
    return (int)cudaErrorInvalidValue;
  }
  const void* const ptrs[14] = {qh, ql, oh, ol, kh, kl, vh, vl, qth, qtl, oth, otl, dk, dv};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 42; ++i) {
    if (strides[i] <= 0 || strides[i] % 4 != 0) return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define DKV_WIDE_CASE(DP_) \
  case DP_:                \
    return (int)launch<DP_>(fn, ptrs, L, Dl, strides, B, H, T, S, D, st);
    DKV_WIDE_CASE(104)
    DKV_WIDE_CASE(112)
    DKV_WIDE_CASE(120)
    DKV_WIDE_CASE(128)
    DKV_WIDE_CASE(136)
    DKV_WIDE_CASE(144)
    DKV_WIDE_CASE(152)
    DKV_WIDE_CASE(160)
#undef DKV_WIDE_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The instance that takes head dim D: out = {DP, BQ, STAGES, dynamic shared
// memory bytes, BN}. Returns 0, or cudaErrorInvalidValue for a D no
// instance takes.
extern "C" int flash_bwd_dkv_tf32x3_wide_config(int D, int* out) {
  switch (D) {
#define DKV_WIDE_CONFIG(DP_)        \
  case DP_:                         \
    out[0] = DP_;                   \
    out[1] = BQ;                    \
    out[2] = Cfg<DP_>::STAGES;      \
    out[3] = (int)kSmemBytes<DP_>;  \
    out[4] = BN;                    \
    return 0;
    DKV_WIDE_CONFIG(104)
    DKV_WIDE_CONFIG(112)
    DKV_WIDE_CONFIG(120)
    DKV_WIDE_CONFIG(128)
    DKV_WIDE_CONFIG(136)
    DKV_WIDE_CONFIG(144)
    DKV_WIDE_CONFIG(152)
    DKV_WIDE_CONFIG(160)
#undef DKV_WIDE_CONFIG
  }
  return (int)cudaErrorInvalidValue;
}
