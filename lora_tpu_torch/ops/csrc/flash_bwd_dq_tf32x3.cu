// Flash-attention dQ backward for Hopper (sm_90a), f32, non-causal:
//     dQ = scale * sum_j dS_j K_j
// with Q~ = f32(q) * scale formed by the wrapper, P = exp(Q~ K^T - L) in f32
// from the forward's f32 logsumexp L, dS = P o (dO V^T - delta) in f32,
// delta = rowsum(dO o O) in f32 (the wrapper's). Every product runs on the
// tensor cores as 3xTF32: each f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), and A B becomes A_hi B_hi + A_hi B_lo + A_lo B_hi, three
// tf32 wgmmas into one f32 accumulator. Each product then errs by about
// 2^-21 of the sum of its terms' magnitudes, as an f32 FMA chain does;
// nothing is rounded to a lower dtype anywhere. dQ comes back in f32 in the
// layout of the tensor it is written to.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (:178-207, driven by _bwd :258-300, scaled at :334) for f32
// inputs, which runs its dots at Precision.HIGHEST (true f32 contractions;
// plain TF32, with 10 mantissa bits, would not compute that), and computes
// what it and ops/flash_attention.py::flash_bwd_dq_reference compute.
// flash_bwd.cu's flash_bwd_dq (mma.sync, CUDA-core FMAs for f32) serves what
// this kernel does not take: D > MAX_DP and strides of 0
// (ops/flash_attention.py _dq_route picks the kernel from dtype, D and
// layout alone).
//
// What bounds it on an H100 at the SD-1.5 training shape (B = 1, H = 8,
// T = S = 4096, D = 40): three products per score (S, dP, dQ), each three
// tf32 products: 3 * 6*B*H*T*S*D = 96.6 GFLOP, 0.195 ms at 494.7 TFLOP/s
// dense TF32. B*H*T*S = 134 M exponentials, 0.032 ms. The bytes (q, k, v,
// dO, L and delta read once, dQ written once: ~26 MB) are 0.008 ms. The
// tensor cores set the floor.
//
// Design (flash_bwd_dq_wgmma.cu's pipeline; what tf32 changes is marked):
//   * One CTA per (BM q rows, head), looping over every kv tile; nothing
//     carries between CTAs and nothing is atomic, so the sums run in one
//     fixed order (deterministic, like the TPU kernel). BM = 64 per consumer
//     warpgroup, 1 or 2 of them, chosen per launch on the host
//     (ops/flash_attention.py _dq_tf32x3_bm: 128 where it fits BM_MAX and
//     leaves no SM idle).
//   * Producer warpgroup (setmaxnreg gives its registers away): one thread
//     issues every TMA load, Q~ and dO (hi and lo) once per CTA, then the
//     stage's K, V (hi and lo, kv rows by D) and K^T (hi and lo, D rows by
//     kv) through a ring of up to 4 stages with a `full` and an `empty`
//     mbarrier each. 4-D f32 tensor maps (cols, rows, H, B) from each
//     tensor's strides, so the UNet's transposed views are read, and dQ
//     written, in place. Every tile is 8-column boxes (32-byte rows, the
//     32-byte swizzle): one box per k8 step of a tf32 wgmma, D = 40 exactly
//     5 boxes.
//   * L and delta are per q row: each consumer thread loads those of its two
//     rows once per CTA into registers, L pre-multiplied by log2(e), both 0
//     past T.
//   * tf32: .tf32 wgmma is m64nNk8 and has no transpose bits, so both
//     shared-memory operands are K-major. S = Q~ K^T and dP = dO V^T read K
//     and V as they are (D innermost). dQ += dS K needs kv innermost: the
//     wrapper forms K^T, (B, H, D, S') with S' = S rounded up to S_ALIGN =
//     64, the largest BN (zeros past S, so no box lies wholly outside the
//     tensor), and permutes kv within each group of 8 by
//     pi = [0, 2, 4, 6, 1, 3, 5, 7] (k position p holds kv row pi(p)).
//   * Consumer warpgroups own 64 q rows each. Per kv tile: S and dP (3 x
//     DP/8 wgmma m64nBNk8 each, both operands from shared memory) as two
//     commit groups; P = exp2(S * log2(e) - L * log2(e)) on the fragments of
//     the first (one FFMA and one ex2.approx a score) while the second runs;
//     dS = P o (dP - delta) in f32. The accumulator gives each thread columns
//     (2t, 2t + 1) of every 8-column group; the tf32 register-A fragment
//     wants k = t and t + 4. With pi, k position t is kv column 2t and t + 4
//     is 2t + 1, so the A registers of group i are the accumulator registers
//     (d0, d2, d1, d3) of that group, with no data movement; each is split
//     into hi and lo in registers (cvt.rna.tf32.f32, a subtraction, a second
//     cvt), all of them before the run of wgmmas that reads them (a register
//     A written inside a run serialises it: ptxas C7513). Then dQ += dS K^T'
//     (3 x BN/8 wgmma m64nDPk8, A from registers, B the transposed boxes)
//     into a per-tile accumulator that is added into dQ with round-to-nearest
//     FADDs: the tensor cores' f32 accumulation is not round-to-nearest, and
//     left to sum all of S its errors add up in one direction and grow with
//     S; per tile they stay at the f32 level (flash_bwd_dkv_tf32x3.cu found
//     this for dV and dK). The stage is released once that product is
//     waited for.
//   * Ragged tails. Q~ and dO rows past T are TMA's zero fill with L and
//     delta 0: S = 0, P = 1, dP = 0, so dS = 0; the store clips those rows.
//     K and V rows past S are zero too, but there P = exp(-L), which is not
//     0 and overflows f32 for L below about -88, and an inf dS times a zero
//     K^T column is NaN. So the last tile's columns >= S are masked to -inf
//     before the exponential (P = 0, dS = 0), as flash_bwd_dq_wgmma.cu does.
//   * Shared memory: Q~ and dO hi and lo take 16 * BM_MAX * DP bytes, a
//     stage 24 * BN * DP: BM_MAX = 128 up to DP = 64 with BN = 64 up to
//     DP = 40 (2 stages at 40), 32 above; BM_MAX = 64 above DP = 64 with
//     BN = 32 up to 88, 16 at 96. Wider heads do not fit two stages and stay
//     on the mma.sync kernel.
//   * Registers: per consumer thread, BN / 2 S and BN / 2 dP accumulators
//     declared inside the kv loop (scale-d 0: dead across tiles), BN / 2 hi
//     and BN / 2 lo registers of dS, DP / 2 of the tile's dQ and DP / 2 of
//     the running dQ: ~168 at DP = 40, BN = 64 and ~128 at DP = 96, BN = 16,
//     under the 232 the consumers hold after setmaxnreg.
//   * Epilogue: dQ times `scale` in f32, into the warpgroup's own Q~ hi rows
//     in shared memory (no longer read), then one TMA store per box, clipped
//     at T.
//
// Left for later: the split inside the kernel after TMA lands (the wrapper
// forms the ten operand tensors today, shared with the dK/dV kernel), the
// next kv tile's S and dP under this tile's dS K product, ping-pong of the
// two consumer warpgroups.
//
// Entry point: flash_bwd_dq_tf32x3(...) below, a plain C function for
// ctypes. It encodes the eleven TMA tensor maps on the host
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: sm90.cuh),
// launches on the given stream and returns cudaGetLastError() after the
// launch; it does not synchronise and allocates nothing.

#include <math.h>

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BOX = 8;       // f32 columns per TMA box: one k8 step, 32-byte rows
constexpr int MAX_DP = 96;   // the widest D instantiated (a multiple of 8)
constexpr int S_ALIGN = 64;  // the transposed copy's kv columns: S rounded up to this
constexpr float LOG2E = 1.4426950408889634f;
constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

template <int DP>
struct Cfg {
  static constexpr int KB = DP / BOX;                          // boxes per row
  static constexpr int BM_MAX = DP <= 64 ? 128 : 64;           // q rows a CTA can hold
  static constexpr int BN = DP <= 40 ? 64 : DP <= 88 ? 32 : 16;  // kv rows per stage
  static constexpr int BOX_Q = BM_MAX * BOX;  // elements of one Q~ or dO box
  static constexpr int BOX_KV = BN * BOX;     // of one K or V box (kv rows)
  static constexpr int BOX_T = DP * BOX;      // of one K^T box (D rows)
  // what TMA brings per stage: hi and lo of K, V, K^T
  static constexpr int STAGE_BYTES = 6 * BN * DP * 4;
  static constexpr int Q_BYTES = 4 * KB * BOX_Q * 4;
  // ring depth: what shared memory holds beside Q~ and dO (and 1024 bytes of
  // alignment slack, 256 of barriers), at most 4
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(DP % BOX == 0 && DP <= MAX_DP && STAGES >= 2 && S_ALIGN % BN == 0, "tile");
};

// Shared memory of one CTA from a 1024-byte aligned base. Every box is a
// multiple of 256 bytes, the 32-byte swizzle's period, so each box and each
// warpgroup's 64 rows inside it start on that period.
template <int DP>
struct Smem {
  using C = Cfg<DP>;
  float q[2][C::KB][C::BOX_Q];  // Q~ hi, lo (BM_MAX rows); dQ in q[0] for the store
  float o[2][C::KB][C::BOX_Q];  // dO hi, lo
  float k[C::STAGES][2][C::KB][C::BOX_KV];        // K hi, lo
  float v[C::STAGES][2][C::KB][C::BOX_KV];        // V hi, lo
  float kt[C::STAGES][2][C::BN / BOX][C::BOX_T];  // K^T hi, lo (pi-permuted kv)
  uint64_t full[C::STAGES];
  uint64_t empty[C::STAGES];
  uint64_t q_full;
};

template <int DP>
constexpr size_t kSmemBytes = sizeof(Smem<DP>) + 1024;  // + alignment slack

// The eleven tensor maps: hi and lo of Q~, dO, K, V, K^T, then dQ
struct Maps {
  CUtensorMap q[2], o[2], k[2], v[2], kt[2], dq;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Launched with (nc + 1) * 128 threads: nc = 1 or 2 consumer warpgroups
// (BM = 64 * nc q rows), then the producer warpgroup.
template <int DP>
__global__ void __launch_bounds__(3 * 128, 1)
    flash_bwd_dq_tf32x3_kernel(const __grid_constant__ Maps m, const float* __restrict__ lse,
                               const float* __restrict__ delta, int H, int T, int S,
                               float scale) {
  using C = Cfg<DP>;
  constexpr int KB = C::KB;
  constexpr int BN = C::BN;
  constexpr int NB = BN / BOX;  // k8 steps of dQ per tile
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Smem<DP>& s = *reinterpret_cast<Smem<DP>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int nc = blockDim.x / 128 - 1;
  const int q0 = blockIdx.x * 64 * nc;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int n_tiles = (S + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);        // the producer's expect_tx arrival
      mbar_init(&s.empty[i], nc * 4);  // one arrival per consumer warp
    }
    mbar_init(&s.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == nc) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == nc * 128) {
      // the full boxes are counted even where TMA zero-fills past the edge
      mbar_expect_tx(&s.q_full, 4 * KB * 64 * nc * BOX * 4);
      for (int x = 0; x < 2; ++x) {
        for (int kb = 0; kb < KB; ++kb) {
          tma_load_4d(s.q[x][kb], &m.q[x], &s.q_full, kb * BOX, q0, h, b);
          tma_load_4d(s.o[x][kb], &m.o[x], &s.q_full, kb * BOX, q0, h, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        uint64_t* bar = &s.full[stage];
        mbar_expect_tx(bar, C::STAGE_BYTES);
        for (int x = 0; x < 2; ++x) {
          for (int kb = 0; kb < KB; ++kb) {
            tma_load_4d(s.k[stage][x][kb], &m.k[x], bar, kb * BOX, j * BN, h, b);
            tma_load_4d(s.v[stage][x][kb], &m.v[x], bar, kb * BOX, j * BN, h, b);
          }
          for (int nb = 0; nb < NB; ++nb)
            tma_load_4d(s.kt[stage][x][nb], &m.kt[x], bar, j * BN + nb * BOX, 0, h, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // accumulator fragments: warp w holds rows 16w + g and 16w + g + 8 of
    // the warpgroup's 64 q rows, columns 8i + 2t and 8i + 2t + 1 of each n8
    // block i (kv columns of the tile for S and dP, D for dQ)
    const int g = lane >> 2, t = lane & 3;
    const uint32_t bar_id = 1 + wg;  // this warpgroup's named barrier
    const int r0 = warp * 16 + g;

    // L * log2(e) and delta of this thread's rows r0 and r0 + 8, 0 past T
    const int row = q0 + wg * 64 + r0;
    const float* L = lse + (long long)blockIdx.y * T;
    const float* Dl = delta + (long long)blockIdx.y * T;
    const float l0 = row < T ? L[row] * LOG2E : 0.f;
    const float l1 = row + 8 < T ? L[row + 8] * LOG2E : 0.f;
    const float d0 = row < T ? Dl[row] : 0.f;
    const float d1 = row + 8 < T ? Dl[row + 8] : 0.f;

    // descriptors (32-byte swizzle: 8-row groups of 32-byte rows, 256 bytes
    // apart), all K-major: Q~ and dO hi / lo as the A of S and dP, box kb one
    // k8 step further; K and V as their B; K^T as the B of dQ, box nb one k8
    // step (8 kv rows) further
    constexpr uint32_t Q_STEP = C::BOX_Q * 4 / 16;  // descriptor units (16 bytes)
    constexpr uint32_t KV_STEP = C::BOX_KV * 4 / 16;
    constexpr uint32_t T_STEP = C::BOX_T * 4 / 16;
    uint64_t qa[2], oa[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      qa[x] = smem_desc(s.q[x][0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
      oa[x] = smem_desc(s.o[x][0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
    }
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;

    mbar_wait(&s.q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&s.full[stage], phase);
      uint64_t kd[2], vd[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        kd[x] = smem_desc(s.k[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
        vd[x] = smem_desc(s.v[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
      }
      // S = Q~ K^T and dP = dO V^T, two commit groups of hi.hi, hi.lo,
      // lo.hi per k8 step. The accumulators are fresh each tile: the first
      // wgmma's scale-d 0 ignores them.
      float sc[BN / 2], dp[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        wgmma_ss_tf32(sc, qa[0] + kb * Q_STEP, kd[0] + kb * KV_STEP, kb);
        wgmma_ss_tf32(sc, qa[0] + kb * Q_STEP, kd[1] + kb * KV_STEP, 1);
        wgmma_ss_tf32(sc, qa[1] + kb * Q_STEP, kd[0] + kb * KV_STEP, 1);
      }
      wgmma_commit();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        wgmma_ss_tf32(dp, oa[0] + kb * Q_STEP, vd[0] + kb * KV_STEP, kb);
        wgmma_ss_tf32(dp, oa[0] + kb * Q_STEP, vd[1] + kb * KV_STEP, 1);
        wgmma_ss_tf32(dp, oa[1] + kb * Q_STEP, vd[0] + kb * KV_STEP, 1);
      }
      wgmma_commit();

      // P = exp2(S log2(e) - L log2(e)), L per q row, while dP runs; the
      // last tile's columns >= S first to -inf (P = 0 there)
      wgmma_wait<1>();
      fence_regs(sc);
      const int valid = S - j * BN;
      if (valid < BN) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = 8 * i + 2 * t;
          if (col >= valid) sc[4 * i] = sc[4 * i + 2] = -INFINITY;
          if (col + 1 >= valid) sc[4 * i + 1] = sc[4 * i + 3] = -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        sc[4 * i] = ex2(fmaf(sc[4 * i], LOG2E, -l0));
        sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], LOG2E, -l0));
        sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], LOG2E, -l1));
        sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], LOG2E, -l1));
      }
      // dS = P o (dP - delta)
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        dp[4 * i] = sc[4 * i] * (dp[4 * i] - d0);
        dp[4 * i + 1] = sc[4 * i + 1] * (dp[4 * i + 1] - d0);
        dp[4 * i + 2] = sc[4 * i + 2] * (dp[4 * i + 2] - d1);
        dp[4 * i + 3] = sc[4 * i + 3] * (dp[4 * i + 3] - d1);
      }
      // dS as tf32 register-A fragments, hi and lo: the k8 step i takes
      // accumulator registers (d0, d2, d1, d3) of n8 block i (pi)
      uint32_t dh[BN / 2], dl[BN / 2];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int src = 4 * i + ((r & 1) << 1) + (r >> 1);  // 0, 2, 1, 3
          split_tf32(dp[src], dh[4 * i + r], dl[4 * i + r]);
        }
      }
      fence_u32(dh);  // every A register is written before the wgmmas start
      fence_u32(dl);

      // dQ += dS K (B: the transposed boxes) into a fresh accumulator that
      // is added into dQ with round-to-nearest FADDs: the tensor cores' own
      // f32 accumulation is not round-to-nearest, and over 3 * S / 8 steps
      // its errors add up in one direction (against 3 * BN / 8 steps per
      // tile here)
      uint64_t ktd[2];
#pragma unroll
      for (int x = 0; x < 2; ++x)
        ktd[x] = smem_desc(s.kt[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
      float acc[DP / 2];
      wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        wgmma_rs_tf32(acc, dh + 4 * nb, ktd[0] + nb * T_STEP, nb);
        wgmma_rs_tf32(acc, dh + 4 * nb, ktd[1] + nb * T_STEP, 1);
        wgmma_rs_tf32(acc, dl + 4 * nb, ktd[0] + nb * T_STEP, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dq[i] += acc[i];
      fence_u32(dh);
      fence_u32(dl);
      if (lane == 0) mbar_arrive(&s.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: dQ * scale in f32 into this warpgroup's Q~ hi rows (32-byte
    // swizzle: 16-byte chunk c of row r at c ^ ((r >> 2) & 1)), then a TMA
    // store per box, clipped at T
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");  // Q~ reads are done
    const int swz = (r0 >> 2) & 1;  // the same for r0 + 8
    const int off = (wg * 64 + r0) * 32 + (((t >> 1) ^ swz) << 4) + ((t & 1) << 3);
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      uint8_t* qx = reinterpret_cast<uint8_t*>(s.q[0][i]) + off;
      *reinterpret_cast<float2*>(qx) = make_float2(dq[4 * i] * scale, dq[4 * i + 1] * scale);
      *reinterpret_cast<float2*>(qx + 8 * 32) =
          make_float2(dq[4 * i + 2] * scale, dq[4 * i + 3] * scale);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (tid == 0) {
      for (int kb = 0; kb < KB; ++kb)
        tma_store_4d(&m.dq, s.q[0][kb] + wg * 64 * BOX, kb * BOX, q0 + wg * 64, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the stores have read shared memory before the CTA exits
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
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
    e = cudaFuncSetAttribute(flash_bwd_dq_tf32x3_kernel<DP>,
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
                   const long long* st, int B, int H, int T, int S, int D, int bm, float scale,
                   cudaStream_t stream) {
  if (bm > Cfg<DP>::BM_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = prepare<DP>();
  if (e != cudaSuccess) return e;
  constexpr int BN = Cfg<DP>::BN;
  static_assert(kSmemBytes<DP> <= SMEM_MAX, "shared memory");
  const int Sp = (S + S_ALIGN - 1) / S_ALIGN * S_ALIGN;  // the transposed copy's kv columns
  Maps m;
  bool ok = true;
  for (int x = 0; x < 2; ++x) {
    ok = ok && encode_bhtd(fn, &m.q[x], ptrs[x], st + 3 * x, B, H, T, D, bm, F32) &&
         encode_bhtd(fn, &m.o[x], ptrs[2 + x], st + 3 * (2 + x), B, H, T, D, bm, F32) &&
         encode_bhtd(fn, &m.k[x], ptrs[4 + x], st + 3 * (4 + x), B, H, S, D, BN, F32) &&
         encode_bhtd(fn, &m.v[x], ptrs[6 + x], st + 3 * (6 + x), B, H, S, D, BN, F32) &&
         encode_bhtd(fn, &m.kt[x], ptrs[8 + x], st + 3 * (8 + x), B, H, D, Sp, DP, F32);
  }
  ok = ok && encode_bhtd(fn, &m.dq, ptrs[10], st + 30, B, H, T, D, 64, F32);
  if (!ok) return cudaErrorInvalidValue;
  const dim3 grid((T + bm - 1) / bm, B * H);
  flash_bwd_dq_tf32x3_kernel<DP><<<grid, (bm / 64 + 1) * 128, kSmemBytes<DP>, stream>>>(
      m, lse, delta, H, T, S, scale);
  return cudaGetLastError();
}

}  // namespace

// q~ (f32(q) * scale), dout, k, v, each as hi and lo (tf32 bit patterns:
// the wrapper's _split_tf32), and the pi-permuted transposed copy of k, hi
// and lo, (B, H, D, S') with S' = S rounded up to S_ALIGN, zeros past S; dq
// the f32 output. Every tensor has a unit last stride. strides: 33 element
// strides, (batch, head, row) for each of the eleven tensors in that order,
// each positive and a multiple of 4 (TMA's 16-byte global strides); 16-byte
// aligned bases. lse and delta: (B, H, T) f32 contiguous. bm: q rows per
// CTA, 64 or 128 (128 only where D <= 64). scale multiplies dQ in the
// epilogue (Q~ carries it into the scores). Returns a cudaError_t:
// cudaErrorInvalidValue for what the kernel does not take (the wrapper
// routes those calls to flash_bwd.cu first) or a map that cannot be encoded.
extern "C" int flash_bwd_dq_tf32x3(const void* qh, const void* ql, const void* oh, const void* ol,
                                   const void* kh, const void* kl, const void* vh, const void* vl,
                                   const void* kth, const void* ktl, const void* lse,
                                   const void* delta, void* dq, const long long* strides, int B,
                                   int H, int T, int S, int D, int bm, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1 || S < 1 || D < 8 || D > MAX_DP || D % 8 != 0 ||
      (long long)B * H > 65535 || (bm != 64 && bm != 128)) {
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
#define DQ_TF32X3_CASE(DP_) \
  case DP_:                 \
    return (int)launch<DP_>(fn, ptrs, L, Dl, strides, B, H, T, S, D, bm, scale, st);
    DQ_TF32X3_CASE(8)
    DQ_TF32X3_CASE(16)
    DQ_TF32X3_CASE(24)
    DQ_TF32X3_CASE(32)
    DQ_TF32X3_CASE(40)
    DQ_TF32X3_CASE(48)
    DQ_TF32X3_CASE(56)
    DQ_TF32X3_CASE(64)
    DQ_TF32X3_CASE(72)
    DQ_TF32X3_CASE(80)
    DQ_TF32X3_CASE(88)
    DQ_TF32X3_CASE(96)
#undef DQ_TF32X3_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The instance that takes head dim D: out = {DP, BN, STAGES, dynamic shared
// memory bytes, BM_MAX}. Returns 0, or cudaErrorInvalidValue for a D no
// instance takes.
extern "C" int flash_bwd_dq_tf32x3_config(int D, int* out) {
  switch (D) {
#define DQ_TF32X3_CONFIG(DP_)      \
  case DP_:                        \
    out[0] = DP_;                  \
    out[1] = Cfg<DP_>::BN;         \
    out[2] = Cfg<DP_>::STAGES;     \
    out[3] = (int)kSmemBytes<DP_>; \
    out[4] = Cfg<DP_>::BM_MAX;     \
    return 0;
    DQ_TF32X3_CONFIG(8)
    DQ_TF32X3_CONFIG(16)
    DQ_TF32X3_CONFIG(24)
    DQ_TF32X3_CONFIG(32)
    DQ_TF32X3_CONFIG(40)
    DQ_TF32X3_CONFIG(48)
    DQ_TF32X3_CONFIG(56)
    DQ_TF32X3_CONFIG(64)
    DQ_TF32X3_CONFIG(72)
    DQ_TF32X3_CONFIG(80)
    DQ_TF32X3_CONFIG(88)
    DQ_TF32X3_CONFIG(96)
#undef DQ_TF32X3_CONFIG
  }
  return (int)cudaErrorInvalidValue;
}
