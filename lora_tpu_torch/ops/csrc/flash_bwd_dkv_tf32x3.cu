// Flash-attention dK/dV backward for Hopper (sm_90a), f32, non-causal:
//     dV = sum_i P_i^T dO_i,     dK = sum_i dS_i^T Q~_i
// with Q~ = f32(q) * scale formed by the wrapper, P = exp(Q~ K^T - L) in f32
// from the forward's f32 logsumexp L, dS = P o (dO V^T - delta) in f32,
// delta = rowsum(dO o O) in f32 (the wrapper's). Every product runs on the
// tensor cores as 3xTF32: each f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), and A B becomes A_hi B_hi + A_hi B_lo + A_lo B_hi, three
// tf32 wgmmas into one f32 accumulator. Each product then errs by about
// 2^-21 of the sum of its terms' magnitudes, as an f32 FMA chain does;
// nothing is rounded to a lower dtype anywhere. dK and dV come back in f32
// in k's and v's layouts.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel (:210-255, driven by _bwd :258-332) for f32 inputs, which
// runs its dots at Precision.HIGHEST (true f32 contractions; plain TF32,
// with 10 mantissa bits, would not compute that), and computes what it and
// ops/flash_attention.py::flash_bwd_dkv_reference compute. flash_bwd.cu's
// flash_bwd_dkv (mma.sync, CUDA-core FMAs for f32) serves what this kernel
// does not take: D > MAX_DP and strides of 0 (ops/flash_attention.py
// _bwd_route picks the kernel from dtype, D and layout alone).
//
// What bounds it on an H100 at the SD-1.5 training shape (B = 1, H = 8,
// T = S = 4096, D = 40): four products per score (S^T, dP^T, dV, dK), each
// three tf32 products: 3 * 8*B*H*T*S*D = 129 GFLOP, 0.26 ms at 494.7
// TFLOP/s dense TF32. B*H*T*S = 134 M exponentials, 0.032 ms. The bytes
// (q, k, v, dO, L and delta read once, dK and dV written once: ~32 MB) are
// 0.01 ms. The tensor cores set the floor.
//
// Design (flash_bwd_dkv_wgmma.cu's pipeline; what tf32 changes is marked):
//   * One CTA per (BN kv rows, head), looping over every q tile; nothing
//     carries between CTAs and nothing is atomic. BN = 64 per consumer
//     warpgroup, 1 or 2 of them, chosen per launch on the host
//     (ops/flash_attention.py _dkv_tf32x3_bn: 128 where it fits BN_MAX and
//     leaves no SM idle).
//   * Producer warpgroup (setmaxnreg gives its registers away): one thread
//     issues every TMA load, K and V (hi and lo) once per CTA, then the
//     stage's Q~, dO (hi and lo, q rows by D) and Q~^T, dO^T (hi and lo,
//     D rows by q) through a ring of up to 4 stages with a `full` and an
//     `empty` mbarrier each; one warp stages L * log2(e) and delta of the
//     stage's q rows (0 past T) with plain loads and arrives on the same
//     `full` barrier. 4-D f32 tensor maps (cols, rows, H, B) from each
//     tensor's strides. Every tile is 8-column boxes (32-byte rows, the
//     32-byte swizzle): one box per k8 step of a tf32 wgmma, D = 40 exactly
//     5 boxes.
//   * tf32: .tf32 wgmma is m64nNk8 and has no transpose bits, so both
//     shared-memory operands are K-major. S^T = K Q~^T and dP^T = V dO^T
//     read Q~ and dO as they are (D innermost). dV += P^T dO and
//     dK += dS^T Q~ need q innermost: the wrapper forms Q~^T and dO^T,
//     (B, H, D, T') with T' = T rounded up to T_ALIGN = 32, the largest BQ
//     (zeros past T, so no box lies wholly outside the tensor), and
//     permutes q within each group of 8 by pi = [0, 2, 4, 6, 1, 3, 5, 7]
//     (k position p holds q row pi(p)).
//   * Consumer warpgroups own 64 kv rows each. Per q tile: S^T and dP^T
//     (3 x DP/8 wgmma m64nBQk8 each, both operands from shared memory) as
//     two commit groups; P^T = exp2(S^T * log2(e) - L * log2(e)) on the
//     fragments of the first (one FFMA and one ex2.approx a score) while
//     the second runs; dS^T = P^T o (dP^T - delta) in f32. The accumulator
//     gives each thread columns (2t, 2t + 1) of every 8-column group; the
//     tf32 register-A fragment wants k = t and t + 4. With pi, k position t
//     is q column 2t and t + 4 is 2t + 1, so the A registers of group i are
//     the accumulator registers (d0, d2, d1, d3) of that group, with no
//     data movement; each is split into hi and lo in registers
//     (cvt.rna.tf32.f32, a subtraction, a second cvt), all of them before
//     the run of wgmmas that reads them (a register A written inside a run
//     serialises it: ptxas C7513). Then dV += P^T dO^T' and dK += dS^T Q~^T'
//     (3 x BQ/8 wgmma m64nDPk8 each, A from registers, B the transposed
//     boxes), one after the other into a per-tile accumulator that is
//     added into dV or dK with round-to-nearest FADDs: the tensor cores'
//     f32 accumulation is not round-to-nearest, and left to sum all of T
//     its errors add up in one direction and grow with T; per tile they
//     stay at the f32 level (within 5e-6 of the plain version's largest
//     value at every shape of chip_smoke.py's phase 4 on an H100). The
//     stage is released once both are waited for.
//   * Q~ rows past T are TMA's zero fill (in the transposed copies, the
//     wrapper's zeros and TMA's), and their L and delta are staged as 0:
//     P = 1 there against dO = 0 and delta = 0, so dS = 0 and those rows
//     add nothing to dV or dK. kv rows past S give rows that the store
//     clips (P may overflow there, but only in those rows).
//   * Shared memory: K and V hi and lo take 16 * BN_MAX * DP bytes, a stage
//     32 * BQ * DP: BN_MAX = 128 with BQ = 32 up to DP = 40 (3 stages at
//     40), BQ = 16 up to 64, then BN_MAX = 64 with BQ = 16 up to MAX_DP = 96
//     (2 stages there). Wider heads do not fit two stages and stay on the
//     mma.sync kernel.
//   * Registers: per consumer thread, BQ / 2 S^T and BQ / 2 dP^T
//     accumulators and DP / 2 of the tile's dV or dK, declared inside the
//     q loop (scale-d 0: dead across tiles), DP / 2 dK and DP / 2 dV
//     sums, BQ / 2 hi and BQ / 2 lo registers each of P^T and dS^T: ~156
//     at DP = 40, BQ = 32 and ~192 at DP = 96, BQ = 16, under the 232 the
//     consumers hold after setmaxnreg.
//   * Epilogue: dK and dV in f32 into the warpgroup's own K hi and V hi
//     rows in shared memory (no longer read), then one TMA store per box,
//     clipped at S.
//
// Left for later: the split inside the kernel after TMA lands (the wrapper
// forms the twelve operand tensors today), the next q tile's S^T under this
// tile's dV/dK products, ping-pong of the two consumer warpgroups.
//
// Entry point: flash_bwd_dkv_tf32x3(...) below, a plain C function for
// ctypes. It encodes the fourteen TMA tensor maps on the host
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: sm90.cuh),
// launches on the given stream and returns cudaGetLastError() after the
// launch; it does not synchronise and allocates nothing.

#include <math.h>

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BOX = 8;      // f32 columns per TMA box: one k8 step, 32-byte rows
constexpr int MAX_DP = 96;  // the widest D instantiated (a multiple of 8)
constexpr int T_ALIGN = 32;  // the transposed copies' q columns: T rounded up to this
constexpr float LOG2E = 1.4426950408889634f;
constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

template <int DP>
struct Cfg {
  static constexpr int KB = DP / BOX;                         // boxes per row
  static constexpr int BN_MAX = DP <= 64 ? 128 : 64;          // kv rows a CTA can hold
  static constexpr int BQ = DP <= 40 ? 32 : 16;               // q rows per stage
  static constexpr int BOX_KV = BN_MAX * BOX;  // elements of one K or V box
  static constexpr int BOX_Q = BQ * BOX;       // of one Q~ or dO box (q rows)
  static constexpr int BOX_T = DP * BOX;       // of one Q~^T or dO^T box (D rows)
  // what TMA brings per stage: hi and lo of Q~, dO, Q~^T, dO^T
  static constexpr int STAGE_BYTES = 8 * BQ * DP * 4;
  static constexpr int KV_BYTES = 4 * KB * BOX_KV * 4;
  // ring depth: what shared memory holds beside K and V (and 1024 bytes of
  // alignment slack, 256 of barriers), at most 4
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - KV_BYTES) / (STAGE_BYTES + 2 * BQ * 4);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(DP % BOX == 0 && DP <= MAX_DP && STAGES >= 2, "tile");
};

// Shared memory of one CTA from a 1024-byte aligned base. Every box is a
// multiple of 256 bytes, the 32-byte swizzle's period, so each box and each
// warpgroup's 64 rows inside it start on that period.
template <int DP>
struct Smem {
  using C = Cfg<DP>;
  float k[2][C::KB][C::BOX_KV];  // K hi, lo (BN_MAX rows); dK in k[0] for the store
  float v[2][C::KB][C::BOX_KV];  // V hi, lo; dV in v[0]
  float q[C::STAGES][2][C::KB][C::BOX_Q];        // Q~ hi, lo
  float o[C::STAGES][2][C::KB][C::BOX_Q];        // dO hi, lo
  float qt[C::STAGES][2][C::BQ / BOX][C::BOX_T];  // Q~^T hi, lo (pi-permuted q)
  float ot[C::STAGES][2][C::BQ / BOX][C::BOX_T];  // dO^T hi, lo
  float lse[C::STAGES][C::BQ];                    // L * log2(e); 0 past T
  float dlt[C::STAGES][C::BQ];                    // delta; 0 past T
  uint64_t full[C::STAGES];
  uint64_t empty[C::STAGES];
  uint64_t kv_full;
};

template <int DP>
constexpr size_t kSmemBytes = sizeof(Smem<DP>) + 1024;  // + alignment slack

// The fourteen tensor maps: hi and lo of Q~, dO, K, V, Q~^T, dO^T, then dK, dV
struct Maps {
  CUtensorMap q[2], o[2], k[2], v[2], qt[2], ot[2], dk, dv;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Launched with (nc + 1) * 128 threads: nc = 1 or 2 consumer warpgroups
// (BN = 64 * nc kv rows), then the producer warpgroup.
template <int DP>
__global__ void __launch_bounds__(3 * 128, 1)
    flash_bwd_dkv_tf32x3_kernel(const __grid_constant__ Maps m, const float* __restrict__ lse,
                                const float* __restrict__ delta, int H, int T) {
  using C = Cfg<DP>;
  constexpr int KB = C::KB;
  constexpr int BQ = C::BQ;
  constexpr int QB = BQ / BOX;  // k8 steps of dV and dK per tile
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Smem<DP>& s = *reinterpret_cast<Smem<DP>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int nc = blockDim.x / 128 - 1;
  const int kv0 = blockIdx.x * 64 * nc;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int n_tiles = (T + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1 + 32);   // the TMA thread's expect_tx + the staging warp
      mbar_init(&s.empty[i], nc * 4);  // one arrival per consumer warp
    }
    mbar_init(&s.kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == nc) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int ptid = threadIdx.x - nc * 128;
    if (ptid == 0) {
      // one thread issues every TMA load; the full boxes are counted even
      // where TMA zero-fills past the edge
      mbar_expect_tx(&s.kv_full, 4 * KB * 64 * nc * BOX * 4);
      for (int x = 0; x < 2; ++x) {
        for (int kb = 0; kb < KB; ++kb) {
          tma_load_4d(s.k[x][kb], &m.k[x], &s.kv_full, kb * BOX, kv0, h, b);
          tma_load_4d(s.v[x][kb], &m.v[x], &s.kv_full, kb * BOX, kv0, h, b);
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
            tma_load_4d(s.q[stage][x][kb], &m.q[x], bar, kb * BOX, j * BQ, h, b);
            tma_load_4d(s.o[stage][x][kb], &m.o[x], bar, kb * BOX, j * BQ, h, b);
          }
          for (int qb = 0; qb < QB; ++qb) {
            tma_load_4d(s.qt[stage][x][qb], &m.qt[x], bar, j * BQ + qb * BOX, 0, h, b);
            tma_load_4d(s.ot[stage][x][qb], &m.ot[x], bar, j * BQ + qb * BOX, 0, h, b);
          }
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (ptid >= 32 && ptid < 64) {
      // the second warp stages L * log2(e) and delta of each q tile
      const int lane = ptid - 32;
      const float* L = lse + (long long)blockIdx.y * T;
      const float* Dl = delta + (long long)blockIdx.y * T;
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        for (int i = lane; i < BQ; i += 32) {
          const int row = j * BQ + i;
          s.lse[stage][i] = row < T ? L[row] * LOG2E : 0.f;
          s.dlt[stage][i] = row < T ? Dl[row] : 0.f;
        }
        mbar_arrive(&s.full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 kv rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // accumulator fragments: warp w holds rows 16w + g and 16w + g + 8 of
    // the warpgroup's 64 kv rows, columns 8i + 2t and 8i + 2t + 1 of each
    // n8 block i (q columns of the tile for S^T and dP^T, D for dK and dV)
    const int g = lane >> 2, t = lane & 3;
    const uint32_t bar_id = 1 + wg;  // this warpgroup's named barrier

    // descriptors (32-byte swizzle: 8-row groups of 32-byte rows, 256 bytes
    // apart), all K-major: K and V hi / lo as the A of S^T and dP^T, box kb
    // one k8 step further; Q~ and dO as their B; Q~^T and dO^T as the B of
    // dK and dV, box qb one k8 step (8 q rows) further
    constexpr uint32_t KV_STEP = C::BOX_KV * 4 / 16;  // descriptor units (16 bytes)
    constexpr uint32_t Q_STEP = C::BOX_Q * 4 / 16;
    constexpr uint32_t T_STEP = C::BOX_T * 4 / 16;
    uint64_t ka[2], va[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      ka[x] = smem_desc(s.k[x][0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
      va[x] = smem_desc(s.v[x][0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
    }
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;

    mbar_wait(&s.kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&s.full[stage], phase);
      uint64_t qd[2], od[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        qd[x] = smem_desc(s.q[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
        od[x] = smem_desc(s.o[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
      }
      // S^T = K Q~^T and dP^T = V dO^T, two commit groups of hi.hi, hi.lo,
      // lo.hi per k8 step. The accumulators are fresh each tile: the first
      // wgmma's scale-d 0 ignores them.
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        wgmma_ss_tf32(st, ka[0] + kb * KV_STEP, qd[0] + kb * Q_STEP, kb);
        wgmma_ss_tf32(st, ka[0] + kb * KV_STEP, qd[1] + kb * Q_STEP, 1);
        wgmma_ss_tf32(st, ka[1] + kb * KV_STEP, qd[0] + kb * Q_STEP, 1);
      }
      wgmma_commit();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        wgmma_ss_tf32(dpt, va[0] + kb * KV_STEP, od[0] + kb * Q_STEP, kb);
        wgmma_ss_tf32(dpt, va[0] + kb * KV_STEP, od[1] + kb * Q_STEP, 1);
        wgmma_ss_tf32(dpt, va[1] + kb * KV_STEP, od[0] + kb * Q_STEP, 1);
      }
      wgmma_commit();

      // P^T = exp2(S^T log2(e) - L log2(e)), L per q column, while dP^T runs
      wgmma_wait<1>();
      fence_regs(st);
      const float* Ls = s.lse[stage];
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 l = *reinterpret_cast<const float2*>(Ls + 8 * i + 2 * t);
        st[4 * i] = ex2(fmaf(st[4 * i], LOG2E, -l.x));
        st[4 * i + 1] = ex2(fmaf(st[4 * i + 1], LOG2E, -l.y));
        st[4 * i + 2] = ex2(fmaf(st[4 * i + 2], LOG2E, -l.x));
        st[4 * i + 3] = ex2(fmaf(st[4 * i + 3], LOG2E, -l.y));
      }
      // dS^T = P^T o (dP^T - delta)
      wgmma_wait<0>();
      fence_regs(dpt);
      const float* Ds = s.dlt[stage];
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 d = *reinterpret_cast<const float2*>(Ds + 8 * i + 2 * t);
        dpt[4 * i] = st[4 * i] * (dpt[4 * i] - d.x);
        dpt[4 * i + 1] = st[4 * i + 1] * (dpt[4 * i + 1] - d.y);
        dpt[4 * i + 2] = st[4 * i + 2] * (dpt[4 * i + 2] - d.x);
        dpt[4 * i + 3] = st[4 * i + 3] * (dpt[4 * i + 3] - d.y);
      }
      // P^T and dS^T as tf32 register-A fragments, hi and lo: the k8 step i
      // takes accumulator registers (d0, d2, d1, d3) of n8 block i (pi)
      uint32_t ph[BQ / 2], pl[BQ / 2], dh[BQ / 2], dl[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int src = 4 * i + ((r & 1) << 1) + (r >> 1);  // 0, 2, 1, 3
          split_tf32(st[src], ph[4 * i + r], pl[4 * i + r]);
          split_tf32(dpt[src], dh[4 * i + r], dl[4 * i + r]);
        }
      }
      fence_u32(ph);  // every A register is written before the wgmmas start
      fence_u32(pl);
      fence_u32(dh);
      fence_u32(dl);

      // dV += P^T dO, then dK += dS^T Q~ (B: the transposed boxes). Each
      // tile's product goes to a fresh accumulator that is added into dV or
      // dK with a round-to-nearest FADD: the tensor cores' own f32
      // accumulation is not round-to-nearest, and over 3 * T / 8 steps its
      // errors add up in one direction (against 3 * BQ / 8 steps per tile
      // here)
      uint64_t qtd[2], otd[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        qtd[x] = smem_desc(s.qt[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
        otd[x] = smem_desc(s.ot[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
      }
      float acc[DP / 2];
      wgmma_fence();
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) {
        wgmma_rs_tf32(acc, ph + 4 * qb, otd[0] + qb * T_STEP, qb);
        wgmma_rs_tf32(acc, ph + 4 * qb, otd[1] + qb * T_STEP, 1);
        wgmma_rs_tf32(acc, pl + 4 * qb, otd[0] + qb * T_STEP, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dv[i] += acc[i];
      wgmma_fence();
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) {
        wgmma_rs_tf32(acc, dh + 4 * qb, qtd[0] + qb * T_STEP, qb);
        wgmma_rs_tf32(acc, dh + 4 * qb, qtd[1] + qb * T_STEP, 1);
        wgmma_rs_tf32(acc, dl + 4 * qb, qtd[0] + qb * T_STEP, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] += acc[i];
      fence_u32(ph);
      fence_u32(pl);
      fence_u32(dh);
      fence_u32(dl);
      if (lane == 0) mbar_arrive(&s.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: dK and dV in f32 into this warpgroup's K hi and V hi rows
    // (32-byte swizzle: 16-byte chunk c of row r at c ^ ((r >> 2) & 1)),
    // then a TMA store per box, clipped at S
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");  // K, V reads are done
    const int r0 = warp * 16 + g;
    const int swz = (r0 >> 2) & 1;  // the same for r0 + 8
    const int off = (wg * 64 + r0) * 32 + (((t >> 1) ^ swz) << 4) + ((t & 1) << 3);
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      uint8_t* kx = reinterpret_cast<uint8_t*>(s.k[0][i]) + off;
      uint8_t* vx = reinterpret_cast<uint8_t*>(s.v[0][i]) + off;
      *reinterpret_cast<float2*>(kx) = make_float2(dk[4 * i], dk[4 * i + 1]);
      *reinterpret_cast<float2*>(kx + 8 * 32) = make_float2(dk[4 * i + 2], dk[4 * i + 3]);
      *reinterpret_cast<float2*>(vx) = make_float2(dv[4 * i], dv[4 * i + 1]);
      *reinterpret_cast<float2*>(vx + 8 * 32) = make_float2(dv[4 * i + 2], dv[4 * i + 3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (tid == 0) {
      for (int kb = 0; kb < KB; ++kb)
        tma_store_4d(&m.dk, s.k[0][kb] + wg * 64 * BOX, kb * BOX, kv0 + wg * 64, h, b);
      for (int kb = 0; kb < KB; ++kb)
        tma_store_4d(&m.dv, s.v[0][kb] + wg * 64 * BOX, kb * BOX, kv0 + wg * 64, h, b);
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
    e = cudaFuncSetAttribute(flash_bwd_dkv_tf32x3_kernel<DP>,
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
                   const long long* st, int B, int H, int T, int S, int D, int bn,
                   cudaStream_t stream) {
  if (bn > Cfg<DP>::BN_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = prepare<DP>();
  if (e != cudaSuccess) return e;
  constexpr int BQ = Cfg<DP>::BQ;
  static_assert(kSmemBytes<DP> <= SMEM_MAX && BQ <= T_ALIGN, "shared memory");
  const int Tp = (T + T_ALIGN - 1) / T_ALIGN * T_ALIGN;  // the transposed copies' q columns
  Maps m;
  bool ok = true;
  for (int x = 0; x < 2; ++x) {
    ok = ok && encode_bhtd(fn, &m.q[x], ptrs[x], st + 3 * x, B, H, T, D, BQ, F32) &&
         encode_bhtd(fn, &m.o[x], ptrs[2 + x], st + 3 * (2 + x), B, H, T, D, BQ, F32) &&
         encode_bhtd(fn, &m.k[x], ptrs[4 + x], st + 3 * (4 + x), B, H, S, D, bn, F32) &&
         encode_bhtd(fn, &m.v[x], ptrs[6 + x], st + 3 * (6 + x), B, H, S, D, bn, F32) &&
         encode_bhtd(fn, &m.qt[x], ptrs[8 + x], st + 3 * (8 + x), B, H, D, Tp, DP, F32) &&
         encode_bhtd(fn, &m.ot[x], ptrs[10 + x], st + 3 * (10 + x), B, H, D, Tp, DP, F32);
  }
  ok = ok && encode_bhtd(fn, &m.dk, ptrs[12], st + 36, B, H, S, D, 64, F32) &&
       encode_bhtd(fn, &m.dv, ptrs[13], st + 39, B, H, S, D, 64, F32);
  if (!ok) return cudaErrorInvalidValue;
  const dim3 grid((S + bn - 1) / bn, B * H);
  flash_bwd_dkv_tf32x3_kernel<DP><<<grid, (bn / 64 + 1) * 128, kSmemBytes<DP>, stream>>>(
      m, lse, delta, H, T);
  return cudaGetLastError();
}

}  // namespace

// q~ (f32(q) * scale), dout, k, v, each as hi and lo (tf32 bit patterns:
// the wrapper's _split_tf32), and the pi-permuted transposed copies of q~
// and dout, hi and lo, (B, H, D, T') with T' = T rounded up to T_ALIGN,
// zeros past T; dk and dv f32 outputs. Every tensor has a unit last stride.
// strides: 42 element strides, (batch, head, row) for each of the fourteen
// tensors in that order, each positive and a multiple of 4 (TMA's 16-byte
// global strides); 16-byte aligned bases. lse and delta: (B, H, T) f32
// contiguous. bn: kv rows per CTA, 64 or 128 (128 only where D <= 64). scale
// is not read (Q~ carries it); it keeps the argument list of the other flash
// entry points. Returns a cudaError_t: cudaErrorInvalidValue for what the
// kernel does not take (the wrapper routes those calls to flash_bwd.cu
// first) or a map that cannot be encoded.
extern "C" int flash_bwd_dkv_tf32x3(const void* qh, const void* ql, const void* oh,
                                    const void* ol, const void* kh, const void* kl,
                                    const void* vh, const void* vl, const void* qth,
                                    const void* qtl, const void* oth, const void* otl,
                                    const void* lse, const void* delta, void* dk, void* dv,
                                    const long long* strides, int B, int H, int T, int S, int D,
                                    int bn, float scale, void* stream) {
  (void)scale;
  if (B < 1 || H < 1 || T < 1 || S < 1 || D < 8 || D > MAX_DP || D % 8 != 0 ||
      (long long)B * H > 65535 || (bn != 64 && bn != 128)) {
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
#define DKV_TF32X3_CASE(DP_) \
  case DP_:                  \
    return (int)launch<DP_>(fn, ptrs, L, Dl, strides, B, H, T, S, D, bn, st);
    DKV_TF32X3_CASE(8)
    DKV_TF32X3_CASE(16)
    DKV_TF32X3_CASE(24)
    DKV_TF32X3_CASE(32)
    DKV_TF32X3_CASE(40)
    DKV_TF32X3_CASE(48)
    DKV_TF32X3_CASE(56)
    DKV_TF32X3_CASE(64)
    DKV_TF32X3_CASE(72)
    DKV_TF32X3_CASE(80)
    DKV_TF32X3_CASE(88)
    DKV_TF32X3_CASE(96)
#undef DKV_TF32X3_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The instance that takes head dim D: out = {DP, BQ, STAGES, dynamic shared
// memory bytes, BN_MAX}. Returns 0, or cudaErrorInvalidValue for a D no
// instance takes.
extern "C" int flash_bwd_dkv_tf32x3_config(int D, int* out) {
  switch (D) {
#define DKV_TF32X3_CONFIG(DP_)                                                         \
  case DP_:                                                                            \
    out[0] = DP_;                                                                      \
    out[1] = Cfg<DP_>::BQ;                                                             \
    out[2] = Cfg<DP_>::STAGES;                                                         \
    out[3] = (int)kSmemBytes<DP_>;                                                     \
    out[4] = Cfg<DP_>::BN_MAX;                                                         \
    return 0;
    DKV_TF32X3_CONFIG(8)
    DKV_TF32X3_CONFIG(16)
    DKV_TF32X3_CONFIG(24)
    DKV_TF32X3_CONFIG(32)
    DKV_TF32X3_CONFIG(40)
    DKV_TF32X3_CONFIG(48)
    DKV_TF32X3_CONFIG(56)
    DKV_TF32X3_CONFIG(64)
    DKV_TF32X3_CONFIG(72)
    DKV_TF32X3_CONFIG(80)
    DKV_TF32X3_CONFIG(88)
    DKV_TF32X3_CONFIG(96)
#undef DKV_TF32X3_CONFIG
  }
  return (int)cudaErrorInvalidValue;
}
