// Flash-attention dQ backward for Hopper (sm_90a), bf16, non-causal:
//     dQ = bf16( f32(bf16( sum_j bf16(dS_j) K_j )) * scale )
// with Q~ = bf16(f32(q) * scale) formed by the wrapper before the launch,
// P = exp(Q~ K^T - L) in f32 from the forward's f32 logsumexp L, and
// dS = P o (dO V^T - delta) formed from the f32 P, delta = rowsum(dO o O)
// in f32 (the wrapper's). Q~, dO (B, H, T, D) and K, V (B, H, S, D) bf16;
// dQ comes back in bf16 in the layout of the tensor it is written to.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (:178-207, driven by _bwd :258-300, scaled at :334) for
// bf16 inputs, and computes what it computes: the products in bf16 with f32
// sums, dS rounded to bf16 before its product, dQ rounded to bf16, then
// multiplied by `scale` in f32 and rounded again (the kernel's sum is taken
// against the pre-scaled Q~, so dL/dq = scale * dS K). flash_bwd.cu's
// flash_bwd_dq (mma.sync) serves what this kernel does not take: f32,
// D > MAX_DP, strides of 0 (ops/flash_attention.py _dq_route picks the
// kernel from dtype, D and layout alone).
//
// What bounds it on an H100 at the SD-1.5 training shape (B = 1, H = 8,
// T = S = 4096, D = 40): three products per score (S, dP, dQ),
// 6*B*H*T*S*D = 32 GFLOP, 0.033 ms at 989 TFLOP/s (0.039 at D padded to
// 48); B*H*T*S = 134 M exponentials, 0.032 ms at 16 a clock per SM. The
// bytes (q, k, v, dO, L and delta read once, dQ written once: ~11 MB) are
// 0.003 ms. The tensor cores and the exponential unit set the floor
// together.
//
// Design (the forward's pipeline, flash_fwd_wgmma.cu, with a second score
// product and dS K in place of P V):
//   * One CTA per (BM q rows, head), looping over every kv tile; nothing
//     carries between CTAs and nothing is atomic, so the sums run in one
//     fixed order (deterministic, like the TPU kernel). BM = 64 per
//     consumer warpgroup, 1 or 2 of them, chosen per launch on the host
//     (ops/flash_attention.py _dq_bm: 128 unless that leaves SMs idle).
//   * Producer warpgroup (setmaxnreg gives its registers away): one thread
//     issues every TMA load, Q~ and dO once per CTA, then K and V tiles of
//     BN kv rows through a ring of up to 4 stages with a `full` and an
//     `empty` mbarrier each. 4-D tensor maps (D, rows, H, B) from each
//     tensor's strides, so the UNet's transposed views are read, and dQ
//     written, in place. Every tile is 16-column boxes with 32-byte rows and
//     the 32-byte swizzle (D = 40 runs as 48 by TMA's zero fill, 80 and 160
//     unpadded), one box per k16 step of S and dP and per 16-column atom of
//     the MN-major K operand of dS K.
//   * L and delta are per q row here: each consumer thread loads those of
//     its two rows once per CTA into registers, L pre-multiplied by log2(e),
//     both 0 past T. Nothing is staged per stage.
//   * Consumer warpgroups own 64 q rows each. Per kv tile: S = Q~ K^T and
//     dP = dO V^T (wgmma m64nBNk16, both operands K-major in shared memory)
//     as two commit groups; P = exp2(S * log2(e) - L * log2(e)) on the
//     fragments of the first (one FFMA and one ex2.approx a score) while the
//     second runs; dS = P o (dP - delta) in f32, packed to bf16 as
//     register-A fragments (the f32 accumulator layout re-packs with no
//     shuffles, as the forward's P). Then dQ += dS K (wgmma m64nDPk16, A
//     from registers, the same K tile read MN-major through the transpose
//     bit: LBO = the box stride, SBO = 256 bytes), the stage released once
//     that product is waited for. ptxas serialises a run of in-flight
//     wgmmas if one of them reads a register A written inside the run
//     (C7513), so dS is packed completely before the run.
//   * Ragged tails. Q~ and dO rows past T are TMA's zero fill with L and
//     delta 0: S = 0, P = 1, dP = 0, so dS = 0; the store clips those rows.
//     K and V rows past S are zero too, but there P = exp(-L), which is
//     not 0 and overflows f32 for L below about -88, and an inf dS times a
//     zero K row is NaN. So the last tile's columns >= S are masked to -inf
//     before the exponential (P = 0, dS = 0), as the forward masks them.
//   * Registers: per consumer thread, BN / 2 S and BN / 2 dP accumulators,
//     declared inside the kv loop and never read before their first wgmma
//     (scale-d 0), so nothing keeps them live across tiles; DP / 2 dQ
//     accumulators; BN / 4 packed dS registers. BN shrinks as D grows (128
//     up to DP = 64, then 64) so the peak, the two score tiles beside dQ,
//     stays under the 232 registers the consumers hold after setmaxnreg.
//   * Epilogue: dQ rounded to bf16, multiplied by `scale` in f32 and
//     rounded again in registers, written into the warpgroup's own Q~ rows
//     in shared memory (no longer read), then one TMA store per box, clipped
//     at T and D.
//
// Left for later: issuing the next kv tile's S and dP under this tile's
// dS K product, ping-pong of the two consumer warpgroups, and the FA3
// alternative of accumulating dQ with f32 atomics inside the dK/dV kernel
// (no recomputed S and dP, but a sum order that changes from run to run).
//
// Entry point: flash_bwd_dq_wgmma(...) below, a plain C function for
// ctypes. It encodes the five TMA tensor maps on the host
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: sm90.cuh),
// launches on the given stream and returns cudaGetLastError() after the
// launch; it does not synchronise and allocates nothing.

#include <math.h>

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BOX = 16;      // columns per TMA box: one k16 step, 32-byte rows
constexpr int BM_MAX = 128;  // q rows per CTA with two consumer warpgroups
constexpr int MAX_DP = 160;  // the widest D (rounded up to 16) instantiated
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Cfg {
  static constexpr int KB = DP / BOX;              // boxes per row
  static constexpr int BN = DP <= 64 ? 128 : 64;   // kv rows per stage
  static constexpr int BOX_Q = BM_MAX * BOX;       // elements of one Q~ or dO box
  static constexpr int BOX_KV = BN * BOX;          // elements of one K or V box
  static constexpr int STAGE_BYTES = 2 * KB * BOX_KV * 2;  // what TMA brings per stage
  // ring depth: what shared memory holds beside Q~ and dO (and 1024 bytes
  // of alignment slack, 256 of barriers), at most 4
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - 2 * KB * BOX_Q * 2) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(DP % BOX == 0 && DP <= MAX_DP && STAGES >= 2, "tile");
};

// Shared memory of one CTA from a 1024-byte aligned base. Every box is a
// multiple of 256 bytes, the 32-byte swizzle's period, so each box and each
// warpgroup's 64 rows inside it start on that period.
template <int DP>
struct Smem {
  using C = Cfg<DP>;
  __nv_bfloat16 q[C::KB][C::BOX_Q];  // Q~ boxes (BM rows), then dQ for the store
  __nv_bfloat16 o[C::KB][C::BOX_Q];  // dO boxes
  __nv_bfloat16 k[C::STAGES][C::KB][C::BOX_KV];
  __nv_bfloat16 v[C::STAGES][C::KB][C::BOX_KV];
  uint64_t full[C::STAGES];
  uint64_t empty[C::STAGES];
  uint64_t q_full;
};

template <int DP>
constexpr size_t kSmemBytes = sizeof(Smem<DP>) + 1024;  // + alignment slack

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Launched with (nc + 1) * 128 threads: nc = 1 or 2 consumer warpgroups
// (BM = 64 * nc q rows), then the producer warpgroup.
template <int DP>
__global__ void __launch_bounds__((BM_MAX / 64 + 1) * 128, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                              const __grid_constant__ CUtensorMap tmap_k,
                              const __grid_constant__ CUtensorMap tmap_v,
                              const __grid_constant__ CUtensorMap tmap_do,
                              const __grid_constant__ CUtensorMap tmap_dq,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, int H, int T, int S,
                              float scale) {
  using C = Cfg<DP>;
  constexpr int KB = C::KB;
  constexpr int BN = C::BN;
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
      mbar_expect_tx(&s.q_full, 2 * KB * 64 * nc * BOX * 2);
      for (int kb = 0; kb < KB; ++kb) tma_load_4d(s.q[kb], &tmap_q, &s.q_full, kb * BOX, q0, h, b);
      for (int kb = 0; kb < KB; ++kb) tma_load_4d(s.o[kb], &tmap_do, &s.q_full, kb * BOX, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        mbar_expect_tx(&s.full[stage], C::STAGE_BYTES);
        for (int kb = 0; kb < KB; ++kb)
          tma_load_4d(s.k[stage][kb], &tmap_k, &s.full[stage], kb * BOX, j * BN, h, b);
        for (int kb = 0; kb < KB; ++kb)
          tma_load_4d(s.v[stage][kb], &tmap_v, &s.full[stage], kb * BOX, j * BN, h, b);
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
    // block i (kv rows of the tile for S and dP, D for dQ)
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
    // apart): Q~, dO as A and K, V as the B of S and dP, K-major, box kb one
    // k16 step further; K as the B of dQ, MN-major, 16 kv rows (512 bytes)
    // per k16 step, its boxes BOX_KV elements apart
    const uint64_t q_a = smem_desc(s.q[0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
    const uint64_t o_a = smem_desc(s.o[0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
    constexpr uint32_t Q_STEP = C::BOX_Q * 2 / 16;  // descriptor units (16 bytes)
    constexpr uint32_t KV_STEP = C::BOX_KV * 2 / 16;
    constexpr uint32_t ROW16 = 16 * 32 / 16;  // 16 rows of one box
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;

    mbar_wait(&s.q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&s.full[stage], phase);
      // S = Q~ K^T and dP = dO V^T, two commit groups. The accumulators are
      // fresh each tile: the first k-step's scale-d 0 ignores them.
      float sc[BN / 2], dp[BN / 2];
      const uint64_t k_b = smem_desc(s.k[stage][0], 16, 256, DESC_SWIZZLE_32B);
      const uint64_t v_b = smem_desc(s.v[stage][0], 16, 256, DESC_SWIZZLE_32B);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) wgmma_ss(sc, q_a + kb * Q_STEP, k_b + kb * KV_STEP, kb);
      wgmma_commit();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) wgmma_ss(dp, o_a + kb * Q_STEP, v_b + kb * KV_STEP, kb);
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
      // dS = P o (dP - delta) from the f32 P
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        dp[4 * i] = sc[4 * i] * (dp[4 * i] - d0);
        dp[4 * i + 1] = sc[4 * i + 1] * (dp[4 * i + 1] - d0);
        dp[4 * i + 2] = sc[4 * i + 2] * (dp[4 * i + 2] - d1);
        dp[4 * i + 3] = sc[4 * i + 3] * (dp[4 * i + 3] - d1);
      }
      // dS in bf16: n8 blocks 2kt and 2kt + 1 are the A fragment of k16
      // slice kt (rows g, g + 8; columns 2t and 2t + 8 of the slice)
      uint32_t ds[BN / 4];
#pragma unroll
      for (int kt = 0; kt < BN / 16; ++kt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) ds[4 * kt + r] = pack_bf16(dp[8 * kt + 2 * r], dp[8 * kt + 2 * r + 1]);
      }
      fence_u32(ds);  // every A register is written before the wgmmas start

      // dQ += dS K
      const uint64_t k_mn = smem_desc(s.k[stage][0], C::BOX_KV * 2, 256, DESC_SWIZZLE_32B);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BN / 16; ++kt) wgmma_rs<1>(dq, ds + 4 * kt, k_mn + kt * ROW16, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_u32(ds);
      if (lane == 0) mbar_arrive(&s.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: dQ = bf16(f32(bf16(dQ)) * scale) into this warpgroup's Q~
    // rows (32-byte swizzle: 16-byte chunk c of row r at c ^ ((r >> 2) & 1)),
    // then a TMA store per box, clipped at T and D
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");  // Q~ reads are done
    const int row_off = (wg * 64 + r0) * 32 + 4 * t;
    const int swz = (r0 >> 2) & 1;  // the same for r0 + 8
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      uint8_t* box = reinterpret_cast<uint8_t*>(s.q[i >> 1]) + row_off + (((i & 1) ^ swz) << 4);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = __bfloat162float(__float2bfloat16_rn(dq[4 * i + e])) * scale;
      *reinterpret_cast<uint32_t*>(box) = pack_bf16(x[0], x[1]);
      *reinterpret_cast<uint32_t*>(box + 8 * 32) = pack_bf16(x[2], x[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (tid == 0) {
      for (int kb = 0; kb < KB; ++kb)
        tma_store_4d(&tmap_dq, s.q[kb] + wg * 64 * BOX, kb * BOX, q0 + wg * 64, h, b);
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
    e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes<DP>);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int DP>
cudaError_t launch(EncodeTiled fn, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, const long long* st, int B,
                   int H, int T, int S, int D, int bm, float scale, cudaStream_t stream) {
  const cudaError_t e = prepare<DP>();
  if (e != cudaSuccess) return e;
  constexpr int BN = Cfg<DP>::BN;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!encode_bhtd(fn, &tq, q, st, B, H, T, D, bm) ||
      !encode_bhtd(fn, &tk, k, st + 3, B, H, S, D, BN) ||
      !encode_bhtd(fn, &tv, v, st + 6, B, H, S, D, BN) ||
      !encode_bhtd(fn, &tdo, dout, st + 9, B, H, T, D, bm) ||
      !encode_bhtd(fn, &tdq, dq, st + 12, B, H, T, D, 64)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((T + bm - 1) / bm, B * H);
  flash_bwd_dq_wgmma_kernel<DP><<<grid, (bm / 64 + 1) * 128, kSmemBytes<DP>, stream>>>(
      tq, tk, tv, tdo, tdq, lse, delta, H, T, S, scale);
  return cudaGetLastError();
}

}  // namespace

// q is Q~ = bf16(f32(q) * scale), formed by the caller; k, v, dout, dq bf16
// with a unit last stride. strides: 15 element strides, (batch, head, row)
// for q, k, v, dout, dq, each positive and a multiple of 8 (TMA's 16-byte
// global strides); 16-byte aligned bases. lse and delta: (B, H, T) f32
// contiguous. bm: q rows per CTA, 64 or 128. scale multiplies dQ in the
// epilogue (Q~ carries it into the scores). Returns a cudaError_t:
// cudaErrorInvalidValue for what the kernel does not take (the wrapper
// routes those calls to flash_bwd.cu first) or a map that cannot be encoded.
extern "C" int flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  const long long* strides, int B, int H, int T, int S, int D,
                                  int bm, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1 || S < 1 || D < 8 || D > MAX_DP || D % 8 != 0 ||
      (long long)B * H > 65535 || (bm != 64 && bm != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq)) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 15; ++i) {
    if (strides[i] <= 0 || strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + BOX - 1) / BOX * BOX) {
#define DQ_WGMMA_CASE(DP_) \
  case DP_:                \
    return (int)launch<DP_>(fn, q, k, v, dout, L, Dl, dq, strides, B, H, T, S, D, bm, scale, st);
    DQ_WGMMA_CASE(16)
    DQ_WGMMA_CASE(32)
    DQ_WGMMA_CASE(48)
    DQ_WGMMA_CASE(64)
    DQ_WGMMA_CASE(80)
    DQ_WGMMA_CASE(96)
    DQ_WGMMA_CASE(112)
    DQ_WGMMA_CASE(128)
    DQ_WGMMA_CASE(144)
    DQ_WGMMA_CASE(160)
#undef DQ_WGMMA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The instance that takes head dim D: out = {DP, BN, STAGES, dynamic shared
// memory bytes}. Returns 0, or cudaErrorInvalidValue for a D no instance
// takes.
extern "C" int flash_bwd_dq_wgmma_config(int D, int* out) {
  if (D < 8 || D > MAX_DP || D % 8 != 0) return (int)cudaErrorInvalidValue;
  switch ((D + BOX - 1) / BOX * BOX) {
#define DQ_WGMMA_CONFIG(DP_)        \
  case DP_:                         \
    out[0] = DP_;                   \
    out[1] = Cfg<DP_>::BN;          \
    out[2] = Cfg<DP_>::STAGES;      \
    out[3] = (int)kSmemBytes<DP_>;  \
    return 0;
    DQ_WGMMA_CONFIG(16)
    DQ_WGMMA_CONFIG(32)
    DQ_WGMMA_CONFIG(48)
    DQ_WGMMA_CONFIG(64)
    DQ_WGMMA_CONFIG(80)
    DQ_WGMMA_CONFIG(96)
    DQ_WGMMA_CONFIG(112)
    DQ_WGMMA_CONFIG(128)
    DQ_WGMMA_CONFIG(144)
    DQ_WGMMA_CONFIG(160)
#undef DQ_WGMMA_CONFIG
  }
  return (int)cudaErrorInvalidValue;
}
