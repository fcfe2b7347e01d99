// Flash-attention forward for Hopper (sm_90a), bf16, non-causal:
//     O = softmax(scale * Q K^T) V,   L = rowwise logsumexp(scale * Q K^T)
// for q (B, H, T, D) and k, v (B, H, S, D) in bf16; O bf16 in q's layout, L
// f32 (B, H, T), in the natural log: what the backward kernels read.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/flash_attention.py::_fwd_kernel
// (:104-132, driven by _fwd :135-171) for bf16 inputs. It computes the same
// function: q is pre-scaled by `scale` in f32 and rounded to bf16 (_scale_q,
// :94-97), the scores, the running max m, the running sum l and the
// accumulator are f32, the probabilities are rounded to bf16 before the P.V
// product and O = acc / l is rounded once; L = m + log(l). flash_fwd.cu
// (mma.sync) serves what this kernel does not take: f32, D > 160,
// strides of 0 (ops/flash_attention.py _fwd_route picks the kernel from
// dtype, D and layout alone).
//
// What bounds it on an H100 at the SD-1.5 serving shape (B = 4, H = 8,
// T = S = 4096, D = 40): the tensor cores' FLOPs, 4*B*H*T*S*D = 86 GFLOP,
// are 0.087 ms at 989 TFLOP/s; the softmax's B*H*T*S = 537 M exponentials
// are ~0.14 ms at 16 a clock per SM (132 SMs, ~1.75 GHz). So at D = 40 the
// exponential unit, not the tensor cores, sets the floor; at D = 80 and 160
// the two floors are within 2x of each other. Both are far above the bytes
// (q, k, v and O read or written once: ~42 MB, 0.013 ms).
//
// Design, and what each part does about that:
//   * Warp specialisation. One producer warpgroup, in which one thread issues
//     every TMA load (setmaxnreg gives its registers to the consumers), and 1
//     or 2 consumer warpgroups, each owning 64 q rows: BM = 64 or 128 q rows
//     per CTA, chosen per launch on the host (ops/flash_attention.py
//     _fwd_bm: 128 unless that leaves SMs idle). One CTA per (BM q rows,
//     head); nothing carries between CTAs.
//   * TMA loads through 4-D tensor maps (D, rows, H, B) built from the
//     tensors' own strides, so the UNet's transposed views of (B, T, H, D)
//     projections are read and O is written in place. Q is loaded once per
//     CTA; K and V go through a ring of up to 4 stages of BN kv rows each
//     (BN = 128 for D <= 128, else 64), with a `full` and an `empty` mbarrier
//     per stage. TMA zero-fills rows past T and S and columns past D: nothing
//     is padded in device memory, and the ragged edges cost no masking on
//     load.
//   * Swizzle and D. D = 40, 80 and 160 are not multiples of 64,
//     and a K-major tile under the 128-byte swizzle needs 64-element rows.
//     Every tile is stored as 16-column boxes with 32-byte rows and the
//     32-byte swizzle (DP = D rounded up to 16: 3 / 5 / 10 boxes), so one box
//     is one k16 step of Q K^T and one 16-column atom of the MN-major V
//     operand. Q K^T does DP / 16 k-steps (D = 40 runs as 48, the last 8
//     columns TMA's zero fill), and P V has N = DP: 1.2x the work at D = 40,
//     none at 80 and 160 (128-byte rows padded to 64 / 128 / 192 columns
//     would cost 1.6x / 1.6x / 1.2x on P V).
//   * Q is scaled after it arrives (TMA cannot scale on load): each consumer
//     warpgroup rescales its 64 rows in shared memory once (f32 multiply,
//     one rounding to bf16, as _scale_q), then fence.proxy.async before its
//     first wgmma. Scaling S instead would round differently from JAX.
//   * S = Q K^T: wgmma m64nBNk16, both operands K-major in shared memory,
//     f32 accumulators in registers.
//   * Online softmax on the accumulator fragments: a row lives in the 4
//     threads of a quad; columns >= S are set to -inf in the last tile only;
//     p = exp2(s * log2(e) - m * log2(e)) (one FFMA and one ex2.approx per
//     score: the exponential unit is the floor above); l is kept per thread
//     and summed over the quad once, at the end; L = m + log(l) in the
//     natural log.
//   * O += P V: wgmma m64nDPk16 with A = P from registers (the f32
//     accumulator layout of S re-packs into the A fragments of successive
//     k16 slices with no shuffles) and B = the V tile, MN-major (kv rows with
//     D contiguous) through the descriptor's transpose bit. ptxas serialises
//     a run of in-flight wgmmas if one of them reads a register A written
//     inside the run (C7513), so P is written completely before the tile's
//     P V wgmmas are issued.
//   * Epilogue: O = acc / l rounded once to bf16, written into the
//     warpgroup's own Q rows in shared memory (Q is no longer read; the
//     32-byte swizzle keeps the 4-byte stores conflict-free), then one TMA
//     store per box, clipped at T and D. L is stored (B, H, T) f32.
//   * Shared memory at D = 160: BN = 64 and up to 4 stages,
//     200 KB with the Q tile. Registers: a consumer thread holds
//     BN / 2 S accumulators, DP / 2 O accumulators and BN / 4 packed P
//     registers (at most 160 at D = 128); the consumers run at 232 after
//     setmaxnreg. mbarrier phases: the producer waits each
//     stage's `empty` barrier from parity 1 (a fresh barrier's previous
//     phase counts as complete), the consumers its `full` barrier from
//     parity 0; one arrival per consumer warp releases a stage.
//
// Left for later: FA3's ping-pong (one warpgroup's softmax overlapping
// the other's GEMMs, scheduled with named barriers), intra-warpgroup
// pipelining of the next tile's Q K^T under this tile's softmax, persistent
// tiles, fp8, and the backward pair on this pipeline. Each warpgroup here
// runs Q K^T, softmax and P V in turn; the two warpgroups of a CTA overlap
// only as the warp schedulers interleave them.
//
// Entry point: flash_fwd_wgmma(...) below, a plain C function for ctypes.
// It encodes the four TMA tensor maps on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: sm90.cuh), launches on the given
// stream and returns cudaGetLastError() after the launch; it does not
// synchronise and allocates nothing.

#include <math.h>

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BOX = 16;             // columns per TMA box: one k16 step, 32-byte rows
constexpr int BM_MAX = 128;         // q rows per CTA with two consumer warpgroups
constexpr int MAX_DP = 160;         // the widest D (rounded up to 16) instantiated
constexpr float NEG_INIT = -1e30f;  // running-max init, as the Pallas kernel
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Cfg {
  static constexpr int KB = DP / BOX;                  // boxes per row
  static constexpr int BN = DP <= 128 ? 128 : 64;      // kv rows per stage
  static constexpr int BOX_Q = BM_MAX * BOX;           // elements of one Q box
  static constexpr int BOX_KV = BN * BOX;              // elements of one K or V box
  static constexpr int STAGE_BYTES = 2 * KB * BOX_KV * 2;
  // TMA ring depth: what shared memory holds beside the Q tile (and 1024
  // bytes of alignment slack, 256 of barriers), at most 4
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - KB * BOX_Q * 2) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(DP % BOX == 0 && DP <= MAX_DP && STAGES >= 2, "tile");
};

// Shared memory of one CTA from a 1024-byte aligned base. Every box is a
// multiple of 256 bytes, the 32-byte swizzle's period, so each box and each
// warpgroup's 64 rows inside it start on that period.
template <int DP>
struct Smem {
  using C = Cfg<DP>;
  __nv_bfloat16 q[C::KB][C::BOX_Q];  // Q boxes (BM rows), then O for the store
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Launched with (nc + 1) * 128 threads: nc = 1 or 2 consumer warpgroups
// (BM = 64 * nc q rows), then the producer warpgroup.
template <int DP>
__global__ void __launch_bounds__((BM_MAX / 64 + 1) * 128, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const __grid_constant__ CUtensorMap tmap_o,
                           float* __restrict__ lse, int H, int T, int S, float scale) {
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
      mbar_expect_tx(&s.q_full, KB * 64 * nc * BOX * 2);
      for (int kb = 0; kb < KB; ++kb) tma_load_4d(s.q[kb], &tmap_q, &s.q_full, kb * BOX, q0, h, b);
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
    // the warpgroup's 64, columns 8i + 2t and 8i + 2t + 1 of each n8 block i
    const int g = lane >> 2, t = lane & 3;
    const uint32_t bar_id = 1 + wg;  // this warpgroup's named barrier

    // Q pre-scaled in f32 and rounded to bf16, in place: each thread one
    // 16-byte chunk of the warpgroup's 64 rows of each box
    mbar_wait(&s.q_full, 0);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      uint4* p = reinterpret_cast<uint4*>(s.q[kb] + wg * 64 * BOX) + tid;
      uint4 x = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        w[i] = pack_bf16(f.x * scale, f.y * scale);
      }
      *p = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");

    // descriptors (32-byte swizzle: 8-row groups of 32-byte rows, 256 bytes
    // apart): Q and K K-major, box kb one k16 step further; V MN-major, 16
    // kv rows (512 bytes) per k16 step, its boxes BOX_KV elements apart
    const uint64_t dq = smem_desc(s.q[0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
    constexpr uint32_t Q_STEP = C::BOX_Q * 2 / 16;  // descriptor units (16 bytes)
    constexpr uint32_t KV_STEP = C::BOX_KV * 2 / 16;
    float acc_s[BN / 2];
    float o[DP / 2];
    uint32_t p[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc_s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INIT, m1 = NEG_INIT;  // rows g and g + 8
    float l0 = 0.f, l1 = 0.f;            // this thread's part of the row sums
    int stage = 0;
    uint32_t phase = 0;

    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&s.full[stage], phase);
      // S = Q K^T
      const uint64_t dk = smem_desc(s.k[stage][0], 16, 256, DESC_SWIZZLE_32B);
      fence_regs(acc_s);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) wgmma_ss(acc_s, dq + kb * Q_STEP, dk + kb * KV_STEP, kb);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);

      // the ragged S tail: columns >= S of the last tile to -inf
      const int valid = S - j * BN;
      if (valid < BN) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = 8 * i + 2 * t;
          if (col >= valid) acc_s[4 * i] = acc_s[4 * i + 2] = -INFINITY;
          if (col + 1 >= valid) acc_s[4 * i + 1] = acc_s[4 * i + 3] = -INFINITY;
        }
      }
      // online softmax of rows g and g + 8
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(acc_s[4 * i], acc_s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(acc_s[4 * i + 2], acc_s[4 * i + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float corr0 = ex2((m0 - mx0) * LOG2E);
      const float corr1 = ex2((m1 - mx1) * LOG2E);
      m0 = mx0;
      m1 = mx1;
      const float ms0 = mx0 * LOG2E, ms1 = mx1 * LOG2E;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        acc_s[4 * i] = ex2(fmaf(acc_s[4 * i], LOG2E, -ms0));
        acc_s[4 * i + 1] = ex2(fmaf(acc_s[4 * i + 1], LOG2E, -ms0));
        acc_s[4 * i + 2] = ex2(fmaf(acc_s[4 * i + 2], LOG2E, -ms1));
        acc_s[4 * i + 3] = ex2(fmaf(acc_s[4 * i + 3], LOG2E, -ms1));
        rs0 += acc_s[4 * i] + acc_s[4 * i + 1];
        rs1 += acc_s[4 * i + 2] + acc_s[4 * i + 3];
      }
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= corr0;
        o[4 * i + 1] *= corr0;
        o[4 * i + 2] *= corr1;
        o[4 * i + 3] *= corr1;
      }
      // P in bf16: n8 blocks 2kt and 2kt + 1 of S are the A fragment of k16
      // slice kt (rows g, g + 8; columns 2t and 2t + 8 of the slice)
#pragma unroll
      for (int kt = 0; kt < BN / 16; ++kt) {
        p[4 * kt] = pack_bf16(acc_s[8 * kt], acc_s[8 * kt + 1]);
        p[4 * kt + 1] = pack_bf16(acc_s[8 * kt + 2], acc_s[8 * kt + 3]);
        p[4 * kt + 2] = pack_bf16(acc_s[8 * kt + 4], acc_s[8 * kt + 5]);
        p[4 * kt + 3] = pack_bf16(acc_s[8 * kt + 6], acc_s[8 * kt + 7]);
      }
      fence_u32(p);  // every A register is written before the wgmmas start

      // O += P V
      const uint64_t dv = smem_desc(s.v[stage][0], C::BOX_KV * 2, 256, DESC_SWIZZLE_32B);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BN / 16; ++kt) wgmma_rs<1>(o, p + 4 * kt, dv + kt * (16 * 32 / 16), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_u32(p);
      if (lane == 0) mbar_arrive(&s.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: O = acc / l in bf16 into this warpgroup's Q rows (32-byte
    // swizzle: 16-byte chunk c of row r at c ^ ((r >> 2) & 1)), then a TMA
    // store per box, clipped at T and D; L = m + log(l)
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");  // Q reads are done
    const int r0 = warp * 16 + g;
    const int row_off = (wg * 64 + r0) * 32 + 4 * t;
    const int swz = (r0 >> 2) & 1;  // the same for r0 + 8
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      uint8_t* box = reinterpret_cast<uint8_t*>(s.q[i >> 1]) + row_off + (((i & 1) ^ swz) << 4);
      *reinterpret_cast<uint32_t*>(box) = pack_bf16(o[4 * i] / l0, o[4 * i + 1] / l0);
      *reinterpret_cast<uint32_t*>(box + 8 * 32) = pack_bf16(o[4 * i + 2] / l1, o[4 * i + 3] / l1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (tid == 0) {
      for (int kb = 0; kb < KB; ++kb)
        tma_store_4d(&tmap_o, s.q[kb] + wg * 64 * BOX, kb * BOX, q0 + wg * 64, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (t == 0) {
      float* L = lse + (long long)blockIdx.y * T;
      const int row = q0 + wg * 64 + r0;
      if (row < T) L[row] = m0 + logf(l0);
      if (row + 8 < T) L[row + 8] = m1 + logf(l1);
    }
    if (tid == 0) {  // the stores have read shared memory before the CTA exits
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
    e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes<DP>);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int DP>
cudaError_t launch(EncodeTiled fn, const void* q, const void* k, const void* v, void* o,
                   float* lse, const long long* st, int B, int H, int T, int S, int D, int bm,
                   float scale, cudaStream_t stream) {
  const cudaError_t e = prepare<DP>();
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv, to;
  if (!encode_bhtd(fn, &tq, q, st, B, H, T, D, bm) ||
      !encode_bhtd(fn, &tk, k, st + 3, B, H, S, D, Cfg<DP>::BN) ||
      !encode_bhtd(fn, &tv, v, st + 6, B, H, S, D, Cfg<DP>::BN) ||
      !encode_bhtd(fn, &to, o, st + 9, B, H, T, D, 64)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((T + bm - 1) / bm, B * H);
  flash_fwd_wgmma_kernel<DP><<<grid, (bm / 64 + 1) * 128, kSmemBytes<DP>, stream>>>(
      tq, tk, tv, to, lse, H, T, S, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o bf16 with a unit last stride; strides: 12 element strides,
// (batch, head, row) for q, k, v, o, each positive and a multiple of 8 (TMA's
// 16-byte global strides); 16-byte aligned bases; lse (B, H, T) f32
// contiguous. bm: q rows per CTA, 64 or 128. Returns a cudaError_t:
// cudaErrorInvalidValue for what the kernel does not take (the wrapper
// routes those calls to flash_fwd.cu first) or a map that cannot be encoded.
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                               const long long* strides, int B, int H, int T, int S, int D,
                               int bm, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1 || S < 1 || D < 8 || D > MAX_DP || D % 8 != 0 ||
      (long long)B * H > 65535 || (bm != 64 && bm != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 12; ++i) {
    if (strides[i] <= 0 || strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  float* L = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + BOX - 1) / BOX * BOX) {
#define FLASH_WGMMA_CASE(DP_) \
  case DP_:                   \
    return (int)launch<DP_>(fn, q, k, v, o, L, strides, B, H, T, S, D, bm, scale, st);
    FLASH_WGMMA_CASE(16)
    FLASH_WGMMA_CASE(32)
    FLASH_WGMMA_CASE(48)
    FLASH_WGMMA_CASE(64)
    FLASH_WGMMA_CASE(80)
    FLASH_WGMMA_CASE(96)
    FLASH_WGMMA_CASE(112)
    FLASH_WGMMA_CASE(128)
    FLASH_WGMMA_CASE(144)
    FLASH_WGMMA_CASE(160)
#undef FLASH_WGMMA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
