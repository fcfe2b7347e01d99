// Flash-attention dK/dV backward for Hopper (sm_90a), bf16, non-causal:
//     dV = sum_i bf16(P_i)^T dO_i,     dK = sum_i bf16(dS_i)^T Q~_i
// with Q~ = bf16(f32(q) * scale) formed by the wrapper before the launch,
// P = exp(Q~ K^T - L) in f32 from the forward's f32 logsumexp L, and
// dS = P o (dO V^T - delta) formed from the f32 P, delta = rowsum(dO o O)
// in f32 (the wrapper's). Q~, dO (B, H, T, D) and K, V (B, H, S, D) bf16;
// dK and dV come back in bf16 in k's and v's layouts, each rounded once.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel (:210-255, driven by _bwd :302-332) for bf16 inputs, and
// computes what it computes: the products in bf16 with f32 sums, P rounded
// to bf16 for dV, dS rounded to bf16 for dK, dK with no further scale (Q~ is
// already scaled: _bwd forms qf = _scale_q(q, scale) in XLA before its
// kernels, :270, and so does the wrapper here). flash_bwd.cu's
// flash_bwd_dkv (mma.sync) serves what this kernel does not take: f32,
// D > MAX_DP, strides of 0 (ops/flash_attention.py _bwd_route picks the
// kernel from dtype, D and layout alone).
//
// What bounds it on an H100 at the SD-1.5 training shape (B = 1, H = 8,
// T = S = 4096, D = 40): four products per score (S^T, dP^T, dV, dK),
// 8*B*H*T*S*D = 43 GFLOP, 0.043 ms at 989 TFLOP/s (0.052 at D padded to
// 48); B*H*T*S = 134 M exponentials, 0.032 ms at 16 a clock per SM. The
// bytes (q, k, v, dO, L and delta read once, dK and dV written once:
// ~16 MB) are 0.005 ms. The tensor cores set the floor, the exponential
// unit close behind.
//
// Design (the transposed image of flash_fwd_wgmma.cu: kv rows take the
// place of q rows):
//   * One CTA per (BN kv rows, head), looping over every q tile; nothing
//     carries between CTAs and nothing is atomic. BN = 64 per consumer
//     warpgroup, 1 or 2 of them, chosen per launch on the host
//     (ops/flash_attention.py _dkv_bn: 128 unless that leaves SMs idle).
//   * Producer warpgroup (setmaxnreg gives its registers away): one thread
//     issues every TMA load, K and V once per CTA, then Q~ and dO tiles of
//     BQ q rows through a ring of up to 4 stages with a `full` and an
//     `empty` mbarrier each; one warp stages L * log2(e) and delta of the
//     stage's q rows (0 past T) with plain loads and arrives on the same
//     `full` barrier. 4-D tensor maps (D, rows, H, B) from each tensor's
//     strides, so the UNet's transposed views are read, and dK, dV
//     written, in place. Every tile is 16-column boxes with 32-byte rows
//     and the 32-byte swizzle (D = 40 runs as 48 by TMA's zero fill, 80 and
//     160 unpadded), one box per k16 step of S^T and dP^T and per
//     16-column atom of the MN-major B operands.
//   * Consumer warpgroups own 64 kv rows each. Per q tile: S^T = K Q~^T and
//     dP^T = V dO^T (wgmma m64nBQk16, both operands K-major in shared
//     memory) as two commit groups; P^T = exp2(S^T * log2(e) - L * log2(e))
//     on the fragments of the first (one FFMA and one ex2.approx a score,
//     L per column) while the second runs; dS^T = P^T o (dP^T - delta) in
//     f32; both packed to bf16 as register-A fragments (the f32
//     accumulator layout re-packs with no shuffles, as the forward's P).
//     Then dV += P^T dO and dK += dS^T Q~ (wgmma m64nDPk16, A from
//     registers, dO and Q~ MN-major through the transpose bit: LBO = the
//     box stride, SBO = 256 bytes), the stage released once they are
//     waited for. ptxas serialises a run of in-flight wgmmas if one of
//     them reads a register A written inside the run (C7513), so P^T and
//     dS^T are packed completely before the run.
//   * Q~ rows past T are TMA's zero fill, and their L and delta are staged
//     as 0: P = 1 there against dO = 0 and delta = 0, so dS = 0 and those
//     rows add nothing to dV or dK. kv rows past S give rows that the
//     store clips.
//   * Registers: per consumer thread, BQ / 2 S^T and BQ / 2 dP^T
//     accumulators, declared inside the q loop and never read before their
//     first wgmma (scale-d 0), so nothing keeps them live across tiles;
//     DP / 2 dK and DP / 2 dV accumulators; BQ / 4 packed P^T and dS^T
//     registers each. BQ shrinks as D grows (128 up to DP = 64, 64 up to
//     128, then 32) so the peak, the two score tiles beside dK and dV,
//     stays under the 232 registers the consumers hold after setmaxnreg.
//   * Epilogue: dK and dV rounded once to bf16 into the warpgroup's own K
//     and V rows in shared memory (no longer read), then one TMA store per
//     box, clipped at S and D.
//
// Left for later: issuing the next q tile's S^T under this tile's dV/dK
// products, ping-pong of the two consumer warpgroups, and dQ on this
// pipeline (still flash_bwd.cu's mma.sync kernel).
//
// Entry point: flash_bwd_dkv_wgmma(...) below, a plain C function for
// ctypes. It encodes the six TMA tensor maps on the host
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: sm90.cuh),
// launches on the given stream and returns cudaGetLastError() after the
// launch; it does not synchronise and allocates nothing.

#include <math.h>

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BOX = 16;      // columns per TMA box: one k16 step, 32-byte rows
constexpr int BN_MAX = 128;  // kv rows per CTA with two consumer warpgroups
constexpr int MAX_DP = 160;  // the widest D (rounded up to 16) instantiated
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Cfg {
  static constexpr int KB = DP / BOX;                              // boxes per row
  static constexpr int BQ = DP <= 64 ? 128 : (DP <= 128 ? 64 : 32);  // q rows per stage
  static constexpr int BOX_KV = BN_MAX * BOX;  // elements of one K or V box
  static constexpr int BOX_Q = BQ * BOX;       // elements of one Q~ or dO box
  static constexpr int STAGE_BYTES = 2 * KB * BOX_Q * 2;  // what TMA brings per stage
  // ring depth: what shared memory holds beside K and V (and 1024 bytes of
  // alignment slack, 256 of barriers), at most 4
  static constexpr int FIT =
      (SMEM_MAX - 1024 - 256 - 2 * KB * BOX_KV * 2) / (STAGE_BYTES + 2 * BQ * 4);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(DP % BOX == 0 && DP <= MAX_DP && STAGES >= 2, "tile");
};

// Shared memory of one CTA from a 1024-byte aligned base. Every box is a
// multiple of 256 bytes, the 32-byte swizzle's period, so each box and each
// warpgroup's 64 rows inside it start on that period.
template <int DP>
struct Smem {
  using C = Cfg<DP>;
  __nv_bfloat16 k[C::KB][C::BOX_KV];  // K boxes (BN rows), then dK for the store
  __nv_bfloat16 v[C::KB][C::BOX_KV];  // V boxes, then dV
  __nv_bfloat16 q[C::STAGES][C::KB][C::BOX_Q];  // Q~
  __nv_bfloat16 o[C::STAGES][C::KB][C::BOX_Q];  // dO
  float lse[C::STAGES][C::BQ];                  // L * log2(e); 0 past T
  float dlt[C::STAGES][C::BQ];                  // delta; 0 past T
  uint64_t full[C::STAGES];
  uint64_t empty[C::STAGES];
  uint64_t kv_full;
};

template <int DP>
constexpr size_t kSmemBytes = sizeof(Smem<DP>) + 1024;  // + alignment slack

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Launched with (nc + 1) * 128 threads: nc = 1 or 2 consumer warpgroups
// (BN = 64 * nc kv rows), then the producer warpgroup.
template <int DP>
__global__ void __launch_bounds__((BN_MAX / 64 + 1) * 128, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                               const __grid_constant__ CUtensorMap tmap_k,
                               const __grid_constant__ CUtensorMap tmap_v,
                               const __grid_constant__ CUtensorMap tmap_do,
                               const __grid_constant__ CUtensorMap tmap_dk,
                               const __grid_constant__ CUtensorMap tmap_dv,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, int H, int T) {
  using C = Cfg<DP>;
  constexpr int KB = C::KB;
  constexpr int BQ = C::BQ;
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
      mbar_expect_tx(&s.kv_full, 2 * KB * 64 * nc * BOX * 2);
      for (int kb = 0; kb < KB; ++kb)
        tma_load_4d(s.k[kb], &tmap_k, &s.kv_full, kb * BOX, kv0, h, b);
      for (int kb = 0; kb < KB; ++kb)
        tma_load_4d(s.v[kb], &tmap_v, &s.kv_full, kb * BOX, kv0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        mbar_expect_tx(&s.full[stage], C::STAGE_BYTES);
        for (int kb = 0; kb < KB; ++kb)
          tma_load_4d(s.q[stage][kb], &tmap_q, &s.full[stage], kb * BOX, j * BQ, h, b);
        for (int kb = 0; kb < KB; ++kb)
          tma_load_4d(s.o[stage][kb], &tmap_do, &s.full[stage], kb * BOX, j * BQ, h, b);
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
    // n8 block i (q rows of the tile for S^T and dP^T, D for dK and dV)
    const int g = lane >> 2, t = lane & 3;
    const uint32_t bar_id = 1 + wg;  // this warpgroup's named barrier

    // descriptors (32-byte swizzle: 8-row groups of 32-byte rows, 256 bytes
    // apart): K, V, and Q~, dO as the B of S^T and dP^T, K-major, box kb one
    // k16 step further; Q~ and dO as the B of dK and dV, MN-major, 16 q rows
    // (512 bytes) per k16 step, their boxes BOX_Q elements apart
    const uint64_t dk_a = smem_desc(s.k[0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
    const uint64_t dv_a = smem_desc(s.v[0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
    constexpr uint32_t KV_STEP = C::BOX_KV * 2 / 16;  // descriptor units (16 bytes)
    constexpr uint32_t Q_STEP = C::BOX_Q * 2 / 16;
    constexpr uint32_t ROW16 = 16 * 32 / 16;  // 16 rows of one box
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;

    mbar_wait(&s.kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&s.full[stage], phase);
      // S^T = K Q~^T and dP^T = V dO^T, two commit groups. The accumulators
      // are fresh each tile: the first k-step's scale-d 0 ignores them.
      float st[BQ / 2], dpt[BQ / 2];
      const uint64_t q_b = smem_desc(s.q[stage][0], 16, 256, DESC_SWIZZLE_32B);
      const uint64_t o_b = smem_desc(s.o[stage][0], 16, 256, DESC_SWIZZLE_32B);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) wgmma_ss(st, dk_a + kb * KV_STEP, q_b + kb * Q_STEP, kb);
      wgmma_commit();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) wgmma_ss(dpt, dv_a + kb * KV_STEP, o_b + kb * Q_STEP, kb);
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
      // dS^T = P^T o (dP^T - delta) from the f32 P^T
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
      // P^T and dS^T in bf16: n8 blocks 2kt and 2kt + 1 are the A fragment
      // of k16 slice kt (rows g, g + 8; columns 2t and 2t + 8 of the slice)
      uint32_t p[BQ / 4], ds[BQ / 4];
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p[4 * kt + r] = pack_bf16(st[8 * kt + 2 * r], st[8 * kt + 2 * r + 1]);
          ds[4 * kt + r] = pack_bf16(dpt[8 * kt + 2 * r], dpt[8 * kt + 2 * r + 1]);
        }
      }
      fence_u32(p);  // every A register is written before the wgmmas start
      fence_u32(ds);

      // dV += P^T dO and dK += dS^T Q~
      const uint64_t o_mn = smem_desc(s.o[stage][0], C::BOX_Q * 2, 256, DESC_SWIZZLE_32B);
      const uint64_t q_mn = smem_desc(s.q[stage][0], C::BOX_Q * 2, 256, DESC_SWIZZLE_32B);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt) wgmma_rs<1>(dv, p + 4 * kt, o_mn + kt * ROW16, 1);
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt) wgmma_rs<1>(dk, ds + 4 * kt, q_mn + kt * ROW16, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_u32(p);
      fence_u32(ds);
      if (lane == 0) mbar_arrive(&s.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: dK and dV in bf16 into this warpgroup's K and V rows
    // (32-byte swizzle: 16-byte chunk c of row r at c ^ ((r >> 2) & 1)),
    // then a TMA store per box, clipped at S and D
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");  // K, V reads are done
    const int r0 = warp * 16 + g;
    const int row_off = (wg * 64 + r0) * 32 + 4 * t;
    const int swz = (r0 >> 2) & 1;  // the same for r0 + 8
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int off = row_off + (((i & 1) ^ swz) << 4);
      uint8_t* kx = reinterpret_cast<uint8_t*>(s.k[i >> 1]) + off;
      uint8_t* vx = reinterpret_cast<uint8_t*>(s.v[i >> 1]) + off;
      *reinterpret_cast<uint32_t*>(kx) = pack_bf16(dk[4 * i], dk[4 * i + 1]);
      *reinterpret_cast<uint32_t*>(kx + 8 * 32) = pack_bf16(dk[4 * i + 2], dk[4 * i + 3]);
      *reinterpret_cast<uint32_t*>(vx) = pack_bf16(dv[4 * i], dv[4 * i + 1]);
      *reinterpret_cast<uint32_t*>(vx + 8 * 32) = pack_bf16(dv[4 * i + 2], dv[4 * i + 3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (tid == 0) {
      for (int kb = 0; kb < KB; ++kb)
        tma_store_4d(&tmap_dk, s.k[kb] + wg * 64 * BOX, kb * BOX, kv0 + wg * 64, h, b);
      for (int kb = 0; kb < KB; ++kb)
        tma_store_4d(&tmap_dv, s.v[kb] + wg * 64 * BOX, kb * BOX, kv0 + wg * 64, h, b);
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
    e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes<DP>);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int DP>
cudaError_t launch(EncodeTiled fn, const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, const long long* st,
                   int B, int H, int T, int S, int D, int bn, cudaStream_t stream) {
  const cudaError_t e = prepare<DP>();
  if (e != cudaSuccess) return e;
  constexpr int BQ = Cfg<DP>::BQ;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!encode_bhtd(fn, &tq, q, st, B, H, T, D, BQ) ||
      !encode_bhtd(fn, &tk, k, st + 3, B, H, S, D, bn) ||
      !encode_bhtd(fn, &tv, v, st + 6, B, H, S, D, bn) ||
      !encode_bhtd(fn, &tdo, dout, st + 9, B, H, T, D, BQ) ||
      !encode_bhtd(fn, &tdk, dk, st + 12, B, H, S, D, 64) ||
      !encode_bhtd(fn, &tdv, dv, st + 15, B, H, S, D, 64)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((S + bn - 1) / bn, B * H);
  flash_bwd_dkv_wgmma_kernel<DP><<<grid, (bn / 64 + 1) * 128, kSmemBytes<DP>, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, lse, delta, H, T);
  return cudaGetLastError();
}

}  // namespace

// q is Q~ = bf16(f32(q) * scale), formed by the caller; k, v, dout, dk, dv
// bf16 with a unit last stride. strides: 18 element strides, (batch, head,
// row) for q, k, v, dout, dk, dv, each positive and a multiple of 8 (TMA's
// 16-byte global strides); 16-byte aligned bases. lse and delta: (B, H, T)
// f32 contiguous. bn: kv rows per CTA, 64 or 128. scale is not read (Q~
// carries it); it keeps the argument list of the other flash entry points.
// Returns a cudaError_t: cudaErrorInvalidValue for what the kernel does not
// take (the wrapper routes those calls to flash_bwd.cu first) or a map that
// cannot be encoded.
extern "C" int flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   const long long* strides, int B, int H, int T, int S, int D,
                                   int bn, float scale, void* stream) {
  (void)scale;
  if (B < 1 || H < 1 || T < 1 || S < 1 || D < 8 || D > MAX_DP || D % 8 != 0 ||
      (long long)B * H > 65535 || (bn != 64 && bn != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 18; ++i) {
    if (strides[i] <= 0 || strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + BOX - 1) / BOX * BOX) {
#define DKV_WGMMA_CASE(DP_) \
  case DP_:                 \
    return (int)launch<DP_>(fn, q, k, v, dout, L, Dl, dk, dv, strides, B, H, T, S, D, bn, st);
    DKV_WGMMA_CASE(16)
    DKV_WGMMA_CASE(32)
    DKV_WGMMA_CASE(48)
    DKV_WGMMA_CASE(64)
    DKV_WGMMA_CASE(80)
    DKV_WGMMA_CASE(96)
    DKV_WGMMA_CASE(112)
    DKV_WGMMA_CASE(128)
    DKV_WGMMA_CASE(144)
    DKV_WGMMA_CASE(160)
#undef DKV_WGMMA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The instance that takes head dim D: out = {DP, BQ, STAGES, dynamic shared
// memory bytes}. Returns 0, or cudaErrorInvalidValue for a D no instance
// takes.
extern "C" int flash_bwd_dkv_wgmma_config(int D, int* out) {
  if (D < 8 || D > MAX_DP || D % 8 != 0) return (int)cudaErrorInvalidValue;
  switch ((D + BOX - 1) / BOX * BOX) {
#define DKV_WGMMA_CONFIG(DP_)                                                          \
  case DP_:                                                                            \
    out[0] = DP_;                                                                      \
    out[1] = Cfg<DP_>::BQ;                                                             \
    out[2] = Cfg<DP_>::STAGES;                                                         \
    out[3] = (int)kSmemBytes<DP_>;                                                     \
    return 0;
    DKV_WGMMA_CONFIG(16)
    DKV_WGMMA_CONFIG(32)
    DKV_WGMMA_CONFIG(48)
    DKV_WGMMA_CONFIG(64)
    DKV_WGMMA_CONFIG(80)
    DKV_WGMMA_CONFIG(96)
    DKV_WGMMA_CONFIG(112)
    DKV_WGMMA_CONFIG(128)
    DKV_WGMMA_CONFIG(144)
    DKV_WGMMA_CONFIG(160)
#undef DKV_WGMMA_CONFIG
  }
  return (int)cudaErrorInvalidValue;
}
