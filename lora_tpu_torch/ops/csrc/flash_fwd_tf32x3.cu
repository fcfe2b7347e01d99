// Flash-attention forward for Hopper (sm_90a), f32, non-causal:
//     O = softmax(Q~ K^T) V,   L = rowwise logsumexp(Q~ K^T)
// for q (B, H, T, D) and k, v (B, H, S, D) in f32, Q~ = f32(q) * scale;
// O f32 in q's layout, L f32 (B, H, T) in the natural log: what the
// backward kernels read. Every product runs on the tensor cores as 3xTF32:
// each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// A B becomes A_hi B_hi + A_hi B_lo + A_lo B_hi, three tf32 wgmmas into one
// f32 accumulator, erring by about 2^-21 of the sum of the terms'
// magnitudes, as an f32 FMA chain does. Nothing is rounded to a lower dtype.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/flash_attention.py::_fwd_kernel
// (:104-132, driven by _fwd :135-171) for f32 inputs, which runs its dots at
// Precision.HIGHEST (_prec :51-57: true f32 contractions; plain TF32, with
// 10 mantissa bits, would not compute that), and computes what it and
// ops/flash_attention.py::flash_attention_reference compute: the running
// max m, the running sum l and the accumulator in f32, O = acc / l,
// L = m + log(l). flash_fwd.cu (mma.sync, CUDA-core FMAs for f32) serves
// what this kernel does not take: D > MAX_DP and strides of 0
// (ops/flash_attention.py _fwd_route picks the kernel from dtype, D and
// layout alone).
//
// What bounds it on an H100 at the SD-1.5 serving shape (B = 4, H = 8,
// T = S = 4096, D = 40): two products per score (Q~ K^T and P V), each as
// three tf32 products: 3 * 4*B*H*T*S*D = 257.7 GFLOP, 0.521 ms at 494.7
// TFLOP/s dense TF32. B*H*T*S = 537 M exponentials, ~0.13 ms. The bytes (q,
// k, v read once, O and L written once: ~84 MB) are 0.025 ms. The tensor
// cores set the floor.
//
// Design (flash_bwd_dq_tf32x3.cu's pipeline; what the forward changes is
// marked):
//   * One CTA per (BM q rows, head), looping over every kv tile; nothing
//     carries between CTAs and nothing is atomic. BM = 64 per consumer
//     warpgroup, 1 or 2 of them, chosen per launch on the host
//     (ops/flash_attention.py _fwd_tf32x3_bm: 128 where the instance holds
//     it and that leaves no SM idle).
//   * The split is made here, after TMA lands (the backward kernels read a
//     split the wrapper forms, ~25 small launches a call). TMA loads q, k
//     and v as they are through 4-D f32 tensor maps (cols, rows, H, B) built
//     from each tensor's strides, so the UNet's transposed views are read,
//     and O written, in place with no copy. Warp 0 of the producer
//     warpgroup issues every load: q once per CTA, then K and V per kv tile
//     into a ring of STAGES stages. Warps 1-3 of that warpgroup, the
//     splitters, turn each landed tile into the operands, in place in the
//     same stage. Three mbarriers per stage: `loaded` (TMA's bytes),
//     `full` (every splitter thread has fenced its stores for the async
//     proxy, fence.proxy.async, and arrived) and `empty` (every consumer
//     warp is done; the TMA thread waits on it). Every tile is 8-column
//     boxes (32-byte rows, the 32-byte swizzle): one box per k8 step of a
//     tf32 wgmma, D = 40 exactly 5 boxes.
//   * The splits. The tensor cores read a tf32 operand's f32 bit pattern
//     with its low 13 mantissa bits ignored (truncated). Q~ = q * scale in
//     f32, then hi = rna(Q~) and lo = rna(Q~ - hi) (round to nearest, ties
//     away, done as an integer add and and: bit for bit cvt.rna.tf32.f32
//     and the wrapper's _split_tf32(_q_tilde(q, scale))), hi over q in
//     place and lo beside it, once per CTA. K needs no hi: K as it landed
//     is read as trunc(K), and the splitters write lo = K - trunc(K) (exact
//     in f32; truncated in turn when read, so K = hi + lo to 2^-21 |K|). V
//     and P: hi = rna(x), lo = x - hi (exact, unrounded: truncated when
//     read, x = hi + lo to 2^-22 |x|). The splitters' cost was the kernel's
//     bottleneck: they share the SM's issue slots and shared memory with
//     the consumers, so what they save (a K copy, two integer operations an
//     element, rounding on the conversion unit) the kernel saves.
//   * tf32: .tf32 wgmma is m64nNk8 and has no transpose bits, so both
//     shared-memory operands are K-major. S = Q~ K^T reads K as it is (D
//     innermost). O += P V needs kv innermost: V^T, (D rows, kv columns) per
//     tile, with kv permuted within each group of 8 by
//     pi = [0, 2, 4, 6, 1, 3, 5, 7] (k position p holds kv row pi(p)). The
//     splitters move each 8x8 block (kv x D) of a tile: lane (p, m2) reads
//     columns 2 m2, 2 m2 + 1 of kv row pi(p) in one 8-byte load and writes
//     V^T's rows 2 m2 and 2 m2 + 1, column p, the lanes with m2 >= 2 the
//     second first, so each load and store falls on distinct banks.
//   * Consumer warpgroups own 64 q rows each. Per kv tile: S (3 x DP/8
//     wgmma m64nBNk8, both operands from shared memory); the last tile's
//     columns >= S to -inf; the online softmax on the fragments (a row lives
//     in the 4 threads of a quad: the tile's row max over the quad, m, corr =
//     exp2((m_old - m) log2(e)), P = exp2(S log2(e) - m log2(e)), one FFMA
//     and one ex2.approx a score, l = l corr + this thread's row sum, summed
//     over the quad once, at the end). The accumulator gives each thread
//     columns (2t, 2t + 1) of every 8-column group; the tf32 register-A
//     fragment wants k = t and t + 4. With pi, k position t is kv column 2t
//     and t + 4 is 2t + 1, so the A registers of group i are the accumulator
//     registers (d0, d2, d1, d3) of that group, with no data movement; each
//     is split into hi and lo in registers, all of them before the run of
//     wgmmas that reads them (a register A written inside a run serialises
//     it: ptxas C7513). Then P V (3 x BN/8 wgmma m64nDPk8, A from registers,
//     B the V^T boxes) into a per-tile accumulator (scale-d 0) that is folded
//     into O with round-to-nearest FFMAs, O = O corr + tile: the tensor
//     cores' own f32 accumulation is not round-to-nearest, and left to sum
//     all of S its errors add up in one direction (flash_bwd_dkv_tf32x3.cu
//     found this). The stage is released once that product is waited for.
//   * Ragged tails. q rows past T are TMA's zero fill (S = 0, finite); the
//     store clips them, and L is written for rows < T only. K and V rows
//     past S are zero too; their scores (0) would count in m and l, so the
//     last tile's columns >= S are masked to -inf before the max (P = 0).
//   * Shared memory: Q~ hi and lo take 8 * BM_MAX * DP bytes, a stage
//     20 * BN * DP (K, K lo, V, V^T hi and lo): BM_MAX = 128 up to DP = 128,
//     64 above; BN = 64 up to DP = 40, 32 up to 88, 16 above; the ring as
//     deep as fits, at most 4 (3 at DP = 40, 2 at 80 and 160).
//   * Registers: per consumer thread BN / 2 scores, BN / 2 hi and BN / 2 lo
//     registers of P, DP / 2 of the tile's product and DP / 2 of O: ~170 at
//     DP = 40, BN = 64 and ~210 at DP = 160, BN = 16, under the 224 the
//     consumers hold after setmaxnreg (the producer warpgroup keeps 56: the
//     splitters need more than a TMA thread's 40).
//   * Epilogue: O = acc / l in f32 into the warpgroup's own Q~ hi rows in
//     shared memory (no longer read), then one TMA store per box, clipped at
//     T; L = m + log(l) with logf (L's limit is 1e-5).
//
// Left for later: the next kv tile's S under this tile's P V, ping-pong of
// the two consumer warpgroups, the same in-kernel split in the three tf32x3
// backward kernels.
//
// Entry point: flash_fwd_tf32x3(...) below, a plain C function for ctypes.
// It encodes the four TMA tensor maps on the host (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPoint: sm90.cuh), launches on the given stream
// and returns cudaGetLastError() after the launch; it does not synchronise
// and allocates nothing.

#include <math.h>

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BOX = 8;          // f32 columns per TMA box: one k8 step, 32-byte rows
constexpr int MAX_DP = 160;     // the widest D instantiated (a multiple of 8)
constexpr int SPLITTERS = 96;   // warps 1-3 of the producer warpgroup
constexpr float NEG_INIT = -1e30f;  // running-max init, as the Pallas kernel
constexpr float LOG2E = 1.4426950408889634f;
constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

template <int DP>
struct Cfg {
  static constexpr int KB = DP / BOX;                            // boxes per row
  static constexpr int BM_MAX = DP <= 128 ? 128 : 64;            // q rows a CTA can hold
  static constexpr int BN = DP <= 40 ? 64 : DP <= 88 ? 32 : 16;  // kv rows per stage
  static constexpr int NB = BN / BOX;         // k8 steps of P V per tile
  static constexpr int BOX_Q = BM_MAX * BOX;  // elements of one Q~ box
  static constexpr int BOX_KV = BN * BOX;     // of one K or V box (kv rows)
  static constexpr int BOX_T = DP * BOX;      // of one V^T box (D rows)
  static constexpr int Q_BYTES = 2 * KB * BOX_Q * 4;    // Q~ hi, lo
  static constexpr int LOAD_BYTES = 2 * BN * DP * 4;    // K, V as TMA lands them
  static constexpr int STAGE_BYTES = 5 * BN * DP * 4;   // K, K lo, V, V^T hi, lo
  // ring depth: what shared memory holds beside Q~ (and 1024 bytes of
  // alignment slack, 256 of barriers), at most 4
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - Q_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(DP % BOX == 0 && DP <= MAX_DP && STAGES >= 2, "tile");
};

// Shared memory of one CTA from a 1024-byte aligned base. Every box is a
// multiple of 256 bytes, the 32-byte swizzle's period, so each box and each
// warpgroup's 64 rows inside it start on that period.
template <int DP>
struct Smem {
  using C = Cfg<DP>;
  float q[2][C::KB][C::BOX_Q];  // q as it lands, then Q~ hi over it; Q~ lo; O in q[0]
  float k[C::STAGES][2][C::KB][C::BOX_KV];   // K as it lands (its own hi), K lo
  float v[C::STAGES][C::KB][C::BOX_KV];      // V as it lands
  float vt[C::STAGES][2][C::NB][C::BOX_T];  // V^T hi, lo (pi-permuted kv)
  uint64_t loaded[C::STAGES];  // TMA -> splitters
  uint64_t full[C::STAGES];    // splitters -> consumers
  uint64_t empty[C::STAGES];   // consumers -> TMA
  uint64_t q_full;
  uint64_t q_split;
};

template <int DP>
constexpr size_t kSmemBytes = sizeof(Smem<DP>) + 1024;  // + alignment slack

// The four tensor maps: q, k, v as they are, then O
struct Maps {
  CUtensorMap q, k, v, o;
};

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

// x rounded to tf32 as an f32 bit pattern whose low 13 bits are zero: to
// nearest, ties away from zero, as cvt.rna.tf32.f32 (and the wrapper's
// _rna_tf32), but in two integer operations (an add and an and), which
// issue at 4x the rate of the conversion unit the cvt takes
__device__ __forceinline__ uint32_t rna_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + e with hi = tf32(x), lo = tf32(x - hi): split_tf32 of
// sm90.cuh, bit for bit, on the integer units (Q~, once per CTA)
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_int(x);
  lo = rna_int(x - __uint_as_float(hi));
}

// The split of V and P: hi = tf32(x), lo = x - hi exact in f32 and left
// unrounded. The tensor cores read a tf32 operand's f32 bit pattern with its
// low 13 mantissa bits ignored (truncated), so lo enters the product as
// trunc(x - hi), within 2^-11 of |x - hi| <= 2^-11 |x|: x = hi + lo to
// 2^-22 |x|, as with a rounded lo
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_int(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The lo of K, whose hi is K itself as TMA lands it (the tensor cores
// truncate it to tf32): x - trunc(x), exact in f32, truncated in turn when
// read, so x = hi + lo to 2^-21 |x|
__device__ __forceinline__ float rest_trunc(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// 4 f32 values split into tf32 hi and lo (split_rn), as f32 bit patterns
__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  uint32_t h, l;
  split_rn(x.x, h, l);
  hi.x = __uint_as_float(h);
  lo.x = __uint_as_float(l);
  split_rn(x.y, h, l);
  hi.y = __uint_as_float(h);
  lo.y = __uint_as_float(l);
  split_rn(x.z, h, l);
  hi.z = __uint_as_float(h);
  lo.z = __uint_as_float(l);
  split_rn(x.w, h, l);
  hi.w = __uint_as_float(h);
  lo.w = __uint_as_float(l);
}

// Launched with (nc + 1) * 128 threads: nc = 1 or 2 consumer warpgroups
// (BM = 64 * nc q rows), then the producer warpgroup (warp 0 TMA, warps 1-3
// the splitters).
template <int DP>
__global__ void __launch_bounds__(3 * 128, 1)
    flash_fwd_tf32x3_kernel(const __grid_constant__ Maps m, float* __restrict__ lse, int H,
                            int T, int S, float scale) {
  using C = Cfg<DP>;
  constexpr int KB = C::KB;
  constexpr int BN = C::BN;
  constexpr int NB = C::NB;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Smem<DP>& s = *reinterpret_cast<Smem<DP>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int nc = blockDim.x / 128 - 1;
  const int bm = 64 * nc;
  const int q0 = blockIdx.x * bm;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int n_tiles = (S + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.loaded[i], 1);        // the TMA thread's expect_tx arrival
      mbar_init(&s.full[i], SPLITTERS);  // every splitter has written its part
      mbar_init(&s.empty[i], nc * 4);    // one arrival per consumer warp
    }
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_split, SPLITTERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == nc) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int ptid = threadIdx.x - nc * 128;
    if (ptid == 0) {
      // warp 0: one thread issues every TMA load; the full boxes are
      // counted even where TMA zero-fills past the edge
      mbar_expect_tx(&s.q_full, KB * bm * BOX * 4);
      for (int kb = 0; kb < KB; ++kb) tma_load_4d(s.q[0][kb], &m.q, &s.q_full, kb * BOX, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        uint64_t* bar = &s.loaded[stage];
        mbar_expect_tx(bar, C::LOAD_BYTES);
        for (int kb = 0; kb < KB; ++kb) {
          tma_load_4d(s.k[stage][0][kb], &m.k, bar, kb * BOX, j * BN, h, b);
          tma_load_4d(s.v[stage][kb], &m.v, bar, kb * BOX, j * BN, h, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (ptid >= 32) {
      // warps 1-3: the splitters
      const int sid = ptid - 32;  // 0 .. SPLITTERS - 1
      const int sw = sid >> 5;    // splitter warp
      const int lane = sid & 31;

      // Q~ = q * scale in f32, hi in place over q, lo beside it: the bm
      // landed rows of each box, 4 elements a step (elementwise: the
      // swizzle stays as TMA wrote it)
      mbar_wait(&s.q_full, 0);
      const int q4 = bm * BOX / 4;
      for (int i = sid; i < KB * q4; i += SPLITTERS) {
        const int kb = i / q4;
        const int e = (i - kb * q4) * 4;
        float4* hp = reinterpret_cast<float4*>(s.q[0][kb] + e);
        float4 x = *hp;
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
        float4 hi, lo;
        split4(x, hi, lo);
        *hp = hi;
        *reinterpret_cast<float4*>(s.q[1][kb] + e) = lo;
      }
      fence_proxy_async();
      mbar_arrive(&s.q_split);

      // per kv tile: K lo (elementwise: the swizzle stays) and V^T hi, lo,
      // 8x8 blocks (kv x D) at a time. Lane (p, m2) of a block reads
      // columns 2 m2 and 2 m2 + 1 of V's kv row pi(p) (one 8-byte load; a
      // 16-byte chunk c of row r of a box sits at chunk c ^ ((r >> 2) & 1))
      // and writes V^T's rows 2 m2 + e', column p; the lanes with m2 >= 2
      // take their second column first, so that each store's 32 lanes fall
      // on 32 banks (rows 0, 2, 5, 7, then 1, 3, 4, 6)
      const int p = lane & 7;
      const int m2 = lane >> 3;
      const int o = ((p & 3) << 1) | (p >> 2);  // pi(p)
      const int first = m2 >> 1;                // the column stored first
      const int src = o * BOX + ((((m2 >> 1) ^ (o >> 2)) & 1) << 2) + ((m2 & 1) << 1);
      int dst[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * m2 + (e ^ first);
        dst[e] = r * BOX + ((((p >> 2) ^ (r >> 2)) & 1) << 2) + (p & 3);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(&s.loaded[stage], phase);
        const float4* kx = reinterpret_cast<const float4*>(s.k[stage][0][0]);
        float4* kl = reinterpret_cast<float4*>(s.k[stage][1][0]);
        for (int i = sid; i < KB * C::BOX_KV / 4; i += SPLITTERS) {
          const float4 x = kx[i];
          kl[i] = make_float4(rest_trunc(x.x), rest_trunc(x.y), rest_trunc(x.z), rest_trunc(x.w));
        }
#pragma unroll 2
        for (int blk = sw; blk < NB * KB; blk += SPLITTERS / 32) {
          const int nb = blk / KB;
          const int kb = blk - nb * KB;
          const float2 x2 = *reinterpret_cast<const float2*>(s.v[stage][kb] + 8 * nb * BOX + src);
          float* vh = s.vt[stage][0][nb] + 8 * kb * BOX;
          float* vl = s.vt[stage][1][nb] + 8 * kb * BOX;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint32_t hi, lo;
            split_fast((e ^ first) ? x2.y : x2.x, hi, lo);
            vh[dst[e]] = __uint_as_float(hi);
            vl[dst[e]] = __uint_as_float(lo);
          }
        }
        fence_proxy_async();
        mbar_arrive(&s.full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // accumulator fragments: warp w holds rows 16w + g and 16w + g + 8 of
    // the warpgroup's 64 q rows, columns 8i + 2t and 8i + 2t + 1 of each n8
    // block i (kv columns of the tile for S, D for P V)
    const int g = lane >> 2, t = lane & 3;
    const uint32_t bar_id = 1 + wg;  // this warpgroup's named barrier
    const int r0 = warp * 16 + g;

    // descriptors (32-byte swizzle: 8-row groups of 32-byte rows, 256 bytes
    // apart), all K-major: Q~ hi / lo as the A of S, box kb one k8 step
    // further; K as its B; V^T as the B of P V, box nb one k8 step (8 kv
    // rows) further
    constexpr uint32_t Q_STEP = C::BOX_Q * 4 / 16;  // descriptor units (16 bytes)
    constexpr uint32_t KV_STEP = C::BOX_KV * 4 / 16;
    constexpr uint32_t T_STEP = C::BOX_T * 4 / 16;
    uint64_t qa[2];
#pragma unroll
    for (int x = 0; x < 2; ++x)
      qa[x] = smem_desc(s.q[x][0] + wg * 64 * BOX, 16, 256, DESC_SWIZZLE_32B);
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INIT, m1 = NEG_INIT;  // rows r0 and r0 + 8
    float l0 = 0.f, l1 = 0.f;            // this thread's part of the row sums
    int stage = 0;
    uint32_t phase = 0;

    mbar_wait(&s.q_split, 0);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&s.full[stage], phase);
      uint64_t kd[2];  // K as it landed (read as its tf32 hi), K lo
#pragma unroll
      for (int x = 0; x < 2; ++x) kd[x] = smem_desc(s.k[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
      // S = Q~ K^T: hi.hi, hi.lo, lo.hi per k8 step. The accumulators are
      // fresh each tile: the first wgmma's scale-d 0 ignores them.
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        wgmma_ss_tf32(sc, qa[0] + kb * Q_STEP, kd[0] + kb * KV_STEP, kb);
        wgmma_ss_tf32(sc, qa[0] + kb * Q_STEP, kd[1] + kb * KV_STEP, 1);
        wgmma_ss_tf32(sc, qa[1] + kb * Q_STEP, kd[0] + kb * KV_STEP, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // the ragged S tail: columns >= S of the last tile to -inf
      const int valid = S - j * BN;
      if (valid < BN) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = 8 * i + 2 * t;
          if (col >= valid) sc[4 * i] = sc[4 * i + 2] = -INFINITY;
          if (col + 1 >= valid) sc[4 * i + 1] = sc[4 * i + 3] = -INFINITY;
        }
      }
      // online softmax of rows r0 and r0 + 8
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
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
        sc[4 * i] = ex2(fmaf(sc[4 * i], LOG2E, -ms0));
        sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], LOG2E, -ms0));
        sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], LOG2E, -ms1));
        sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], LOG2E, -ms1));
        rs0 += sc[4 * i] + sc[4 * i + 1];
        rs1 += sc[4 * i + 2] + sc[4 * i + 3];
      }
      l0 = fmaf(l0, corr0, rs0);
      l1 = fmaf(l1, corr1, rs1);

      // P as tf32 register-A fragments, hi and lo: the k8 step i takes
      // accumulator registers (d0, d2, d1, d3) of n8 block i (pi)
      uint32_t ph[BN / 2], pl[BN / 2];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int src = 4 * i + ((r & 1) << 1) + (r >> 1);  // 0, 2, 1, 3
          split_fast(sc[src], ph[4 * i + r], pl[4 * i + r]);
        }
      }
      fence_u32(ph);  // every A register is written before the wgmmas start
      fence_u32(pl);

      // this tile's P V (B: the V^T boxes) into a fresh accumulator, folded
      // into O with round-to-nearest FFMAs
      uint64_t vd[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) vd[x] = smem_desc(s.vt[stage][x][0], 16, 256, DESC_SWIZZLE_32B);
      float acc[DP / 2];
      wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        wgmma_rs_tf32(acc, ph + 4 * nb, vd[0] + nb * T_STEP, nb);
        wgmma_rs_tf32(acc, ph + 4 * nb, vd[1] + nb * T_STEP, 1);
        wgmma_rs_tf32(acc, pl + 4 * nb, vd[0] + nb * T_STEP, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] = fmaf(o[4 * i], corr0, acc[4 * i]);
        o[4 * i + 1] = fmaf(o[4 * i + 1], corr0, acc[4 * i + 1]);
        o[4 * i + 2] = fmaf(o[4 * i + 2], corr1, acc[4 * i + 2]);
        o[4 * i + 3] = fmaf(o[4 * i + 3], corr1, acc[4 * i + 3]);
      }
      fence_u32(ph);
      fence_u32(pl);
      if (lane == 0) mbar_arrive(&s.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: O = acc / l in f32 into this warpgroup's Q~ hi rows (32-byte
    // swizzle: 16-byte chunk c of row r at c ^ ((r >> 2) & 1)), then a TMA
    // store per box, clipped at T; L = m + log(l)
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");  // Q~ reads are done
    const int swz = (r0 >> 2) & 1;  // the same for r0 + 8
    const int off = (wg * 64 + r0) * 32 + (((t >> 1) ^ swz) << 4) + ((t & 1) << 3);
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      uint8_t* qx = reinterpret_cast<uint8_t*>(s.q[0][i]) + off;
      *reinterpret_cast<float2*>(qx) = make_float2(o[4 * i] / l0, o[4 * i + 1] / l0);
      *reinterpret_cast<float2*>(qx + 8 * 32) = make_float2(o[4 * i + 2] / l1, o[4 * i + 3] / l1);
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (tid == 0) {
      for (int kb = 0; kb < KB; ++kb)
        tma_store_4d(&m.o, s.q[0][kb] + wg * 64 * BOX, kb * BOX, q0 + wg * 64, h, b);
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
    e = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<DP>,
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
  if (bm > Cfg<DP>::BM_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = prepare<DP>();
  if (e != cudaSuccess) return e;
  static_assert(kSmemBytes<DP> <= SMEM_MAX, "shared memory");
  Maps m;
  if (!encode_bhtd(fn, &m.q, q, st, B, H, T, D, bm, F32) ||
      !encode_bhtd(fn, &m.k, k, st + 3, B, H, S, D, Cfg<DP>::BN, F32) ||
      !encode_bhtd(fn, &m.v, v, st + 6, B, H, S, D, Cfg<DP>::BN, F32) ||
      !encode_bhtd(fn, &m.o, o, st + 9, B, H, T, D, 64, F32)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((T + bm - 1) / bm, B * H);
  flash_fwd_tf32x3_kernel<DP><<<grid, (bm / 64 + 1) * 128, kSmemBytes<DP>, stream>>>(
      m, lse, H, T, S, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o f32 with a unit last stride; strides: 12 element strides,
// (batch, head, row) for q, k, v, o, each positive and a multiple of 4
// (TMA's 16-byte global strides); 16-byte aligned bases; lse (B, H, T) f32
// contiguous. bm: q rows per CTA, 64 or 128 (128 only where D <= 128).
// scale: the softmax scale, applied to q in f32 before the split. Returns a
// cudaError_t: cudaErrorInvalidValue for what the kernel does not take (the
// wrapper routes those calls to flash_fwd.cu first) or a map that cannot be
// encoded.
extern "C" int flash_fwd_tf32x3(const void* q, const void* k, const void* v, void* o, void* lse,
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
    if (strides[i] <= 0 || strides[i] % 4 != 0) return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  float* L = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define FWD_TF32X3_CASE(DP_) \
  case DP_:                  \
    return (int)launch<DP_>(fn, q, k, v, o, L, strides, B, H, T, S, D, bm, scale, st);
    FWD_TF32X3_CASE(8)
    FWD_TF32X3_CASE(16)
    FWD_TF32X3_CASE(24)
    FWD_TF32X3_CASE(32)
    FWD_TF32X3_CASE(40)
    FWD_TF32X3_CASE(48)
    FWD_TF32X3_CASE(56)
    FWD_TF32X3_CASE(64)
    FWD_TF32X3_CASE(72)
    FWD_TF32X3_CASE(80)
    FWD_TF32X3_CASE(88)
    FWD_TF32X3_CASE(96)
    FWD_TF32X3_CASE(104)
    FWD_TF32X3_CASE(112)
    FWD_TF32X3_CASE(120)
    FWD_TF32X3_CASE(128)
    FWD_TF32X3_CASE(136)
    FWD_TF32X3_CASE(144)
    FWD_TF32X3_CASE(152)
    FWD_TF32X3_CASE(160)
#undef FWD_TF32X3_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The instance that takes head dim D: out = {DP, BN, STAGES, dynamic shared
// memory bytes, BM_MAX}. Returns 0, or cudaErrorInvalidValue for a D no
// instance takes.
extern "C" int flash_fwd_tf32x3_config(int D, int* out) {
  switch (D) {
#define FWD_TF32X3_CONFIG(DP_)     \
  case DP_:                        \
    out[0] = DP_;                  \
    out[1] = Cfg<DP_>::BN;         \
    out[2] = Cfg<DP_>::STAGES;     \
    out[3] = (int)kSmemBytes<DP_>; \
    out[4] = Cfg<DP_>::BM_MAX;     \
    return 0;
    FWD_TF32X3_CONFIG(8)
    FWD_TF32X3_CONFIG(16)
    FWD_TF32X3_CONFIG(24)
    FWD_TF32X3_CONFIG(32)
    FWD_TF32X3_CONFIG(40)
    FWD_TF32X3_CONFIG(48)
    FWD_TF32X3_CONFIG(56)
    FWD_TF32X3_CONFIG(64)
    FWD_TF32X3_CONFIG(72)
    FWD_TF32X3_CONFIG(80)
    FWD_TF32X3_CONFIG(88)
    FWD_TF32X3_CONFIG(96)
    FWD_TF32X3_CONFIG(104)
    FWD_TF32X3_CONFIG(112)
    FWD_TF32X3_CONFIG(120)
    FWD_TF32X3_CONFIG(128)
    FWD_TF32X3_CONFIG(136)
    FWD_TF32X3_CONFIG(144)
    FWD_TF32X3_CONFIG(152)
    FWD_TF32X3_CONFIG(160)
#undef FWD_TF32X3_CONFIG
  }
  return (int)cudaErrorInvalidValue;
}
