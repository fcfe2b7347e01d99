// Int8-weight matrix product for Hopper (sm_90a), the bf16 route:
//     out[m, n] = bf16( scale[n] * sum_k x[m, k] * bf16(wq[n, k]) )
// for x (M, K) bf16, wq (N, K) int8 with a per-output-channel f32 scale (N,),
// out (M, N) bf16; f32 accumulation.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/int8_matmul.py::_kernel
// (driven by int8_matmul), for bf16 x. It computes the same function: the
// int8 weight is widened to bf16 on chip (exact: |q| <= 127), the products
// are summed in f32, and the scale multiplies the f32 accumulator once
// before the single rounding to bf16. The weight is read from device memory
// as int8 bytes; no bf16 copy of W is ever made. int8_matmul.cu (mma.sync)
// serves what this kernel does not take: f32 x, K % 16 != 0, N % 8 != 0
// and base pointers that are not 16-byte aligned (ops/int8_matmul.py
// _route picks the kernel from those facts alone).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 2*M*N*K FLOPs
// against 2*M*K + N*K + 2*M*N bytes. At the UNet's large shapes it is
// compute (the tensor cores' issue rate); at the 64x64 level's narrow
// products, e.g. (16384, 320, 2560), the 84 MB bf16 output costs as much as
// the math; at M <= 308 (CLIP, cross-attention k/v, time_emb_proj) it is
// the int8 weight bytes and the launch latency.
//
// Design, and what each part does about that:
//   * The product is computed transposed, out^T = W x^T, so that the int8
//     weight is wgmma's A operand, which may come from registers: each
//     consumer thread loads its A fragment's int8 bytes from shared memory
//     (32-bit loads, conflict-free under the 64-byte swizzle) and widens
//     them in registers. No widened copy of W is written to shared memory,
//     so there is no proxy fence and no barrier between the consumer
//     warpgroups in the main loop, and the tensor cores' shared-memory
//     reads are x's alone. (Widening W into a swizzled bf16 buffer for an
//     all-shared-memory wgmma was tried first: its stores, fence and
//     barrier sat on every K step's critical path; PERF.md §6.)
//   * Warp specialisation. One producer warpgroup, in which one thread
//     issues every TMA load (setmaxnreg gives its registers to the
//     consumers), and one or two consumer warpgroups, each owning 64 rows of
//     W (output columns) and up to 256 rows of x (output rows), issuing
//     wgmma.mma_async m64nBMk16 (A bf16 in registers, B the x tile in shared
//     memory, f32 accumulators in registers): the path to Hopper's full
//     tensor-core rate.
//   * A TMA ring of up to 8 stages (as many as shared memory holds), each
//     the x tile (BM x 64 bf16, with the 128-byte swizzle that the B
//     descriptor names) and the int8 W tile (BN x 64 bytes, 64-byte
//     swizzle), with a `full` and an `empty` mbarrier each. TMA zero-fills
//     rows past M and N and columns past K, so ragged edges cost no masking
//     on load and nothing is padded.
//   * Widening on chip, the step no library GEMM has: integer and f32 bit
//     work (2^23 + u in an f32, minus 2^23 + 128), not the slow int-to-float
//     converter, 6 instructions per pair of weights. ptxas serialises the
//     wgmmas of a run of in-flight wgmmas if one of them reads a register A
//     written inside that run, so a warpgroup cannot keep two K steps
//     queued. It issues a step's 4 wgmmas, loads and widens the next step's
//     A into the other of two register sets while they run, then waits for
//     them (wait_group 0) and releases their stage; the two consumer
//     warpgroups interleave on the tensor cores. A warpgroup widens 64 x 64
//     weights per K step (~120 instructions a thread) whatever BM is, which
//     is what bounds the step at BM <= 128: BM = 256 gives the tensor cores
//     the most work per widened weight.
//   * A persistent tile loop: grid = min(tiles, SMs), each CTA walks tiles
//     blockIdx.x + i * gridDim.x, M fastest inside an N column (a W column
//     stays in L2). The producer runs ahead into the next tile's stages
//     while the consumers do this tile's epilogue; the ring's phases carry
//     across tiles.
//   * The tile (BM x rows, BN W rows) is chosen per launch on the host
//     (ops/int8_matmul.py _tile, a time model fit to this kernel on an
//     H100) from six instances: BN = 64 (one consumer warpgroup) or 128
//     (two), BM = 64, 128 or 256.
//   * Epilogue, per consumer warpgroup: acc * scale[n] in f32 (two scales a
//     thread, loaded at the tile's start), one rounding to bf16, transposed
//     into a staged output tile
//     in shared memory by stmatrix .trans (128-byte swizzle: no bank
//     conflicts), then one TMA store that clips at M and N and drains while
//     the next tile's main loop runs. At the 64x64 level the 84 MB output is
//     the bound: stores from registers took twice the whole math.
//
// Left for later: split-K for long-K small-M shapes (a few tiles walking K
// = 3072-5120 alone), clusters with TMA multicast of the shared x / W
// tiles, and f32 x (TMA cannot round f32 to bf16 on load; int8_matmul.cu
// takes it).
//
// Entry point: int8_matmul_wgmma(...) below, a plain C function for ctypes.
// It encodes the three TMA descriptors on the host (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so nothing links against
// libcuda), launches on the given stream and returns cudaGetLastError()
// after the launch; it does not synchronise and allocates nothing.

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BK = 64;  // one 128-byte bf16 row of x per K step

// The output tile BM (rows of x) x BN (rows of W): one consumer warpgroup
// per 64 rows of W, each over all BM rows of x (the n of its wgmma). A
// warpgroup widens 64 x 64 weights per K step whatever BM is, so BM = 256
// gives the tensor cores the most work per widened weight.
template <int BM, int BN>
struct Tile {
  static constexpr int NC = BN / 64;  // consumer warpgroups
  static constexpr int STAGE_BYTES = BM * BK * 2 + BN * BK;
  // TMA ring depth: what shared memory holds beside the staged output tile
  // (and 1024 bytes of alignment slack, 256 of barriers), at most 8
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - 2 * BM * BN) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static_assert(NC <= 2 && BM % 16 == 0 && BM <= 256 && STAGES >= 2, "tile");
};

// Shared memory of one CTA, from a 1024-byte aligned base: the 128-byte
// swizzle repeats every 8 rows of 128 bytes, so the x tiles and each
// warpgroup's output staging start on that period (their sizes are
// multiples of 1024 bytes), and the W tiles on the 64-byte swizzle's 512.
template <int BM, int BN>
struct Smem {
  static constexpr int S = Tile<BM, BN>::STAGES;
  __nv_bfloat16 x[S][BM * BK];  // TMA, 128-byte swizzle
  // the output tile for the TMA stores: per consumer warpgroup BM rows of
  // its 64 output columns (128-byte rows, 128-byte swizzle)
  __nv_bfloat16 out[BM * BN];
  int8_t w[S][BN * BK];  // TMA, 64-byte rows, 64-byte swizzle
  uint64_t full[S];
  uint64_t empty[S];
};

__device__ __forceinline__ uint32_t lds_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two int8 of the word w (bytes p and p + 1, picked by sel0 = 0x7650 + p and
// sel1 = sel0 + 1) to two bf16 in one word, the first in the low half,
// exactly: u = q + 128 (the sign bit flipped) sits in the low byte of the
// f32 2^23 + u; subtracting 2^23 + 128 leaves q, an integer of at most 8
// significant bits, so the top half of its f32 bits is its bf16.
__device__ __forceinline__ uint32_t widen2(uint32_t w, uint32_t sel0, uint32_t sel1) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel0)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// Four 8x8 b16 matrices, each in the accumulator's fragment layout (lane
// holds row lane / 4, columns 2 * (lane % 4) and + 1), stored transposed:
// lanes 8i .. 8i + 7 give the addresses of matrix i's stored rows, each the
// 16 bytes of one fragment column
__device__ __forceinline__ void stmatrix_x4_trans(uint8_t* p, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

template <int BM, int BN>
constexpr int kThreads = (Tile<BM, BN>::NC + 1) * 128;

template <int BM, int BN>
constexpr size_t kSmemBytes = sizeof(Smem<BM, BN>) + 1024;  // + alignment slack

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads<BM, BN>, 1)
    int8_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                      const __grid_constant__ CUtensorMap tmap_w,
                      const __grid_constant__ CUtensorMap tmap_out,
                      const float* __restrict__ scale, int M, int N, int K) {
  using T = Tile<BM, BN>;
  constexpr int NC = T::NC;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Smem<BM, BN>& s = *reinterpret_cast<Smem<BM, BN>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int m_tiles = (M + BM - 1) / BM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int k_steps = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);        // the producer's expect_tx arrival
      mbar_init(&s.empty[i], NC * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NC * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM;
        const int n0 = (tile / m_tiles) * BN;
        for (int kb = 0; kb < k_steps; ++kb) {
          mbar_wait(&s.empty[stage], phase ^ 1);
          // the full box is counted even where TMA zero-fills past the edge
          mbar_expect_tx(&s.full[stage], T::STAGE_BYTES);
          tma_load(s.x[stage], &tmap_x, &s.full[stage], kb * BK, m0);
          tma_load(s.w[stage], &tmap_w, &s.full[stage], kb * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: widen W into registers, wgmma, epilogue ----
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    // A fragment (m64 x k16, warp i rows 16i .. 16i + 15): lane holds rows
    // g and g + 8, columns 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3)
    const int g = lane >> 2, t = lane & 3;
    const int w_row = wg * 64 + warp * 16 + g;  // and w_row + 8
    // 64-byte swizzle: 16-byte chunk kk of row r at kk ^ ((r >> 1) & 3),
    // which is g >> 1 for both rows; the lane's bytes 2t, 2t + 1 of a chunk
    // are bytes 2 (t & 1), + 1 of its word t >> 1, and + 8 of word 2 + t >> 1
    const int swz = g >> 1;
    const int w_off = w_row * 64 + 4 * (t >> 1);
    const uint32_t sel0 = 0x7650u + 2 * (t & 1), sel1 = sel0 + 1;
    float acc[BM / 2];
    uint32_t a0[16], a1[16];  // the A fragments of two K steps
    int stage = 0;
    uint32_t phase = 0;

    // load and widen this thread's A fragments of one K step from the
    // stage's W tile, once TMA has filled the stage
    auto load_a = [&](uint32_t(&a)[16]) {
      mbar_wait(&s.full[stage], phase);
      const uint8_t* w = reinterpret_cast<const uint8_t*>(s.w[stage]) + w_off;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint8_t* c = w + ((kk ^ swz) << 4);
        a[4 * kk + 0] = widen2(lds_u32(c), sel0, sel1);
        a[4 * kk + 1] = widen2(lds_u32(c + 8 * 64), sel0, sel1);
        a[4 * kk + 2] = widen2(lds_u32(c + 8), sel0, sel1);
        a[4 * kk + 3] = widen2(lds_u32(c + 8 * 64 + 8), sel0, sel1);
      }
      fence_u32(a);  // every A register is written before the wgmmas start
    };
    // one K step: 4 wgmmas on the stage's x tile; while they run, the next
    // step's A fragments are loaded into the other register set; then wait
    // for the wgmmas and release the stage
    auto k_step = [&](uint32_t(&a)[16], uint32_t(&next_a)[16], bool more) {
      wgmma_fence();
      const uint64_t db = smem_desc(s.x[stage], 16, 1024, DESC_SWIZZLE_128B);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // 16 bf16 further along K: 32 bytes, 2 in the descriptor's units
        wgmma_rs<0>(acc, a + 4 * kk, db + 2 * kk, 1);
      }
      wgmma_commit();
      const int done = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      if (more) load_a(next_a);
      wgmma_wait<0>();
      fence_u32(a);
      if (lane == 0) mbar_arrive(&s.empty[done]);
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * BM;
      const int n0 = (tile / m_tiles) * BN;
      // this tile's scales, for accumulator rows (output columns) g and
      // g + 8 of this warp, loaded while the main loop runs
      const int n = n0 + w_row;
      const float s0 = n < N ? __ldg(scale + n) : 0.f;
      const float s1 = n + 8 < N ? __ldg(scale + n + 8) : 0.f;
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      load_a(a0);
      for (int kb = 0; kb < k_steps; kb += 2) {
        k_step(a0, a1, kb + 1 < k_steps);
        if (kb + 1 < k_steps) k_step(a1, a0, kb + 2 < k_steps);
      }
      fence_regs(acc);

      // epilogue, per warpgroup: acc * scale[n] in f32, one rounding to
      // bf16, transposed into this warpgroup's staged output (BM rows of 64
      // columns), then a TMA store that clips at M and N and drains while
      // the next tile runs
      uint8_t* staged = reinterpret_cast<uint8_t*>(s.out) + wg * BM * 128;
      const bool leader = tid == 0;
      if (leader) {  // the previous tile's store has read the staging
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      // stmatrix x4 over two 8-column blocks jb, jb + 1 of the accumulator
      // (x rows): matrix i is (rows g + 8 (i & 1), block jb + i / 2); lane
      // gives the address of its matrix's stored row lane % 8, that is x row
      // 8 (jb + i / 2) + lane % 8, at the 16-byte chunk of output columns
      // 16 warp + 8 (i & 1), swizzled by the row
      const int i = lane >> 3, j = lane & 7;
      const int chunk = (2 * warp + (i & 1)) ^ j;
#pragma unroll
      for (int jb = 0; jb < BM / 8; jb += 2) {
        const int xr = 8 * (jb + (i >> 1)) + j;
        stmatrix_x4_trans(staged + xr * 128 + (chunk << 4),
                          pack_bf16(acc[4 * jb + 0] * s0, acc[4 * jb + 1] * s0),
                          pack_bf16(acc[4 * jb + 2] * s1, acc[4 * jb + 3] * s1),
                          pack_bf16(acc[4 * jb + 4] * s0, acc[4 * jb + 5] * s0),
                          pack_bf16(acc[4 * jb + 6] * s1, acc[4 * jb + 7] * s1));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      if (leader) {
        tma_store(&tmap_out, staged, n0 + wg * 64, m0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) {  // the last store completes before the CTA exits
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
}

constexpr int MAX_DEVICES = 64;

// The device's SM count, and the instance's shared-memory limit raised on
// that device, once per process (the launch path runs ~9,000 times per
// request at M <= 308, where the host's time is the kernel's)
template <int BM, int BN>
cudaError_t prepare(int* sms) {
  static int sm_count[MAX_DEVICES];  // 0: not prepared on that device yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(int8_wgmma_kernel<BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes<BM, BN>);
    if (e != cudaSuccess) return e;
    sm_count[dev] = n;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

template <int BM, int BN>
cudaError_t launch(EncodeTiled fn, const void* x, const void* wq, const float* scale, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = prepare<BM, BN>(&sms);
  if (e != cudaSuccess) return e;
  CUtensorMap tx, tw, to;
  if (!encode(fn, &tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BM, BK,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(fn, &tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, N, K, BN, BK,
              CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(fn, &to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, M, N, BM, 64,
              CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  int8_wgmma_kernel<BM, BN><<<grid, kThreads<BM, BN>, kSmemBytes<BM, BN>, stream>>>(
      tx, tw, to, scale, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, wq (N, K) int8, both contiguous with 16-byte aligned bases;
// scale (N,) f32; out (M, N) bf16, contiguous. (bm, bn) is one of the tile
// instances: bm in {64, 128, 256} rows of x, bn in {64, 128} rows of W.
// K % 16 == 0 and N % 8 == 0 (TMA's 16-byte global strides). Returns a
// cudaError_t: cudaErrorInvalidValue for what the kernel does not take (the
// wrapper routes those calls to int8_matmul.cu first) or a descriptor that
// cannot be encoded.
extern "C" int int8_matmul_wgmma(const void* x, const void* wq, const void* scale, void* out,
                                 int M, int N, int K, int bm, int bn, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 16 != 0 || N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT8_WGMMA_CASE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return (int)launch<BM_, BN_>(fn, x, wq, s, out, M, N, K, st);
  INT8_WGMMA_CASE(64, 64)
  INT8_WGMMA_CASE(128, 64)
  INT8_WGMMA_CASE(256, 64)
  INT8_WGMMA_CASE(64, 128)
  INT8_WGMMA_CASE(128, 128)
  INT8_WGMMA_CASE(256, 128)
#undef INT8_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}
