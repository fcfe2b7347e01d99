// Int8-weight matrix product for Hopper (sm_90a), the f32 route:
//     out[m, n] = f32( scale[n] * sum_k bf16_rne(x[m, k]) * bf16(wq[n, k]) )
// for x (M, K) f32, wq (N, K) int8 with a per-output-channel f32 scale (N,),
// out (M, N) f32; f32 accumulation, nothing rounded after the scale.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/int8_matmul.py::_kernel
// (:35-43, driven by int8_matmul :46-81) for f32 x. It computes the same
// function: x is rounded to bf16 to nearest, ties to even (bit for bit
// x.to(torch.bfloat16), as the plain version int8_matmul_reference does and
// as x_ref[...].astype(jnp.bfloat16) does on the TPU), the int8 weight is
// widened to bf16 on chip (exact: |q| <= 127), the products (exact in f32)
// are summed in f32, and the scale multiplies the f32 sum once. The weight
// is read from device memory as int8 bytes and x as f32: no bf16 copy of
// either is ever written to device memory. int8_matmul_wgmma.cu serves bf16
// x; int8_matmul.cu (mma.sync) what neither takes: K % 16 != 0, N % 8 != 0
// and base pointers that are not 16-byte aligned (ops/int8_matmul.py _route
// picks the kernel from dtype, shape and alignment alone).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 2*M*N*K FLOPs
// against 4*M*K + N*K + 4*M*N bytes. f32 x and out double those bytes
// against the bf16 route, so most of SD-1.5's shapes are bound by bytes:
// at the 64x64 level's (16384, 320, 2560) the 168 MB f32 output is three
// quarters of the 0.0566 ms bound. The M = 1024 products with K or N of
// 5120-10240 are bound by the tensor cores, and M <= 308 (CLIP,
// cross-attention k/v, time_emb_proj) by the int8 weight bytes and the
// launch latency.
//
// Design: int8_matmul_wgmma.cu's pipeline (its note has the reasons), with
// x landed as f32 and rounded to bf16 in shared memory by the consumers:
//   * The product is computed transposed, out^T = W x^T, so that the int8
//     weight is wgmma's A operand from registers: each consumer thread
//     loads its A fragment's int8 bytes from shared memory (64-byte
//     swizzle) and widens them in registers (widen2, 6 instructions a
//     pair). Two register sets alternate: a warpgroup issues a K step's 4
//     wgmma m64nBMk16 and, while they run, loads and widens the next step's
//     A into the other set, then waits for them (wait_group 0: a register A
//     written inside a run of in-flight wgmmas serialises the run, ptxas
//     C7513) and releases the stage. One or two consumer warpgroups of 64
//     W rows; a persistent tile loop, N fastest inside an M row: the CTAs
//     that run at once share their x rows, which stay in L2 while the f32
//     output streams through it (M fastest, as the bf16 kernel walks, read
//     all of x again in every wave: 1.6x the time at (16384, 1280, 320)).
//   * x lands as f32. TMA cannot round on load, so one thread of the
//     producer warpgroup TMA-loads each K step's f32 x as it is: two boxes
//     of BM rows x 32 columns (one 128-byte row each, the 128-byte swizzle),
//     with the int8 W tile (BN x 64 bytes, the 64-byte swizzle), into a ring
//     of stages with a `loaded` (TMA's bytes) and an `empty` (every consumer
//     warp is done) mbarrier each.
//   * The consumers round x to bf16 (cvt.rn.bf16x2.f32: to nearest, ties to
//     even, two values an instruction) into the BM x 64 bf16 tile of the
//     stage, 128-byte swizzled as the B descriptor reads it: the next step's
//     tile while this step's wgmmas run, beside the widening, every consumer
//     thread a 1 / (NC * 128) share (per 8 values two 16-byte loads, four
//     conversions, one 16-byte store; the 8 lanes of a quarter warp on 8
//     distinct bank groups), then fence.proxy.async and one named barrier
//     of the consumer warpgroups before the wgmmas that read it.
//     flash_fwd_tf32x3.cu's pattern, converter warps (warps 1-3 of the
//     producer warpgroup) with a `converted` mbarrier that the consumers
//     wait on, was built first: the converters' shared-memory traffic
//     competed with the consumers' without hiding under the wgmmas, and it
//     took 1.0-1.25x this kernel's time at SD-1.5's shapes (PERF.md §6;
//     chip_variants.py --int8-f32 rebuilds it). A build that loaded x
//     straight into registers, no f32 in shared memory, was no faster.
//   * A K tail (K % 64 != 0) is TMA's zero fill; where a step's second f32
//     box would lie wholly past K it is not loaded, and its bf16 columns are
//     written as zeros. Rows past M and N are zero-filled too and the
//     stores skip them, so nothing is padded.
//   * The ring: each stage holds the two f32 boxes, the bf16 tile and the W
//     tile (BM * 384 + BN * 64 bytes), as many stages as shared memory
//     holds, at most 8 (Tile<BM, BN>::STAGES): BM = 256 2 stages (208 KB at
//     BN = 128, 200 KB at 64), BM = 128 4 (224 and 208 KB), BM = 64 7 and 8
//     (224 and 224 KB).
//   * The tile (BM x rows, BN W rows) is chosen per launch on the host
//     (ops/int8_matmul.py _tile with _TILE_US_F32, a time model fit to this
//     kernel on an H100) from the six instances BM = 64, 128, 256 and
//     BN = 64, 128.
//   * Epilogue: f32 stored straight from the accumulators, acc * scale[n]
//     in f32 and no rounding after it. In this orientation the 8 lanes of a
//     lane quad's column hold 8 consecutive output columns (W rows 16 warp
//     + lane / 4) of one x row, so each st.global.f32 of a warp writes four
//     whole 32-byte sectors of out: no staging tile and no stmatrix (b16
//     only), which leaves shared memory to the ring. Stores clip at M and
//     N. The producer runs ahead into the next tile's stages meanwhile.
//   * The sum: each output is one f32 accumulator of the tensor cores over
//     all of K (up to 5,120 terms, 320 wgmma k16 steps), as in the mma.sync
//     kernel, which holds the f32 limit (1e-5 of the largest output) at
//     K = 5120 with 3.6e-6. No run of K steps is summed apart with FADDs.
//
// Left for later: split-K for long-K small-M shapes, a deeper ring at
// BM = 256 (2 stages), W tiles of 256 rows (x is read from L2 once per 128
// W rows today), the product computed as x W^T with x converted in
// registers and W widened into shared memory.
//
// Entry points: int8_matmul_wgmma_f32(...) below, a plain C function for
// ctypes. It encodes the two TMA descriptors on the host
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: sm90.cuh),
// launches on the given stream and returns cudaGetLastError() after the
// launch; it does not synchronise and allocates nothing.
// int8_matmul_wgmma_f32_config(bm, bn, out) reports an instance's ring
// depth and dynamic shared memory.

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int BK = 64;   // K per step: one 128-byte bf16 row of x
constexpr int BOX = 32;  // f32 columns per TMA box: one 128-byte row

template <int BM, int BN>
struct Tile {
  static constexpr int NC = BN / 64;  // consumer warpgroups
  static constexpr int X_BYTES = BM * BOX * 4;  // one f32 box
  static constexpr int STAGE_BYTES = BM * BK * 4 + BM * BK * 2 + BN * BK;
  // TMA ring depth: what shared memory holds beside 1024 bytes of
  // alignment slack and 256 of barriers, at most 8
  static constexpr int FIT = (SMEM_MAX - 1024 - 256) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static_assert(NC <= 2 && BM % 16 == 0 && BM <= 256 && STAGES >= 2, "tile");
};

// Shared memory of one CTA, from a 1024-byte aligned base: the 128-byte
// swizzle repeats every 8 rows of 128 bytes, so the f32 boxes and the bf16
// tiles start on that period (their sizes are multiples of 1024 bytes),
// and the W tiles on the 64-byte swizzle's 512.
template <int BM, int BN>
struct Smem {
  static constexpr int S = Tile<BM, BN>::STAGES;
  float xf[S][2][BM * BOX];      // TMA, 128-byte swizzle: columns 0-31, 32-63
  __nv_bfloat16 xb[S][BM * BK];  // x rounded to bf16, 128-byte swizzle
  int8_t w[S][BN * BK];          // TMA, 64-byte rows, 64-byte swizzle
  uint64_t loaded[S];
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

template <int BM, int BN>
constexpr int kThreads = (Tile<BM, BN>::NC + 1) * 128;

template <int BM, int BN>
constexpr size_t kSmemBytes = sizeof(Smem<BM, BN>) + 1024;  // + alignment slack

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads<BM, BN>, 1)
    int8_wgmma_f32_kernel(const __grid_constant__ CUtensorMap tmap_x,
                          const __grid_constant__ CUtensorMap tmap_w,
                          const float* __restrict__ scale, float* __restrict__ out, int M,
                          int N, int K) {
  using T = Tile<BM, BN>;
  constexpr int NC = T::NC;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Smem<BM, BN>& s = *reinterpret_cast<Smem<BM, BN>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = n_tiles * ((M + BM - 1) / BM);
  const int k_steps = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  // a tile's first x row and first W row: N fastest inside an M row
  auto tile_m0 = [&](int tile) { return (tile / n_tiles) * BM; };
  auto tile_n0 = [&](int tile) { return (tile % n_tiles) * BN; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.loaded[i], 1);      // the TMA thread's expect_tx arrival
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
        const int m0 = tile_m0(tile);
        const int n0 = tile_n0(tile);
        for (int kb = 0; kb < k_steps; ++kb) {
          mbar_wait(&s.empty[stage], phase ^ 1);
          // the second f32 box only where some of its columns lie before K;
          // the full boxes are counted even where TMA zero-fills past an edge
          const bool two = kb * BK + BOX < K;
          mbar_expect_tx(&s.loaded[stage], (two ? 2 : 1) * T::X_BYTES + BN * BK);
          tma_load(s.xf[stage][0], &tmap_x, &s.loaded[stage], kb * BK, m0);
          if (two) tma_load(s.xf[stage][1], &tmap_x, &s.loaded[stage], kb * BK + BOX, m0);
          tma_load(s.w[stage], &tmap_w, &s.loaded[stage], kb * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: convert x, widen W into registers, wgmma,
    // epilogue ----
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
    // This thread's part of converting a step's x: the 16-byte bf16 chunk j
    // (columns 8j .. 8j + 7) of rows xr0, xr0 + XSTEP, ..., from f32 chunks
    // 2 (j % 4) and 2 (j % 4) + 1 of box j / 4 (16-byte chunk i of row r of a
    // 128-byte swizzled tile sits at chunk i ^ (r % 8)). Lane l of a half
    // warp takes row 2p + (l / 4) % 2 and chunk j = l % 4 + 4 ((l / 4 ^ l / 8)
    // % 2): the 8 lanes of a quarter warp read 8 distinct 16-byte bank
    // groups (even chunks of one row, odd of the other) and write 8.
    const int cl = threadIdx.x & 15;
    const int cro = (cl >> 2) & 1;
    const int cj = (cl & 3) | ((cro ^ (cl >> 3)) << 2);
    const int cc0 = 2 * (cj & 3);  // its first f32 chunk in box cj / 4
    const int xr0 = 2 * (threadIdx.x >> 4) + cro;
    constexpr int XSTEP = NC * 16;  // rows per pass: two per half warp
    float acc[BM / 2];
    uint32_t a0[16], a1[16];  // the A fragments of two K steps
    int stage = 0;
    uint32_t phase = 0;

    // load and widen this thread's A fragments of one K step from the
    // stage's W tile, once TMA has filled the stage
    auto load_a = [&](uint32_t(&a)[16]) {
      mbar_wait(&s.loaded[stage], phase);
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
    // this thread's part of the stage's x (K step kb, landed: load_a waited)
    // rounded to the bf16 tile the B descriptor reads, fenced for the async
    // proxy; the next row's loads are issued before this row's store (the
    // compiler cannot move a load above an earlier shared-memory store). A
    // second f32 box that was not loaded gives zeros
    auto convert = [&](int kb) {
      const bool live = cj < 4 || kb * BK + BOX < K;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(s.xf[stage][cj >> 2]);
      uint8_t* dst = reinterpret_cast<uint8_t*>(s.xb[stage]);
      auto load = [&](int r, float4& a, float4& b) {
        a = b = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && r < BM) {
          a = *reinterpret_cast<const float4*>(src + r * 128 + ((cc0 ^ (r & 7)) << 4));
          b = *reinterpret_cast<const float4*>(src + r * 128 + (((cc0 + 1) ^ (r & 7)) << 4));
        }
      };
      float4 a, b;
      load(xr0, a, b);
#pragma unroll
      for (int r = xr0; r < BM; r += XSTEP) {
        float4 na, nb;
        load(r + XSTEP, na, nb);
        *reinterpret_cast<uint4*>(dst + r * 128 + ((cj ^ (r & 7)) << 4)) =
            make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                       pack_bf16(b.z, b.w));
        a = na;
        b = nb;
      }
      fence_proxy_async();
    };
    // every consumer thread's part of the next bf16 tile is written (and
    // every wgmma of the step before it has completed)
    auto consumers_sync = [] {
      asm volatile("bar.sync 1, %0;\n" ::"n"(NC * 128) : "memory");
    };
    // one K step: 4 wgmmas on the stage's bf16 x tile; while they run, the
    // next step's A fragments are loaded and widened into the other register
    // set and this thread's part of the next step's x is converted; then
    // wait for the wgmmas, release the stage and meet the other consumers
    auto k_step = [&](uint32_t(&a)[16], uint32_t(&next_a)[16], int kb) {
      wgmma_fence();
      const uint64_t db = smem_desc(s.xb[stage], 16, 1024, DESC_SWIZZLE_128B);
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
      const bool more = kb + 1 < k_steps;
      if (more) {
        load_a(next_a);
        convert(kb + 1);
      }
      wgmma_wait<0>();
      fence_u32(a);
      if (lane == 0) mbar_arrive(&s.empty[done]);
      if (more) consumers_sync();
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile_m0(tile);
      const int n0 = tile_n0(tile);
      // this tile's scales, for accumulator rows (output columns) g and
      // g + 8 of this warp, loaded while the main loop runs; N % 8 == 0, so
      // each 8-column group is wholly inside N or wholly past it
      const int n = n0 + w_row;
      const bool in0 = n < N, in1 = n + 8 < N;
      const float s0 = in0 ? __ldg(scale + n) : 0.f;
      const float s1 = in1 ? __ldg(scale + n + 8) : 0.f;
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      load_a(a0);
      convert(0);
      consumers_sync();
      for (int kb = 0; kb < k_steps; kb += 2) {
        k_step(a0, a1, kb);
        if (kb + 1 < k_steps) k_step(a1, a0, kb + 1);
      }
      fence_regs(acc);

      // epilogue: acc * scale[n] in f32 stored as it is. Accumulator
      // registers 4j + e (e = 0 .. 3) hold x row 8j + 2t + (e & 1), W row
      // (output column) n + 8 (e >> 1)
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int m = m0 + 8 * j + 2 * t;
        float* o = out + (size_t)m * N + n;
        if (m < M) {
          if (in0) o[0] = acc[4 * j + 0] * s0;
          if (in1) o[8] = acc[4 * j + 2] * s1;
        }
        if (m + 1 < M) {
          if (in0) o[N] = acc[4 * j + 1] * s0;
          if (in1) o[N + 8] = acc[4 * j + 3] * s1;
        }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

// The device's SM count, and the instance's shared-memory limit raised on
// that device, once per process (the launch path runs ~250 times per UNet
// call, where at M <= 308 the host's time is the kernel's)
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
      e = cudaFuncSetAttribute(int8_wgmma_f32_kernel<BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes<BM, BN>);
    if (e != cudaSuccess) return e;
    sm_count[dev] = n;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

template <int BM, int BN>
cudaError_t launch(EncodeTiled fn, const void* x, const void* wq, const float* scale, float* out,
                   int M, int N, int K, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = prepare<BM, BN>(&sms);
  if (e != cudaSuccess) return e;
  CUtensorMap tx, tw;
  if (!encode(fn, &tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, M, K, BM, BOX,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(fn, &tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, N, K, BN, BK,
              CU_TENSOR_MAP_SWIZZLE_64B)) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  int8_wgmma_f32_kernel<BM, BN><<<grid, kThreads<BM, BN>, kSmemBytes<BM, BN>, stream>>>(
      tx, tw, scale, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) f32, wq (N, K) int8, both contiguous with 16-byte aligned bases;
// scale (N,) f32; out (M, N) f32, contiguous. (bm, bn) is one of the tile
// instances: bm in {64, 128, 256} rows of x, bn in {64, 128} rows of W.
// K % 16 == 0 and N % 8 == 0 (TMA's 16-byte global strides of the int8
// rows; N % 8 also keeps each 8-column group of the epilogue inside N or
// past it). Returns a cudaError_t: cudaErrorInvalidValue for what the
// kernel does not take (the wrapper routes those calls to int8_matmul.cu
// first) or a descriptor that cannot be encoded.
extern "C" int int8_matmul_wgmma_f32(const void* x, const void* wq, const void* scale, void* out,
                                     int M, int N, int K, int bm, int bn, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 16 != 0 || N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT8_WGMMA_F32_CASE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return (int)launch<BM_, BN_>(fn, x, wq, s, o, M, N, K, st);
  INT8_WGMMA_F32_CASE(64, 64)
  INT8_WGMMA_F32_CASE(128, 64)
  INT8_WGMMA_F32_CASE(256, 64)
  INT8_WGMMA_F32_CASE(64, 128)
  INT8_WGMMA_F32_CASE(128, 128)
  INT8_WGMMA_F32_CASE(256, 128)
#undef INT8_WGMMA_F32_CASE
  return (int)cudaErrorInvalidValue;
}

// One instance's (BM, BN, ring depth, dynamic shared memory bytes) into
// out[0..3]; cudaErrorInvalidValue for a tile that is not an instance.
extern "C" int int8_matmul_wgmma_f32_config(int bm, int bn, int* out) {
#define INT8_WGMMA_F32_CONFIG(BM_, BN_)      \
  if (bm == BM_ && bn == BN_) {              \
    out[0] = BM_;                            \
    out[1] = BN_;                            \
    out[2] = Tile<BM_, BN_>::STAGES;         \
    out[3] = (int)kSmemBytes<BM_, BN_>;      \
    return 0;                                \
  }
  INT8_WGMMA_F32_CONFIG(64, 64)
  INT8_WGMMA_F32_CONFIG(128, 64)
  INT8_WGMMA_F32_CONFIG(256, 64)
  INT8_WGMMA_F32_CONFIG(64, 128)
  INT8_WGMMA_F32_CONFIG(128, 128)
  INT8_WGMMA_F32_CONFIG(256, 128)
#undef INT8_WGMMA_F32_CONFIG
  return (int)cudaErrorInvalidValue;
}
