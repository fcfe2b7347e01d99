// Int8-weight matrix product for Hopper (sm_90a):
//     out[m, n] = round_to_x_dtype( scale[n] * sum_k bf16(x[m, k]) * bf16(wq[n, k]) )
// for x (M, K) in bf16 or f32, wq (N, K) int8 with a per-output-channel f32
// scale (N,), out (M, N) in x's dtype; f32 accumulation.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/int8_matmul.py::_kernel
// (driven by int8_matmul). It computes the same function: x is rounded to
// bf16 on load (as x_ref[...].astype(jnp.bfloat16)), the int8 weight is
// widened to bf16 on chip (exact: |q| <= 127), the products are summed in
// f32, and the scale multiplies the f32 accumulator once before the single
// rounding to the output dtype. The weight is read from device memory as
// int8 bytes: no bf16 copy of W is ever materialised, which is the point of
// quantizing a weight-bandwidth-bound serving path.
//
// Design (simple first):
//   * One CTA of 8 warps per 128 x 128 output tile; the CTA loops over K in
//     32-wide steps. Warps form a 4 (M) x 2 (N) grid, each owning a 32 x 64
//     sub-tile: 2 x 8 mma.sync m16n8k16 (bf16 -> f32) accumulators, 64 f32
//     registers per thread.
//   * x and W tiles are staged in shared memory as bf16 (x rounded, W
//     widened from int8 while it is stored), two stages: the next K step's
//     global loads go to registers while the tensor cores work on the
//     current stage.
//   * Loads are 16-byte vectors where K and the base pointers allow them
//     (x: K % 8 == 0 in bf16, K % 4 == 0 in f32; W: K % 16 == 0; 16-byte
//     aligned bases), element by element otherwise. Ragged M, N and the K
//     tail are masked; out-of-range elements load as zero.
//   * Epilogue: acc * scale[n] in f32, one rounding to the output dtype,
//     paired stores when N is even.
//
// What bounds it on an H100: 2*M*N*K FLOPs against M*K*e_x + N*K + M*N*e_out
// bytes. At the UNet's large shapes (M = 16384) that is hundreds of FLOP
// per byte, above the bf16 ridge (~295): compute-bound, so the distance from
// peak is the tensor-core issue rate of mma.sync. At small M (the 4-row
// time-embedding projections, the 154-row CLIP batch) it reads the int8
// weight once and is bound by those bytes and by launch latency.
//
// What this design leaves on the table: mma.sync instead of wgmma, register
// staging instead of TMA / cp.async pipelines, 32-bit shared loads instead
// of ldmatrix, a CTA tile of 128 x 128 even when M is tiny (no split-K), and
// no fused bias or LoRA epilogue.
//
// Entry point: int8_matmul(...) below, a plain C function for ctypes. It
// launches on the given stream and returns cudaGetLastError() after the
// launch; it does not synchronise and allocates nothing.

#include "flash_common.cuh"

using flash::ld_smem_u32;
using flash::mma_bf16_16816;
using flash::pack_f32_pair;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int LDS = BK + 8;  // bf16 row of a staged tile: 80 bytes, banks spread

struct Params {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  int M, N, K;
  bool vec_x, vec_w;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t pack_i8_pair(uint32_t lo, uint32_t hi) {
  return pack_f32_pair((float)(int8_t)lo, (float)(int8_t)hi);
}

// This thread's share of one K step: 16 x values (8 packed bf16 pairs) and
// 16 W values (8 packed bf16 pairs), in registers between the global loads
// and the shared-memory stores.
struct Stage {
  uint32_t x[8];
  uint32_t w[8];
};

// x tile rows [m0, m0 + BM) x columns [k0, k0 + BK). bf16: 2 chunks of 8
// elements per thread; f32: 4 chunks of 4.
template <typename XT>
__device__ __forceinline__ void load_x(Stage& st, const Params& p, int m0, int k0) {
  constexpr int CW = 16 / sizeof(XT);   // elements per 16-byte chunk
  constexpr int CPR = BK / CW;          // chunks per row
  constexpr int NCH = BM * CPR / THREADS;
  const XT* X = static_cast<const XT*>(p.x);
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = threadIdx.x + j * THREADS;
    const int r = c / CPR;
    const int col = (c % CPR) * CW;
    const int m = m0 + r;
    const int k = k0 + col;
    uint32_t* dst = st.x + j * (CW / 2);
    if (p.vec_x) {
      if (m < p.M && k < p.K) {
        const XT* src = X + (long long)m * p.K + k;
        if constexpr (sizeof(XT) == 2) {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
        } else {
          const float4 v = *reinterpret_cast<const float4*>(src);
          dst[0] = pack_f32_pair(v.x, v.y);
          dst[1] = pack_f32_pair(v.z, v.w);
        }
      } else {
#pragma unroll
        for (int i = 0; i < CW / 2; ++i) dst[i] = 0u;
      }
    } else {
      const XT* row = X + (long long)m * p.K;
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) {
        const float lo = (m < p.M && k + 2 * i < p.K) ? to_float(row[k + 2 * i]) : 0.f;
        const float hi = (m < p.M && k + 2 * i + 1 < p.K) ? to_float(row[k + 2 * i + 1]) : 0.f;
        dst[i] = pack_f32_pair(lo, hi);
      }
    }
  }
}

// W tile rows [n0, n0 + BN) x columns [k0, k0 + BK): one 16-byte chunk of
// int8 per thread, widened to 16 bf16.
__device__ __forceinline__ void load_w(Stage& st, const Params& p, int n0, int k0) {
  const int r = threadIdx.x >> 1;
  const int col = (threadIdx.x & 1) * 16;
  const int n = n0 + r;
  const int k = k0 + col;
  if (p.vec_w) {
    if (n < p.N && k < p.K) {
      const uint4 v = *reinterpret_cast<const uint4*>(p.w + (long long)n * p.K + k);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st.w[2 * i] = pack_i8_pair(words[i] & 0xffu, (words[i] >> 8) & 0xffu);
        st.w[2 * i + 1] = pack_i8_pair((words[i] >> 16) & 0xffu, words[i] >> 24);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) st.w[i] = 0u;
    }
  } else {
    const int8_t* row = p.w + (long long)n * p.K;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float lo = (n < p.N && k + 2 * i < p.K) ? (float)row[k + 2 * i] : 0.f;
      const float hi = (n < p.N && k + 2 * i + 1 < p.K) ? (float)row[k + 2 * i + 1] : 0.f;
      st.w[i] = pack_f32_pair(lo, hi);
    }
  }
}

template <typename XT>
__device__ __forceinline__ void store_stage(const Stage& st, __nv_bfloat16* sX,
                                            __nv_bfloat16* sW) {
  constexpr int CW = 16 / sizeof(XT);
  constexpr int CPR = BK / CW;
  constexpr int NCH = BM * CPR / THREADS;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = threadIdx.x + j * THREADS;
    __nv_bfloat16* dst = sX + (c / CPR) * LDS + (c % CPR) * CW;
    if constexpr (CW == 8) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(st.x[4 * j], st.x[4 * j + 1], st.x[4 * j + 2], st.x[4 * j + 3]);
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(st.x[2 * j], st.x[2 * j + 1]);
    }
  }
  __nv_bfloat16* dw = sW + (threadIdx.x >> 1) * LDS + (threadIdx.x & 1) * 16;
  *reinterpret_cast<uint4*>(dw) = make_uint4(st.w[0], st.w[1], st.w[2], st.w[3]);
  *reinterpret_cast<uint4*>(dw + 8) = make_uint4(st.w[4], st.w[5], st.w[6], st.w[7]);
}

__device__ __forceinline__ void store_out(float* o, float a, float b, bool pair, bool b_ok) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  } else {
    o[0] = a;
    if (b_ok) o[1] = b;
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* o, float a, float b, bool pair,
                                          bool b_ok) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  } else {
    o[0] = __float2bfloat16_rn(a);
    if (b_ok) o[1] = __float2bfloat16_rn(b);
  }
}

template <typename XT>
__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 sX[2][BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 sW[2][BN * LDS];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = (warp & 3) * 32;   // warp's rows within the tile
  const int wn = (warp >> 2) * 64;  // warp's columns within the tile

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  Stage st;
  load_x<XT>(st, p, m0, 0);
  load_w(st, p, n0, 0);
  store_stage<XT>(st, sX[0], sW[0]);
  __syncthreads();

  const int n_k = (p.K + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) {  // next step's loads in flight during this one's math
      load_x<XT>(st, p, m0, (kt + 1) * BK);
      load_w(st, p, n0, (kt + 1) * BK);
    }
    const __nv_bfloat16* xs = sX[cur] + wm * LDS;
    const __nv_bfloat16* ws = sW[cur] + wn * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* xr = xs + (mt * 16 + g) * LDS + kk + 2 * t4;
        a[mt][0] = ld_smem_u32(xr);
        a[mt][1] = ld_smem_u32(xr + 8 * LDS);
        a[mt][2] = ld_smem_u32(xr + 8);
        a[mt][3] = ld_smem_u32(xr + 8 * LDS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* wr = ws + (nt * 8 + g) * LDS + kk + 2 * t4;
        const uint32_t b0 = ld_smem_u32(wr);
        const uint32_t b1 = ld_smem_u32(wr + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
        }
      }
    }
    if (kt + 1 < n_k) {
      // the other stage was last read in step kt - 1, before that step's
      // closing barrier
      store_stage<XT>(st, sX[cur ^ 1], sW[cur ^ 1]);
    }
    __syncthreads();
  }

  // epilogue: acc * scale[n] in f32, one rounding to the output dtype
  XT* out = static_cast<XT*>(p.out);
  const bool even_n = (p.N & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + wn + nt * 8 + 2 * t4;
    if (n >= p.N) continue;
    const bool b_ok = n + 1 < p.N;
    const float s0 = p.scale[n];
    const float s1 = b_ok ? p.scale[n + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + g + 8 * h;
        if (m >= p.M) continue;
        store_out(out + (long long)m * p.N + n, acc[mt][nt][2 * h] * s0,
                  acc[mt][nt][2 * h + 1] * s1, even_n && b_ok, b_ok);
      }
    }
  }
}

}  // namespace

// x (M, K) bf16 (is_bf16 = 1) or f32, contiguous; wq (N, K) int8, contiguous;
// scale (N,) f32; out (M, N) in x's dtype, contiguous. Returns a cudaError_t;
// cudaErrorInvalidValue for sizes the kernel does not take (the wrapper
// checks these first).
extern "C" int int8_matmul(const void* x, const void* wq, const void* scale,
                           void* out, int M, int N, int K, int is_bf16,
                           void* stream) {
  if (M < 1 || N < 1 || K < 1 || (N + BN - 1) / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(wq);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  const bool bf16 = is_bf16 != 0;
  const int x_align = bf16 ? 8 : 4;  // elements per 16 bytes
  p.vec_x = K % x_align == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_w = K % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(p);
  } else {
    int8_matmul_kernel<float><<<grid, THREADS, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
