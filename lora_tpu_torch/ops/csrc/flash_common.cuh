// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// and the int8-weight matmul (int8_matmul.cu): tile loads from device memory
// into shared memory, and the bf16 mma.sync m16n8k16 instruction with the
// register packing its fragments need.
//
// Fragment layout of mma.sync m16n8k16 (PTX ISA, per lane, g = lane / 4,
// t = lane % 4):
//   A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8:  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C 16x8:  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// So the C fragments of two neighbouring n-tiles are, re-packed to bf16, the
// A fragment of one k-step of a following product (no trip through shared
// memory).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr int NTHREADS = 128;  // 4 warps per CTA in every kernel

// Rows [r0, r0 + ROWS) x columns [0, DP) of a row-major source with row
// stride `row_stride` into shared memory with row stride LD; rows >= n_rows
// and columns >= D are zero-filled. 16-byte chunks: D % 8 == 0, row strides
// that are multiples of 8 elements and a 16-byte aligned base are checked by
// the wrappers. scale_q folds the softmax scale in (f32 product, rounded
// back to the input dtype, as the JAX _scale_q).
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride, int r0,
                                               int n_rows, int D, bool scale_q,
                                               float scale) {
  constexpr int CHUNKS = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows && c < D) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + c);
      if (scale_q) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float2 f = __bfloat1622float2(h[i]);
          h[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int r0,
                                              int n_rows, int D, bool scale_q,
                                              float scale) {
  constexpr int CHUNKS = DP / 4;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows && c < D) {
      val = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * row_stride + c);
      if (scale_q) {
        val.x *= scale;
        val.y *= scale;
        val.z *= scale;
        val.w *= scale;
      }
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_smem_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from separate shared addresses -> one .b32 (lo = first)
__device__ __forceinline__ uint32_t pack_smem_pair(const __nv_bfloat16* lo,
                                                   const __nv_bfloat16* hi) {
  const uint32_t l = *reinterpret_cast<const unsigned short*>(lo);
  const uint32_t h = *reinterpret_cast<const unsigned short*>(hi);
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t pack_f32_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The padded head dim DP (a multiple of 16, 16..256) that a kernel template
// is instantiated for; run(Int<DP>) is called with the one that fits D.
template <int N>
struct Int {
  static constexpr int value = N;
};

template <typename F>
cudaError_t dispatch_dp(int D, F&& run) {
  switch ((D + 15) / 16 * 16) {
    case 16: return run(Int<16>{});
    case 32: return run(Int<32>{});
    case 48: return run(Int<48>{});
    case 64: return run(Int<64>{});
    case 80: return run(Int<80>{});
    case 96: return run(Int<96>{});
    case 112: return run(Int<112>{});
    case 128: return run(Int<128>{});
    case 144: return run(Int<144>{});
    case 160: return run(Int<160>{});
    case 176: return run(Int<176>{});
    case 192: return run(Int<192>{});
    case 208: return run(Int<208>{});
    case 224: return run(Int<224>{});
    case 240: return run(Int<240>{});
    case 256: return run(Int<256>{});
    default: return cudaErrorInvalidValue;
  }
}

// Launch with `smem` bytes of dynamic shared memory (above 48 KB only after
// raising the kernel's limit), then report the launch's own error.
template <typename Kernel, typename P>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, size_t smem,
                          cudaStream_t stream, const P& params) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NTHREADS, smem, stream>>>(params);
  return cudaGetLastError();
}

}  // namespace flash
