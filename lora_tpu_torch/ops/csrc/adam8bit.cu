// Blockwise-int8 AdamW update for Hopper (sm_90a), one launch per parameter
// group over the group's raveled f32 vector (n elements):
//
//     g    <- g * clip_scale
//     mu   <- b1 * deq(mu_q) + (1 - b1) * g
//     nu   <- b2 * rms^2 + (1 - b2) * g^2,   rms = deq(nu_q)
//     rms  <- sqrt(nu)
//     step <- mu / (c1 * (rms / sqrt(c2) + eps))
//     p    <- p + (step + wd * p) * (-lr)
//
// (lora_tpu writes the step as (mu / c1) / (rms / sqrt(c2) + eps); XLA
// compiles (a / b) / c as a / (b * c), the form its update computes). Then
// mu and rms are requantized in blocks of 256: s = absmax / 127 (1 for an
// all-zero block), code = clip(round_half_even(x / s), -127, 127). The
// elements past n in the last block count as zeros.
//
// Replaces no Pallas kernel: lora_tpu runs this update as jnp under optax
// (lora_tpu/training/optim.py:28-95, scale_by_adam_8bit inside adamw_8bit,
// applied by _fused_by_group to each group's raveled vector). The port fuses
// the whole update into one pass so that the optimizer state stays at one
// byte per moment and the step touches each byte once.
//
// What bounds it on an H100: it is elementwise plus one 256-wide reduction,
// a few dozen FLOPs per element against 16 bytes per element (g and p read,
// p written, two int8 codes read and written) and 16 bytes per block of
// scales: device-memory bound, about 5 ns per thousand elements at 3.35
// TB/s. At a rank-4 SD-1.5 LoRA (~0.8 M elements) that is ~4 us, so a
// launch is dominated by its fixed latency.
//
// Design (simple first): one warp per block of 256 elements, 8 elements per
// thread, lane-strided (element j * 32 + lane of the block), so each of the
// 8 loads of a warp is one coalesced 128-byte (f32) or 32-byte (int8)
// segment; the block's absmax comes from warp shuffles, and lane 0 writes
// the two scales. Every rounding step is an explicit _rn intrinsic, so
// nvcc's default FMA contraction cannot fuse a product into a sum: the
// kernel is bit-identical to the plain PyTorch version
// (ops/adam8bit.py::adam8bit_update_reference), which runs the same
// sequence of f32 operations one op at a time.
//
// Entry point: adam8bit_update(...) below, a plain C function for ctypes. It
// launches on the given stream and returns cudaGetLastError() after the
// launch; it does not synchronise and allocates nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;           // elements per quantization block
constexpr int PER_LANE = BLOCK / 32;  // 8
constexpr int WARPS = 8;             // warps (blocks of 256) per CTA

struct Params {
  const float* g;
  const float* clip;  // device scalar, or null for no clip
  float* p;
  int8_t* mu_q;
  float* mu_s;
  int8_t* nu_q;
  float* nu_s;
  long long n;
  long long n_blocks;
  float lr, wd, b1, omb1, b2, omb2, eps, c1, c2;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// s = absmax / 127, 1 where the block is all zero
__device__ __forceinline__ float block_scale(float absmax) {
  const float s = __fdiv_rn(absmax, 127.0f);
  return s == 0.0f ? 1.0f : s;
}

__device__ __forceinline__ int8_t encode(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__global__ void __launch_bounds__(WARPS * 32)
    adam8bit_kernel(const Params prm) {
  const int lane = threadIdx.x & 31;
  const long long blk =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (blk >= prm.n_blocks) return;  // a whole warp leaves together
  const long long base = blk * BLOCK;
  const float clip = prm.clip != nullptr ? *prm.clip : 1.0f;
  const float mu_s = prm.mu_s[blk];
  const float nu_s = prm.nu_s[blk];
  const float sqc2 = __fsqrt_rn(prm.c2);
  const float neg_lr = -prm.lr;

  float mu[PER_LANE], rms[PER_LANE];
  float mu_max = 0.0f, rms_max = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const long long i = base + j * 32 + lane;
    if (i < prm.n) {
      float g = prm.g[i];
      if (prm.clip != nullptr) g = __fmul_rn(g, clip);
      const float m0 = __fmul_rn(static_cast<float>(prm.mu_q[i]), mu_s);
      const float r0 = __fmul_rn(static_cast<float>(prm.nu_q[i]), nu_s);
      const float m = __fadd_rn(__fmul_rn(prm.b1, m0), __fmul_rn(prm.omb1, g));
      const float nu =
          __fadd_rn(__fmul_rn(__fmul_rn(prm.b2, r0), r0),
                    __fmul_rn(__fmul_rn(prm.omb2, g), g));
      const float r = __fsqrt_rn(nu);
      const float step = __fdiv_rn(
          m, __fmul_rn(prm.c1, __fadd_rn(__fdiv_rn(r, sqc2), prm.eps)));
      const float p = prm.p[i];
      prm.p[i] = __fadd_rn(
          p, __fmul_rn(__fadd_rn(step, __fmul_rn(prm.wd, p)), neg_lr));
      mu[j] = m;
      rms[j] = r;
    } else {  // the tail of the last block: zeros, as jnp.pad gives them
      mu[j] = 0.0f;
      rms[j] = 0.0f;
    }
    mu_max = fmaxf(mu_max, fabsf(mu[j]));
    rms_max = fmaxf(rms_max, fabsf(rms[j]));
  }
  const float ms = block_scale(warp_max(mu_max));
  const float rs = block_scale(warp_max(rms_max));
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const long long i = base + j * 32 + lane;
    prm.mu_q[i] = encode(mu[j], ms);
    prm.nu_q[i] = encode(rms[j], rs);
  }
  if (lane == 0) {
    prm.mu_s[blk] = ms;
    prm.nu_s[blk] = rs;
  }
}

}  // namespace

// g (n,) f32; clip: a device f32 scalar or null; p (n,) f32, updated in
// place; mu_q, nu_q (n_blocks * 256,) int8 and mu_s, nu_s (n_blocks,) f32
// with n_blocks = ceil(n / 256), all updated in place; every array
// contiguous. omb1 and omb2 are 1 - b1 and 1 - b2 rounded to f32 from
// double, as optax's weakly typed (1.0 - b) constants are. Returns a
// cudaError_t; cudaErrorInvalidValue for sizes it does not take.
extern "C" int adam8bit_update(const void* g, const void* clip, void* p,
                               void* mu_q, void* mu_s, void* nu_q, void* nu_s,
                               long long n, float lr, float wd, float b1,
                               float omb1, float b2, float omb2, float eps,
                               float c1, float c2, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  Params prm;
  prm.g = static_cast<const float*>(g);
  prm.clip = static_cast<const float*>(clip);
  prm.p = static_cast<float*>(p);
  prm.mu_q = static_cast<int8_t*>(mu_q);
  prm.mu_s = static_cast<float*>(mu_s);
  prm.nu_q = static_cast<int8_t*>(nu_q);
  prm.nu_s = static_cast<float*>(nu_s);
  prm.n = n;
  prm.n_blocks = (n + BLOCK - 1) / BLOCK;
  prm.lr = lr;
  prm.wd = wd;
  prm.b1 = b1;
  prm.omb1 = omb1;
  prm.b2 = b2;
  prm.omb2 = omb2;
  prm.eps = eps;
  prm.c1 = c1;
  prm.c2 = c2;
  const long long ctas = (prm.n_blocks + WARPS - 1) / WARPS;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  adam8bit_kernel<<<static_cast<unsigned>(ctas), WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}
