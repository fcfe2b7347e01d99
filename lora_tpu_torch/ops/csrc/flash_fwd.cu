// Flash-attention forward for Hopper (sm_90a), non-causal:
//     O = softmax(scale * Q K^T) V,   L = rowwise logsumexp(scale * Q K^T)
// for q (B, H, T, D) and k, v (B, H, S, D) in bf16 or f32. O is in the input
// dtype, L is f32 (B, H, T) and is what a backward pass needs.
//
// Replaces the Pallas TPU kernel lora_tpu/ops/flash_attention.py::_fwd_kernel
// (driven by _fwd). It computes the same function: q is pre-scaled by `scale`
// in f32 and rounded back to the input dtype (as _scale_q does), the scores
// and the online-softmax statistics m, l and the accumulator are f32, the
// probabilities are rounded to the input dtype before the P.V product (as the
// Pallas kernel's p.astype(dt) does) and O = acc / l.
//
// Design (simple first):
//   * One CTA of 4 warps per (b*h, 64-row q tile). The CTA loops over 64-row
//     k/v tiles staged in shared memory, with an online softmax in f32
//     registers. Nothing carries between CTAs.
//   * bf16: mma.sync m16n8k16 with f32 accumulation. Each warp owns 16 q
//     rows; the S = Q K^T accumulator fragments are re-packed in registers as
//     the A operand of the P.V product (no trip through shared memory).
//   * f32: CUDA-core FMAs in true f32 (the Pallas kernel uses HIGHEST for
//     f32). Two threads per q row, each holding half of the row's scores and
//     half of its output columns.
//   * D is padded inside shared memory to DP, a multiple of 16, with zero
//     fill; padded copies never touch HBM. Ragged T and S tails are masked
//     in the kernel, so any T >= 1, S >= 1 and D <= 256 with D % 8 == 0 is
//     taken. q/k/v/o are addressed through (batch, head, row) strides with a
//     unit last stride, so the (B, T, H, D) layout the projections produce is
//     read and written in place.
//   * Tiles above 48 KB (D = 160 and up) use dynamic shared memory after
//     cudaFuncSetAttribute(MaxDynamicSharedMemorySize).
//
// What bounds it on an H100: 4*T*S*D FLOPs against (2T + 2S)*D*bytes of HBM
// traffic. At T = S = 4096, D = 40 in bf16 that is ~2,000 FLOP per byte, far
// above the ~295 FLOP/B ridge of the bf16 tensor cores: the kernel is
// compute-bound, so its distance from peak is the tensor-core issue rate.
// Each of the T/64 q tiles of a head re-reads that head's K and V (2*S*D
// elements); at SD shapes those re-reads are served from the 50 MB L2.
//
// What this design leaves on the table: mma.sync instead of wgmma (the
// warpgroup MMA is the only way to the full Hopper rate); plain synchronous
// global->shared copies instead of TMA or cp.async, so loads do not overlap
// the math; no double buffering of the k/v tiles; the V operand is gathered
// with 16-bit shared loads instead of ldmatrix.trans; Q fragments are re-read
// from shared memory for every k/v tile; D is padded to a multiple of 16
// (D = 40 runs as 48); the f32 path does not use the tensor cores at all.
//
// Entry point: flash_fwd(...) below, a plain C function for ctypes. It
// launches on the given stream and returns cudaGetLastError() after the
// launch; it does not synchronise and allocates nothing.

#include <math.h>

#include "flash_common.cuh"

using namespace flash;

namespace {

constexpr int BM = 64;        // q rows per CTA
constexpr int BN = 64;        // k/v rows per tile
constexpr float NEG_INIT = -1e30f;  // running-max init, as the Pallas kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int H, T, S, D;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 (fragment layout in flash_common.cuh)
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = DP + 8;  // padded row: 16-byte aligned, spreads banks
  constexpr int NT_O = DP / 8;  // n-tiles of the output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * LD;
  __nv_bfloat16* sV = sK + BN * LD;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * BM;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  load_tile_bf16<BM, DP, LD>(sQ, Q, p.q_st, q0, p.T, p.D, true, p.scale);

  float m[2] = {NEG_INIT, NEG_INIT};
  float l[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  const __nv_bfloat16* qw = sQ + warp * 16 * LD;
  const int n_tiles = (p.S + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BN;
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16<BM, DP, LD>(sK, K, p.k_st, kv0, p.S, p.D, false, 1.f);
    load_tile_bf16<BM, DP, LD>(sV, V, p.v_st, kv0, p.S, p.D, false, 1.f);
    __syncthreads();

    // S = Q_w K^T: 16 x 64 per warp, 8 n-tiles of 8 columns
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const uint32_t a0 = ld_smem_u32(qw + g * LD + kk + 2 * t4);
      const uint32_t a1 = ld_smem_u32(qw + (g + 8) * LD + kk + 2 * t4);
      const uint32_t a2 = ld_smem_u32(qw + g * LD + kk + 8 + 2 * t4);
      const uint32_t a3 = ld_smem_u32(qw + (g + 8) * LD + kk + 8 + 2 * t4);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = sK + (nt * 8 + g) * LD + kk;
        mma_bf16_16816(s[nt], a0, a1, a2, a3, ld_smem_u32(kr + 2 * t4),
                       ld_smem_u32(kr + 8 + 2 * t4));
      }
    }

    // mask the ragged S tail, then the online softmax of rows g and g + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = kv0 + nt * 8 + 2 * t4;
      if (col >= p.S) { s[nt][0] = -INFINITY; s[nt][2] = -INFINITY; }
      if (col + 1 >= p.S) { s[nt][1] = -INFINITY; s[nt][3] = -INFINITY; }
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx[0]);
      s[nt][1] = expf(s[nt][1] - mx[0]);
      s[nt][2] = expf(s[nt][2] - mx[1]);
      s[nt][3] = expf(s[nt][3] - mx[1]);
      rs[0] += s[nt][0] + s[nt][1];
      rs[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    }
    const float corr0 = expf(m[0] - mx[0]);
    const float corr1 = expf(m[1] - mx[1]);
    l[0] = l[0] * corr0 + rs[0];
    l[1] = l[1] * corr1 + rs[1];
    m[0] = mx[0];
    m[1] = mx[1];
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      acc[dt][0] *= corr0;
      acc[dt][1] *= corr0;
      acc[dt][2] *= corr1;
      acc[dt][3] *= corr1;
    }

    // O += P V: the C fragments of n-tiles 2k and 2k+1 are the A fragment of
    // k-step k; B[k][n] = V[kv][d] is gathered from two rows of sV
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const uint32_t a0 = pack_f32_pair(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t a1 = pack_f32_pair(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t a2 = pack_f32_pair(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t a3 = pack_f32_pair(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      const __nv_bfloat16* v0 = sV + (kt * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const __nv_bfloat16* vc = v0 + dt * 8;
        const uint32_t b0 = pack_smem_pair(vc, vc + LD);
        const uint32_t b1 = pack_smem_pair(vc + 8 * LD, vc + 9 * LD);
        mma_bf16_16816(acc[dt], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // epilogue: O = acc / l in bf16, L = m + log(l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= p.T) continue;
    __nv_bfloat16* orow = O + (long long)row * p.o_st;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      const int col = dt * 8 + 2 * t4;
      if (col < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[dt][2 * i] / l[i], acc[dt][2 * i + 1] / l[i]);
      }
    }
    if (t4 == 0) p.lse[(long long)bh * p.T + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs. Thread pair (2r, 2r+1) owns q row r of the tile; half
// `hf` holds the scores of columns 2c + hf and output columns
// [hf * DP/2, (hf + 1) * DP/2).
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_f32_kernel(Params p) {
  constexpr int LD = DP + 4;  // 16-byte aligned rows, banks spread
  constexpr int HALF = DP / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BM * LD;
  float* sV = sK + BN * LD;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * BM;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int r = threadIdx.x >> 1;
  const int hf = threadIdx.x & 1;

  load_tile_f32<BM, DP, LD>(sQ, Q, p.q_st, q0, p.T, p.D, true, p.scale);

  float m = NEG_INIT;
  float l = 0.f;
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;

  const float* qr = sQ + r * LD;
  const int n_tiles = (p.S + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BN;
    __syncthreads();
    load_tile_f32<BM, DP, LD>(sK, K, p.k_st, kv0, p.S, p.D, false, 1.f);
    load_tile_f32<BM, DP, LD>(sV, V, p.v_st, kv0, p.S, p.D, false, 1.f);
    __syncthreads();

    float s[BN / 2];
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) s[c] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int c = 0; c < BN / 2; ++c) s[c] = fmaf(qd, sK[(2 * c + hf) * LD + d], s[c]);
    }

    float mx = m;
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) {
      if (kv0 + 2 * c + hf >= p.S) s[c] = -INFINITY;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) {
      s[c] = expf(s[c] - mx);
      rs += s[c];
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    const float corr = expf(m - mx);
    l = l * corr + rs;
    m = mx;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= corr;

    const float* vh = sV + hf * HALF;
#pragma unroll 4
    for (int c = 0; c < BN / 2; ++c) {
      const float other = __shfl_xor_sync(0xffffffffu, s[c], 1);
      const float p0 = hf ? other : s[c];  // column 2c
      const float p1 = hf ? s[c] : other;  // column 2c + 1
      const float* v0 = vh + (2 * c) * LD;
#pragma unroll
      for (int i = 0; i < HALF; ++i) acc[i] = fmaf(p1, v0[LD + i], fmaf(p0, v0[i], acc[i]));
    }
  }

  const int row = q0 + r;
  if (row < p.T) {
    float* orow = O + (long long)row * p.o_st + hf * HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      if (hf * HALF + i < p.D) orow[i] = acc[i] / l;
    }
    if (hf == 0) p.lse[(long long)bh * p.T + row] = m + logf(l);
  }
}

}  // namespace

// strides: 12 int64 element strides, (batch, head, row) for q, k, v, o.
// Returns a cudaError_t; cudaErrorInvalidValue for a shape the kernel does
// not take (the wrapper checks these first).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, const long long* strides, int B, int H,
                         int T, int S, int D, int is_bf16, float scale,
                         void* stream) {
  if (B < 1 || H < 1 || T < 1 || S < 1 || D < 8 || D > 256 || D % 8 != 0 ||
      (long long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
  p.H = H;
  p.T = T;
  p.S = S;
  p.D = D;
  p.scale = scale;
  const bool bf16 = is_bf16 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch_dp(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const dim3 grid((T + BM - 1) / BM, B * H);
    if (bf16) {
      return launch_kernel(flash_fwd_bf16_kernel<DP>, grid,
                           3 * BM * (DP + 8) * sizeof(__nv_bfloat16), st, p);
    }
    return launch_kernel(flash_fwd_f32_kernel<DP>, grid,
                         3 * BM * (DP + 4) * sizeof(float), st, p);
  });
}
