// Flash-attention backward for Hopper (sm_90a), non-causal, as two kernels:
//
//   dQ    = scale * sum_j dS_j K_j                       (flash_bwd_dq)
//   dK, dV = sum_i dS_i^T Q~_i,  sum_i P_i^T dO_i        (flash_bwd_dkv)
//
// with Q~ = scale * Q (rounded to the input dtype), P = exp(Q~ K^T - L)
// recomputed blockwise from the forward's f32 logsumexp L, dP = dO V^T and
// dS = P o (dP - delta), delta = rowsum(dO o O) in f32 (computed by the
// wrapper, as the JAX package computes it in XLA outside its kernels).
// q, dO (B, H, T, D) and k, v (B, H, S, D) are bf16 or f32; dq, dk, dv come
// back in the input dtype, each in its input's layout.
//
// Replaces the Pallas TPU kernels lora_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (driven by _bwd). Same numerics: the
// products run in the input dtype with f32 accumulation; P (for dV) and dS
// (for dQ and dK) are rounded to the input dtype before their products,
// while dS itself is formed from the f32 P; dQ is rounded to the input dtype
// and then multiplied by `scale` in f32 (as _bwd does after its dq kernel);
// dK takes no extra scale, since it is dS^T times the pre-scaled Q~.
//
// Design (simple first; what differs from the TPU kernels):
//   * dQ: one CTA per (b*h, q tile) loops over k/v tiles in shared memory
//     and keeps dQ in f32 registers; written once.
//   * dK/dV: one CTA per (b*h, kv tile) loops over q tiles, with L and delta
//     of each q tile staged beside it, and keeps dK and dV in f32 registers;
//     written once. The Pallas kernel carries f32 scratch across a
//     sequential grid axis; here CTAs run in no order, so the loop over q
//     lives inside the CTA. No atomics, nothing carried between CTAs.
//   * bf16: mma.sync m16n8k16 with f32 accumulation. Each warp owns 16 rows
//     (q rows in dQ, kv rows in dK/dV); the dK/dV kernel computes S^T and
//     dP^T directly (K and V rows as the A operand), so P^T and dS^T are
//     already A fragments of the dV and dK products. The q tile of dK/dV
//     shrinks with the head dim (64 rows up to DP = 96, 32 up to 160, then
//     16) so the two 16 x DP accumulators per warp (2 * DP / 4 floats per
//     thread) and the scores stay in registers.
//   * f32: CUDA-core FMAs (the Pallas kernels' HIGHEST precision). Four
//     threads share one row (q row in dQ, kv row in dK/dV): each holds a
//     quarter of the tile's scores and a quarter of the output columns, and
//     the quads exchange scores with shuffles.
//   * D is padded to a multiple of 16 inside shared memory only, with zero
//     fill; padded columns are never stored. Ragged T and S tails are masked
//     (P = 0 there). Inputs and outputs are addressed through (batch, head,
//     row) strides with a unit last stride, so the UNet's transposed views
//     of (B, T, H, D) projections are read, and their gradients written, in
//     place.
//
// What bounds it on an H100: dQ recomputes S and dP (4*T*S*D FLOPs) and adds
// dS K (2*T*S*D); dK/dV recomputes the same two products and adds two more
// (4*T*S*D): 14*T*S*D FLOPs for the pair against ~(4T + 4S)*D elements of
// HBM traffic each, far above the bf16 ridge (~295 FLOP/B) at SD shapes.
// The pair is compute-bound; its distance from peak is the mma.sync issue
// rate, the synchronous shared-memory staging (no cp.async/TMA overlap) and
// the re-reads of Q/K fragments from shared memory, all later work (wgmma,
// TMA, warp specialisation), as for the forward.
//
// Entry points: flash_bwd_dq(...) and flash_bwd_dkv(...) below, plain C
// functions for ctypes. Each launches on the given stream and returns
// cudaGetLastError() after the launch; neither synchronises or allocates.

#include <math.h>

#include "flash_common.cuh"

using namespace flash;

namespace {

constexpr int BM = 64;      // bf16: q rows per dQ CTA; kv rows per tile
constexpr int BN = 64;      // bf16: kv rows per dK/dV CTA; f32: tile width
constexpr int ROWS_F32 = 32;  // f32: rows per CTA (4 threads per row)

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B*H, T) f32
  const float* delta;  // (B*H, T) f32
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;   // dO
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  int H, T, S, D;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, int b, int h,
                                             long long sb, long long sh) {
  return static_cast<const T*>(base) + b * sb + h * sh;
}

template <typename T>
__device__ __forceinline__ T* head_ptr_out(void* base, int b, int h,
                                           long long sb, long long sh) {
  return static_cast<T*>(base) + b * sb + h * sh;
}

// q tile of the bf16 dK/dV kernel: see the design note above
template <int DP>
struct DkvTile {
  static constexpr int QT = DP <= 96 ? 64 : (DP <= 160 ? 32 : 16);
};

// ---------------------------------------------------------------------------
// bf16 dQ: warp w owns q rows [16w, 16w + 16) of the CTA's 64-row tile
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NTHREADS) bwd_dq_bf16_kernel(BwdParams p) {
  constexpr int LD = DP + 8;  // padded row: 16-byte aligned, spreads banks
  constexpr int NT_O = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + BM * LD;
  __nv_bfloat16* sK = sDO + BM * LD;
  __nv_bfloat16* sV = sK + BN * LD;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * BM;
  const __nv_bfloat16* Q = head_ptr<__nv_bfloat16>(p.q, b, h, p.q_sb, p.q_sh);
  const __nv_bfloat16* K = head_ptr<__nv_bfloat16>(p.k, b, h, p.k_sb, p.k_sh);
  const __nv_bfloat16* V = head_ptr<__nv_bfloat16>(p.v, b, h, p.v_sb, p.v_sh);
  const __nv_bfloat16* DO = head_ptr<__nv_bfloat16>(p.dout, b, h, p.o_sb, p.o_sh);
  __nv_bfloat16* DQ = head_ptr_out<__nv_bfloat16>(p.dq, b, h, p.dq_sb, p.dq_sh);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  load_tile_bf16<BM, DP, LD>(sQ, Q, p.q_st, q0, p.T, p.D, true, p.scale);
  load_tile_bf16<BM, DP, LD>(sDO, DO, p.o_st, q0, p.T, p.D, false, 1.f);

  // L and delta of this lane's rows g and g + 8
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    lse[i] = row < p.T ? p.lse[(long long)bh * p.T + row] : 0.f;
    dlt[i] = row < p.T ? p.delta[(long long)bh * p.T + row] : 0.f;
  }

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const __nv_bfloat16* qw = sQ + warp * 16 * LD;
  const __nv_bfloat16* dow = sDO + warp * 16 * LD;
  const int n_tiles = (p.S + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BN;
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16<BN, DP, LD>(sK, K, p.k_st, kv0, p.S, p.D, false, 1.f);
    load_tile_bf16<BN, DP, LD>(sV, V, p.v_st, kv0, p.S, p.D, false, 1.f);
    __syncthreads();

    // S = Q~ K^T and dP = dO V^T: 16 x 64 per warp, 8 n-tiles each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const uint32_t a0 = ld_smem_u32(qw + g * LD + kk + 2 * t4);
      const uint32_t a1 = ld_smem_u32(qw + (g + 8) * LD + kk + 2 * t4);
      const uint32_t a2 = ld_smem_u32(qw + g * LD + kk + 8 + 2 * t4);
      const uint32_t a3 = ld_smem_u32(qw + (g + 8) * LD + kk + 8 + 2 * t4);
      const uint32_t d0 = ld_smem_u32(dow + g * LD + kk + 2 * t4);
      const uint32_t d1 = ld_smem_u32(dow + (g + 8) * LD + kk + 2 * t4);
      const uint32_t d2 = ld_smem_u32(dow + g * LD + kk + 8 + 2 * t4);
      const uint32_t d3 = ld_smem_u32(dow + (g + 8) * LD + kk + 8 + 2 * t4);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = sK + (nt * 8 + g) * LD + kk;
        mma_bf16_16816(s[nt], a0, a1, a2, a3, ld_smem_u32(kr + 2 * t4),
                       ld_smem_u32(kr + 8 + 2 * t4));
        const __nv_bfloat16* vr = sV + (nt * 8 + g) * LD + kk;
        mma_bf16_16816(dp[nt], d0, d1, d2, d3, ld_smem_u32(vr + 2 * t4),
                       ld_smem_u32(vr + 8 + 2 * t4));
      }
    }

    // dS = P o (dP - delta), P = exp(S - L) in f32; masked kv columns give 0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = kv0 + nt * 8 + 2 * t4 + (e & 1);
        const float pe = col < p.S ? expf(s[nt][e] - lse[r]) : 0.f;
        s[nt][e] = pe * (dp[nt][e] - dlt[r]);
      }
    }

    // dQ += dS K: dS (bf16) as the A fragments, K[kv][d] gathered as B
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const uint32_t a0 = pack_f32_pair(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t a1 = pack_f32_pair(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t a2 = pack_f32_pair(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t a3 = pack_f32_pair(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      const __nv_bfloat16* k0 = sK + (kt * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const __nv_bfloat16* kc = k0 + dt * 8;
        const uint32_t b0 = pack_smem_pair(kc, kc + LD);
        const uint32_t b1 = pack_smem_pair(kc + 8 * LD, kc + 9 * LD);
        mma_bf16_16816(acc[dt], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // epilogue: dQ = bf16(bf16(acc) * scale), the two roundings of the JAX _bwd
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= p.T) continue;
    __nv_bfloat16* orow = DQ + (long long)row * p.dq_st;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      const int col = dt * 8 + 2 * t4;
      if (col < p.D) {
        const float2 r = __bfloat1622float2(
            __floats2bfloat162_rn(acc[dt][2 * i], acc[dt][2 * i + 1]));
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(r.x * p.scale, r.y * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK/dV: warp w owns kv rows [16w, 16w + 16) of the CTA's 64-row tile
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NTHREADS) bwd_dkv_bf16_kernel(BwdParams p) {
  constexpr int LD = DP + 8;
  constexpr int NT_O = DP / 8;
  constexpr int QT = DkvTile<DP>::QT;
  constexpr int NQ = QT / 8;    // n-tiles over the q tile
  constexpr int KQ = QT / 16;   // k-steps over the q tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BN * LD;
  __nv_bfloat16* sQ = sV + BN * LD;
  __nv_bfloat16* sDO = sQ + QT * LD;
  float* sL = reinterpret_cast<float*>(sDO + QT * LD);
  float* sDl = sL + QT;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kv0 = blockIdx.x * BN;
  const __nv_bfloat16* Q = head_ptr<__nv_bfloat16>(p.q, b, h, p.q_sb, p.q_sh);
  const __nv_bfloat16* K = head_ptr<__nv_bfloat16>(p.k, b, h, p.k_sb, p.k_sh);
  const __nv_bfloat16* V = head_ptr<__nv_bfloat16>(p.v, b, h, p.v_sb, p.v_sh);
  const __nv_bfloat16* DO = head_ptr<__nv_bfloat16>(p.dout, b, h, p.o_sb, p.o_sh);
  __nv_bfloat16* DK = head_ptr_out<__nv_bfloat16>(p.dk, b, h, p.dk_sb, p.dk_sh);
  __nv_bfloat16* DV = head_ptr_out<__nv_bfloat16>(p.dv, b, h, p.dv_sb, p.dv_sh);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  load_tile_bf16<BN, DP, LD>(sK, K, p.k_st, kv0, p.S, p.D, false, 1.f);
  load_tile_bf16<BN, DP, LD>(sV, V, p.v_st, kv0, p.S, p.D, false, 1.f);

  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const __nv_bfloat16* kw = sK + warp * 16 * LD;
  const __nv_bfloat16* vw = sV + warp * 16 * LD;
  const int n_q = (p.T + QT - 1) / QT;
  for (int it = 0; it < n_q; ++it) {
    const int q0 = it * QT;
    __syncthreads();  // the previous q tile's readers are done
    load_tile_bf16<QT, DP, LD>(sQ, Q, p.q_st, q0, p.T, p.D, true, p.scale);
    load_tile_bf16<QT, DP, LD>(sDO, DO, p.o_st, q0, p.T, p.D, false, 1.f);
    for (int idx = threadIdx.x; idx < QT; idx += NTHREADS) {
      const int row = q0 + idx;
      sL[idx] = row < p.T ? p.lse[(long long)bh * p.T + row] : 0.f;
      sDl[idx] = row < p.T ? p.delta[(long long)bh * p.T + row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q~^T and dP^T = V dO^T: 16 kv rows x QT q columns per warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const uint32_t a0 = ld_smem_u32(kw + g * LD + kk + 2 * t4);
      const uint32_t a1 = ld_smem_u32(kw + (g + 8) * LD + kk + 2 * t4);
      const uint32_t a2 = ld_smem_u32(kw + g * LD + kk + 8 + 2 * t4);
      const uint32_t a3 = ld_smem_u32(kw + (g + 8) * LD + kk + 8 + 2 * t4);
      const uint32_t v0 = ld_smem_u32(vw + g * LD + kk + 2 * t4);
      const uint32_t v1 = ld_smem_u32(vw + (g + 8) * LD + kk + 2 * t4);
      const uint32_t v2 = ld_smem_u32(vw + g * LD + kk + 8 + 2 * t4);
      const uint32_t v3 = ld_smem_u32(vw + (g + 8) * LD + kk + 8 + 2 * t4);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const __nv_bfloat16* qr = sQ + (nt * 8 + g) * LD + kk;
        mma_bf16_16816(s[nt], a0, a1, a2, a3, ld_smem_u32(qr + 2 * t4),
                       ld_smem_u32(qr + 8 + 2 * t4));
        const __nv_bfloat16* dr = sDO + (nt * 8 + g) * LD + kk;
        mma_bf16_16816(dp[nt], v0, v1, v2, v3, ld_smem_u32(dr + 2 * t4),
                       ld_smem_u32(dr + 8 + 2 * t4));
      }
    }

    // P^T = exp(S^T - L[q]) and dS^T = P^T o (dP^T - delta[q]), in f32;
    // q columns past T give 0
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);
        const float pe = q0 + c < p.T ? expf(s[nt][e] - sL[c]) : 0.f;
        s[nt][e] = pe;
        dp[nt][e] = pe * (dp[nt][e] - sDl[c]);
      }
    }

    // dV += P^T dO and dK += dS^T Q~: P^T, dS^T (bf16) as the A fragments,
    // dO[q][d] and Q~[q][d] gathered as B
#pragma unroll
    for (int kt = 0; kt < KQ; ++kt) {
      const uint32_t p0 = pack_f32_pair(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t p1 = pack_f32_pair(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t p2 = pack_f32_pair(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t p3 = pack_f32_pair(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      const uint32_t e0 = pack_f32_pair(dp[2 * kt][0], dp[2 * kt][1]);
      const uint32_t e1 = pack_f32_pair(dp[2 * kt][2], dp[2 * kt][3]);
      const uint32_t e2 = pack_f32_pair(dp[2 * kt + 1][0], dp[2 * kt + 1][1]);
      const uint32_t e3 = pack_f32_pair(dp[2 * kt + 1][2], dp[2 * kt + 1][3]);
      const __nv_bfloat16* o0 = sDO + (kt * 16 + 2 * t4) * LD + g;
      const __nv_bfloat16* x0 = sQ + (kt * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const __nv_bfloat16* oc = o0 + dt * 8;
        mma_bf16_16816(dv[dt], p0, p1, p2, p3, pack_smem_pair(oc, oc + LD),
                       pack_smem_pair(oc + 8 * LD, oc + 9 * LD));
        const __nv_bfloat16* xc = x0 + dt * 8;
        mma_bf16_16816(dk[dt], e0, e1, e2, e3, pack_smem_pair(xc, xc + LD),
                       pack_smem_pair(xc + 8 * LD, xc + 9 * LD));
      }
    }
  }

  // epilogue: one bf16 rounding each (the Pallas kernel's acc.astype)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kv0 + warp * 16 + g + 8 * i;
    if (row >= p.S) continue;
    __nv_bfloat16* krow = DK + (long long)row * p.dk_st;
    __nv_bfloat16* vrow = DV + (long long)row * p.dv_st;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      const int col = dt * 8 + 2 * t4;
      if (col < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(krow + col) =
            __floats2bfloat162_rn(dk[dt][2 * i], dk[dt][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
            __floats2bfloat162_rn(dv[dt][2 * i], dv[dt][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: quad (4r .. 4r + 3) owns row r of the CTA's 32; lane quarter qt holds
// the scores of tile columns 4c + qt (c < 16) and output columns
// [qt * DP/4, (qt + 1) * DP/4).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_get(float x, int lane, int j) {
  return __shfl_sync(0xffffffffu, x, (lane & ~3) | j);
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) bwd_dq_f32_kernel(BwdParams p) {
  constexpr int LD = DP + 4;  // 16-byte aligned rows, banks spread
  constexpr int QW = DP / 4;
  constexpr int NC = BN / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + ROWS_F32 * LD;
  float* sK = sDO + ROWS_F32 * LD;
  float* sV = sK + BN * LD;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * ROWS_F32;
  const float* Q = head_ptr<float>(p.q, b, h, p.q_sb, p.q_sh);
  const float* K = head_ptr<float>(p.k, b, h, p.k_sb, p.k_sh);
  const float* V = head_ptr<float>(p.v, b, h, p.v_sb, p.v_sh);
  const float* DO = head_ptr<float>(p.dout, b, h, p.o_sb, p.o_sh);
  float* DQ = head_ptr_out<float>(p.dq, b, h, p.dq_sb, p.dq_sh);

  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 2;
  const int qt = threadIdx.x & 3;
  const int row = q0 + r;

  load_tile_f32<ROWS_F32, DP, LD>(sQ, Q, p.q_st, q0, p.T, p.D, true, p.scale);
  load_tile_f32<ROWS_F32, DP, LD>(sDO, DO, p.o_st, q0, p.T, p.D, false, 1.f);
  const float lse = row < p.T ? p.lse[(long long)bh * p.T + row] : 0.f;
  const float dlt = row < p.T ? p.delta[(long long)bh * p.T + row] : 0.f;

  float acc[QW];
#pragma unroll
  for (int i = 0; i < QW; ++i) acc[i] = 0.f;

  const float* qr = sQ + r * LD;
  const float* dr = sDO + r * LD;
  const int n_tiles = (p.S + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BN;
    __syncthreads();
    load_tile_f32<BN, DP, LD>(sK, K, p.k_st, kv0, p.S, p.D, false, 1.f);
    load_tile_f32<BN, DP, LD>(sV, V, p.v_st, kv0, p.S, p.D, false, 1.f);
    __syncthreads();

    float s[NC], dp[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] = dp[c] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      const float qd = qr[d];
      const float od = dr[d];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s[c] = fmaf(qd, sK[(4 * c + qt) * LD + d], s[c]);
        dp[c] = fmaf(od, sV[(4 * c + qt) * LD + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float pe = kv0 + 4 * c + qt < p.S ? expf(s[c] - lse) : 0.f;
      s[c] = pe * (dp[c] - dlt);  // dS
    }

    // dQ[i] += sum over tile columns of dS[col] * K[col][qt * QW + i]
    const float* kh = sK + qt * QW;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float ds = quad_get(s[c], lane, jj);
        const float* kc = kh + (4 * c + jj) * LD;
#pragma unroll
        for (int i = 0; i < QW; ++i) acc[i] = fmaf(ds, kc[i], acc[i]);
      }
    }
  }

  if (row < p.T) {
    float* orow = DQ + (long long)row * p.dq_st + qt * QW;
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      if (qt * QW + i < p.D) orow[i] = acc[i] * p.scale;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) bwd_dkv_f32_kernel(BwdParams p) {
  constexpr int LD = DP + 4;
  constexpr int QW = DP / 4;
  constexpr int QT = BN;  // q rows per tile
  constexpr int NC = QT / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + ROWS_F32 * LD;
  float* sQ = sV + ROWS_F32 * LD;
  float* sDO = sQ + QT * LD;
  float* sL = sDO + QT * LD;
  float* sDl = sL + QT;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kv0 = blockIdx.x * ROWS_F32;
  const float* Q = head_ptr<float>(p.q, b, h, p.q_sb, p.q_sh);
  const float* K = head_ptr<float>(p.k, b, h, p.k_sb, p.k_sh);
  const float* V = head_ptr<float>(p.v, b, h, p.v_sb, p.v_sh);
  const float* DO = head_ptr<float>(p.dout, b, h, p.o_sb, p.o_sh);
  float* DK = head_ptr_out<float>(p.dk, b, h, p.dk_sb, p.dk_sh);
  float* DV = head_ptr_out<float>(p.dv, b, h, p.dv_sb, p.dv_sh);

  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 2;
  const int qt = threadIdx.x & 3;
  const int row = kv0 + r;

  load_tile_f32<ROWS_F32, DP, LD>(sK, K, p.k_st, kv0, p.S, p.D, false, 1.f);
  load_tile_f32<ROWS_F32, DP, LD>(sV, V, p.v_st, kv0, p.S, p.D, false, 1.f);

  float dk[QW], dv[QW];
#pragma unroll
  for (int i = 0; i < QW; ++i) dk[i] = dv[i] = 0.f;

  const float* kr = sK + r * LD;
  const float* vr = sV + r * LD;
  const int n_q = (p.T + QT - 1) / QT;
  for (int it = 0; it < n_q; ++it) {
    const int q0 = it * QT;
    __syncthreads();
    load_tile_f32<QT, DP, LD>(sQ, Q, p.q_st, q0, p.T, p.D, true, p.scale);
    load_tile_f32<QT, DP, LD>(sDO, DO, p.o_st, q0, p.T, p.D, false, 1.f);
    for (int idx = threadIdx.x; idx < QT; idx += NTHREADS) {
      const int qrow = q0 + idx;
      sL[idx] = qrow < p.T ? p.lse[(long long)bh * p.T + qrow] : 0.f;
      sDl[idx] = qrow < p.T ? p.delta[(long long)bh * p.T + qrow] : 0.f;
    }
    __syncthreads();

    float s[NC], dp[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] = dp[c] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      const float kd = kr[d];
      const float vd = vr[d];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s[c] = fmaf(kd, sQ[(4 * c + qt) * LD + d], s[c]);
        dp[c] = fmaf(vd, sDO[(4 * c + qt) * LD + d], dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int qc = 4 * c + qt;
      const float pe = q0 + qc < p.T ? expf(s[c] - sL[qc]) : 0.f;
      s[c] = pe;                        // P^T
      dp[c] = pe * (dp[c] - sDl[qc]);   // dS^T
    }

    const float* oh = sDO + qt * QW;
    const float* xh = sQ + qt * QW;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float pj = quad_get(s[c], lane, jj);
        const float dsj = quad_get(dp[c], lane, jj);
        const float* oc = oh + (4 * c + jj) * LD;
        const float* xc = xh + (4 * c + jj) * LD;
#pragma unroll
        for (int i = 0; i < QW; ++i) {
          dv[i] = fmaf(pj, oc[i], dv[i]);
          dk[i] = fmaf(dsj, xc[i], dk[i]);
        }
      }
    }
  }

  if (row < p.S) {
    float* krow = DK + (long long)row * p.dk_st + qt * QW;
    float* vrow = DV + (long long)row * p.dv_st + qt * QW;
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      if (qt * QW + i < p.D) {
        krow[i] = dk[i];
        vrow[i] = dv[i];
      }
    }
  }
}

bool bad_shape(int B, int H, int T, int S, int D) {
  return B < 1 || H < 1 || T < 1 || S < 1 || D < 8 || D > 256 || D % 8 != 0 ||
         (long long)B * H > 65535;
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const long long* st, int H, int T, int S, int D,
                      float scale) {
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_st = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_st = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_st = st[8];
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_st = st[11];
  p.H = H;
  p.T = T;
  p.S = S;
  p.D = D;
  p.scale = scale;
  return p;
}

}  // namespace

// strides: 15 int64 element strides, (batch, head, row) for q, k, v, dO, dq.
// lse and delta: (B*H, T) f32, contiguous. Returns a cudaError_t;
// cudaErrorInvalidValue for a shape the kernel does not take (the wrapper
// checks these first).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq,
                            const long long* strides, int B, int H, int T,
                            int S, int D, int is_bf16, float scale,
                            void* stream) {
  if (bad_shape(B, H, T, S, D)) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, delta, strides, H, T, S, D,
                            scale);
  p.dq = dq;
  p.dq_sb = strides[12]; p.dq_sh = strides[13]; p.dq_st = strides[14];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  return (int)dispatch_dp(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if (bf16) {
      return launch_kernel(bwd_dq_bf16_kernel<DP>,
                           dim3((T + BM - 1) / BM, B * H),
                           (2 * BM + 2 * BN) * (DP + 8) * sizeof(__nv_bfloat16),
                           st, p);
    }
    return launch_kernel(bwd_dq_f32_kernel<DP>,
                         dim3((T + ROWS_F32 - 1) / ROWS_F32, B * H),
                         (2 * ROWS_F32 + 2 * BN) * (DP + 4) * sizeof(float),
                         st, p);
  });
}

// strides: 18 int64 element strides, (batch, head, row) for q, k, v, dO, dk,
// dv; otherwise as flash_bwd_dq.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int T,
                             int S, int D, int is_bf16, float scale,
                             void* stream) {
  if (bad_shape(B, H, T, S, D)) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, delta, strides, H, T, S, D,
                            scale);
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = strides[12]; p.dk_sh = strides[13]; p.dk_st = strides[14];
  p.dv_sb = strides[15]; p.dv_sh = strides[16]; p.dv_st = strides[17];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  return (int)dispatch_dp(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if (bf16) {
      constexpr int QT = DkvTile<DP>::QT;
      return launch_kernel(bwd_dkv_bf16_kernel<DP>,
                           dim3((S + BN - 1) / BN, B * H),
                           (2 * BN + 2 * QT) * (DP + 8) * sizeof(__nv_bfloat16) +
                               2 * QT * sizeof(float),
                           st, p);
    }
    return launch_kernel(bwd_dkv_f32_kernel<DP>,
                         dim3((S + ROWS_F32 - 1) / ROWS_F32, B * H),
                         (2 * ROWS_F32 + 2 * BN) * (DP + 4) * sizeof(float) +
                             2 * BN * sizeof(float),
                         st, p);
  });
}
