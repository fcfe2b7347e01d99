#!/usr/bin/env python3
"""Variants of a hand-written kernel timed against each other on one NVIDIA
GPU: what each part of the kernel costs, and designs it replaced.

    python3 chip_variants.py             # the f32 wide-head dQ kernel
                                         # (lora_tpu_torch/ops/csrc/
                                         # flash_bwd_dq_tf32x3_wide.cu)
    python3 chip_variants.py --int8-f32  # the f32 int8 matmul
                                         # (csrc/int8_matmul_wgmma_f32.cu)

Each variant is the committed source with a few textual edits (VARIANTS),
written to a temporary directory and built with the repo's nvcc flags, all
variants in parallel, then loaded with ctypes in place of the kernel's
entry point. Every variant runs at SD-1.5's 16x16 training level in f32
(B = 1, H = 8, T = S = 256, D = 160) and over T = S = 4096 at D = 160, on
the same inputs: its device time per launch (CUDA-graph replays,
chip_smoke._graph_ms) and its error against flash_bwd_dq_reference (max
|kernel - plain| / max |plain|). Only "kernel" and "exchange_remote_arrive"
compute dQ; the others leave out work, so their errors are large and only
their times mean anything:
  kernel                  the committed source
  exchange_remote_arrive  the scores handed over as flash_bwd_dkv_tf32x3_wide.cu
                          hands P^T over: plain remote stores, then a remote
                          mbarrier arrival at cluster scope from each of the
                          128 threads, and a second barrier to free the slot
  no_exchange             each CTA keeps its own scores (no remote store, no
                          wait on the peer)
  one_score_wgmma         S or dP as one wgmma instead of 3 x DP/8
  one_dq_wgmma            the dQ product as one wgmma instead of 3 x BN/8
  no_stage_loads          the producer issues no stage loads (the ring
                          still turns)

The f32 int8 matmul's variants (INT8_F32_VARIANTS) run at the f32 shapes
of SD-1.5 quantized serving in INT8_F32_SHAPES, each at the tile _tile
picks for the committed kernel, on the same inputs: device time per launch
and error against int8_matmul_reference. "kernel", "converter_warps" and
"m_fastest" compute the product; the others leave out work:
  kernel               the committed source: the consumers round x to
                       bf16 under their wgmmas
  converter_warps      the design built first: warps 1-3 of the producer
                       warpgroup round x (the same mapping over 96
                       threads) and arrive on a `converted` mbarrier that
                       the consumers wait on
  m_fastest            the tiles M fastest inside an N column (the bf16
                       kernel's order), not N fastest inside an M row
  no_convert           nothing rounds x (the bf16 tiles keep what they held)
  no_x_loads           the producer loads only W (x's f32 boxes not at all)
  no_wgmma             the consumers issue no wgmma
  no_stores            the consumers store no output
Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as c
from lora_tpu_torch.ops import build
from lora_tpu_torch.ops import flash_attention as fa
from lora_tpu_torch.ops import int8_matmul as i8

STEM = "flash_bwd_dq_tf32x3_wide"
SHAPES = ((1, 8, 256, 256, 160), (1, 8, 4096, 4096, 160))

_EXPECT = "    if (tid == 0) mbar_expect_tx(&s.r_full[slot], C::RX_BYTES);\n"
_ST_ASYNC = """#pragma unroll
    for (int i = 0; i < NK; ++i)
      st_async_v4(peer_p + ((slot * NK + i) * 128 + tid) * 16,
                  make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]),
                  peer_full + 8 * slot);
"""
_WAIT = "    mbar_wait_cluster(&s.r_full[slot], parity);\n"
_READ = ("    for (int i = 0; i < NK; ++i) rv[i] = "
         "reinterpret_cast<const float4*>(s.p[slot][i])[tid];\n")
_OWN = ("    for (int i = 0; i < NK; ++i)\n"
        "      rv[i] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], "
        "sc[4 * i + 3]);\n")
_S3 = """      wgmma_ss_tf32(sc, xd[0] + kb * X_STEP, bd[0] + kb * B_STEP, kb);
      wgmma_ss_tf32(sc, xd[0] + kb * X_STEP, bd[1] + kb * B_STEP, 1);
      wgmma_ss_tf32(sc, xd[1] + kb * X_STEP, bd[0] + kb * B_STEP, 1);
"""
_DQ3 = """      wgmma_rs_tf32(acc, ah + 4 * nk, td[0] + nk * T_STEP, nk);
      wgmma_rs_tf32(acc, ah + 4 * nk, td[1] + nk * T_STEP, 1);
      wgmma_rs_tf32(acc, al + 4 * nk, td[0] + nk * T_STEP, 1);
"""

VARIANTS = {
    "kernel": [],
    "exchange_remote_arrive": [
        ("  uint64_t r_full[2];",
         "  uint64_t r_empty[2];\n  uint64_t r_full[2];"),
        ("    for (int i = 0; i < 2; ++i) mbar_init(&s.r_full[i], 1);",
         "    for (int i = 0; i < 2; ++i) {\n"
         "      mbar_init(&s.r_full[i], 128);\n"
         "      mbar_init(&s.r_empty[i], 128);\n    }"),
        ("  const uint32_t peer_full = cluster_map(s.r_full, peer);\n",
         "  const uint32_t peer_full = cluster_map(s.r_full, peer);\n"
         "  const uint32_t peer_empty = cluster_map(s.r_empty, peer);\n"),
        (_EXPECT, "    mbar_wait_cluster(&s.r_empty[slot], parity ^ 1);\n"),
        (_ST_ASYNC,
         "#pragma unroll\n"
         "    for (int i = 0; i < NK; ++i)\n"
         "      st_cluster_v4(peer_p + ((slot * NK + i) * 128 + tid) * 16,\n"
         "                    make_float4(sc[4 * i], sc[4 * i + 1], "
         "sc[4 * i + 2], sc[4 * i + 3]));\n"
         "    mbar_arrive_cluster(peer_full + 8 * slot);\n"),
        (_READ, _READ + "    mbar_arrive_cluster(peer_empty + 8 * slot);\n"),
    ],
    "no_exchange": [(_EXPECT, ""), (_ST_ASYNC, ""), (_WAIT, ""),
                    (_READ, _OWN)],
    "one_score_wgmma": [
        (_S3, "      if (kb == 0) wgmma_ss_tf32(sc, xd[0], bd[0], 0);\n")],
    "one_dq_wgmma": [
        (_DQ3, "      if (nk == 0) wgmma_rs_tf32(acc, ah, td[0], 0);\n")],
    "no_stage_loads": [("mbar_expect_tx(bar, tx);",
                        "mbar_arrive(bar);\n        if (j < 0)")],
}


def build_variants(out_dir: str, stem: str = STEM,
                   variants: dict = VARIANTS) -> dict:
    """{variant: library path}, each built from the committed source of
    `stem` with its edits (every edit must match exactly once), all nvcc
    processes started together."""
    csrc = os.path.join(os.path.dirname(fa.__file__), "csrc")
    with open(os.path.join(csrc, stem + ".cu")) as f:
        src = f.read()
    nvcc = build._find_nvcc()
    if nvcc is None:
        raise RuntimeError("chip_variants.py needs nvcc")
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: edit matches "
                                     f"{text.count(old)} times: {old!r}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", csrc, "-o", path[:-3] + ".so",
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in log.splitlines() if "Used " in line})
        spills = any("spill" in line and "0 bytes spill" not in line
                     for line in log.splitlines())
        c.log(f"build: {name}: registers {regs}, spills {spills}")
        libs[name] = os.path.join(out_dir, f"{name}.so")
    return libs


def main() -> int:
    smi = c.phase_device()
    gen = torch.Generator("cuda").manual_seed(c.SEED)
    cases = []
    with torch.inference_mode():
        for B, H, T, S, D in SHAPES:
            q, k, v = c._qkv(B, H, T, S, D, torch.float32, gen, True)
            do = c._qkv(B, H, T, T, D, torch.float32, gen, True)[0]
            scale = D ** -0.5
            o, lse = fa.flash_fwd(q, k, v, scale)
            delta = fa._delta(o, do)
            qt = fa._q_tilde(q, scale)
            ops = fa._tf32x3_operands(qt, do, k, v, ("dq",))["dq"]
            want = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
            cases.append(((T, D), (qt, k, v, do, lse, delta, scale,
                                   fa.TF32X3_DQ_WIDE_BM, ops), want))
    with tempfile.TemporaryDirectory() as out_dir:
        for name, path in build_variants(out_dir).items():
            fn = getattr(ctypes.CDLL(path), STEM)
            fn.argtypes = [fa._PTR] * fa._ENTRY["dq_tf32x3_wide"][2] + fa._TAIL
            fn.restype = ctypes.c_int
            fa._fns["dq_tf32x3_wide"] = fn
            row = {"variant": name}
            with torch.inference_mode():
                for (T, D), args, want in cases:
                    def call(args=args):
                        return fa._dq_launch("tf32x3_wide", *args)

                    got = call()
                    torch.cuda.synchronize()
                    row[f"rel_err_T{T}"] = ((got - want).abs().max()
                                            / want.abs().max()).item()
                    row[f"device_ms_T{T}"] = c._graph_ms(call)
            c.log(json.dumps(row))
    fa._fns.pop("dq_tf32x3_wide", None)
    c.log(smi)
    return 0


INT8_F32_STEM = "int8_matmul_wgmma_f32"
# the main shape, the largest M of each kind, the long-K and few-tile ones
INT8_F32_SHAPES = ((16384, 320, 2560), (16384, 1280, 320), (4096, 640, 5120),
                   (1024, 5120, 1280), (1024, 1280, 10240),
                   (256, 5120, 1280), (77, 3072, 768), (154, 768, 3072),
                   (4, 1280, 1280))
_CONVERTERS = """    } else if (threadIdx.x >= NC * 128 + 32) {
      // warps 1-3: the converters, each thread the chunk column and rows of
      // the consumers' mapping over 96 threads
      const int sid = threadIdx.x - NC * 128 - 32;
      const int l = sid & 15;
      const int ro = (l >> 2) & 1;
      const int j = (l & 3) | ((ro ^ (l >> 3)) << 2);
      const int c0 = 2 * (j & 3);
      const int r0 = 2 * (sid >> 4) + ro;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kb = 0; kb < k_steps; ++kb) {
          mbar_wait(&s.loaded[stage], phase);
          const bool live = j < 4 || kb * BK + BOX < K;
          const uint8_t* src = reinterpret_cast<const uint8_t*>(s.xf[stage][j >> 2]);
          uint8_t* dst = reinterpret_cast<uint8_t*>(s.xb[stage]);
          for (int r = r0; r < BM; r += 12) {
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
            if (live) {
              a = *reinterpret_cast<const float4*>(src + r * 128 + ((c0 ^ (r & 7)) << 4));
              b = *reinterpret_cast<const float4*>(src + r * 128 + (((c0 + 1) ^ (r & 7)) << 4));
            }
            *reinterpret_cast<uint4*>(dst + r * 128 + ((j ^ (r & 7)) << 4)) =
                make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                           pack_bf16(b.z, b.w));
          }
          fence_proxy_async();
          mbar_arrive(&s.converted[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
"""
_CONVERT_LOOP = """      float4 a, b;
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
"""
_X_LOADS = """          mbar_expect_tx(&s.loaded[stage], (two ? 2 : 1) * T::X_BYTES + BN * BK);
          tma_load(s.xf[stage][0], &tmap_x, &s.loaded[stage], kb * BK, m0);
          if (two) tma_load(s.xf[stage][1], &tmap_x, &s.loaded[stage], kb * BK + BOX, m0);
"""
INT8_F32_VARIANTS = {
    "kernel": [],
    "converter_warps": [
        ("  uint64_t loaded[S];\n",
         "  uint64_t loaded[S];\n  uint64_t converted[S];\n"),
        ("      mbar_init(&s.loaded[i], 1);",
         "      mbar_init(&s.converted[i], 96);\n"
         "      mbar_init(&s.loaded[i], 1);"),
        ("setmaxnreg.dec.sync.aligned.u32 40;",
         "setmaxnreg.dec.sync.aligned.u32 56;"),
        ("setmaxnreg.inc.sync.aligned.u32 232;",
         "setmaxnreg.inc.sync.aligned.u32 224;"),
        ("    }\n  } else {\n", _CONVERTERS),
        ("        convert(kb + 1);\n", ""),
        ("      if (more) consumers_sync();\n", ""),
        ("      convert(0);\n      consumers_sync();\n", ""),
        ("      wgmma_fence();\n      const uint64_t db",
         "      mbar_wait(&s.converted[stage], phase);\n"
         "      wgmma_fence();\n      const uint64_t db"),
    ],
    "m_fastest": [
        ("  auto tile_m0 = [&](int tile) { return (tile / n_tiles) * BM; };",
         "  auto tile_m0 = [&](int tile) { return (tile % (tiles / n_tiles))"
         " * BM; };"),
        ("  auto tile_n0 = [&](int tile) { return (tile % n_tiles) * BN; };",
         "  auto tile_n0 = [&](int tile) { return (tile / (tiles / n_tiles))"
         " * BN; };")],
    "no_convert": [(_CONVERT_LOOP, "")],
    "no_x_loads": [(_X_LOADS, "          mbar_expect_tx(&s.loaded[stage], "
                              "BN * BK);\n")],
    "no_wgmma": [("        wgmma_rs<0>(acc, a + 4 * kk, db + 2 * kk, 1);\n",
                  "")],
    "no_stores": [("        float* o = out + (size_t)m * N + n;\n",
                   "        float* o = out + (size_t)m * N + n;\n"
                   "        if (m >= 0) continue;\n")],
}


def main_int8_f32() -> int:
    smi = c.phase_device()
    gen = torch.Generator("cuda").manual_seed(c.SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    with torch.inference_mode():
        for M, K, N in INT8_F32_SHAPES:
            x, wq, scale = c._int8_inputs(M, K, N, torch.float32, gen)
            cases.append(((M, K, N), (x, wq, scale),
                          i8._tile(M, K, N, sms, "wgmma_f32"),
                          i8.int8_matmul_reference(x, wq, scale)))
    with tempfile.TemporaryDirectory() as out_dir:
        for name, path in build_variants(out_dir, INT8_F32_STEM,
                                         INT8_F32_VARIANTS).items():
            fn = getattr(ctypes.CDLL(path), INT8_F32_STEM)
            fn.argtypes = i8._ENTRY["wgmma_f32"][2]
            fn.restype = ctypes.c_int
            i8._fns["wgmma_f32"] = fn
            row = {"variant": name}
            with torch.inference_mode():
                for shape, args, tile, want in cases:
                    def call(args=args, tile=tile):
                        return c._int8_direct("wgmma_f32", *args, tile)

                    key = "x".join(map(str, shape))
                    row[f"rel_err_{key}"] = c._rel(call(), want)
                    row[f"device_ms_{key}"] = c._graph_ms(call)
            c.log(json.dumps(row))
    i8._fns.pop("wgmma_f32", None)
    c.log(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--int8-f32"]:
        sys.exit(main_int8_f32())
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--int8-f32]")
    sys.exit(main())
