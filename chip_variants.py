#!/usr/bin/env python3
"""Variants of the f32 wide-head dQ kernel (lora_tpu_torch/ops/csrc/
flash_bwd_dq_tf32x3_wide.cu) timed against each other on one NVIDIA GPU:
what each part of the kernel costs, and the score exchange it replaced.

    python3 chip_variants.py        # from the repo root, one CUDA device

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


def build_variants(out_dir: str) -> dict:
    """{variant: library path}, each built from the committed source with
    its edits (every edit must match exactly once), all nvcc processes
    started together."""
    csrc = os.path.join(os.path.dirname(fa.__file__), "csrc")
    with open(os.path.join(csrc, STEM + ".cu")) as f:
        src = f.read()
    nvcc = build._find_nvcc()
    if nvcc is None:
        raise RuntimeError("chip_variants.py needs nvcc")
    procs = {}
    for name, edits in VARIANTS.items():
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


if __name__ == "__main__":
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]}")
    sys.exit(main())
