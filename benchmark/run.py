"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell names a configuration (benchmark/configs/<config>.json) and a
traffic mix (benchmark/traffic/<mix>.json, whose "runner" picks
benchmark/serving.py or benchmark/training.py); its per-layer metrics are
read by benchmark/metrics/<metric>.py and its comparison limits are in
benchmark/limits/<cell>.json. The run builds its inputs from the seed,
sets up and warms the program, measures for --seconds, then checks what
the window produced against the plain reference. The last line of
standard output is the result: with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer metrics read from a bounded traced
part of the window. Without a CUDA device, or with fewer than the cell
asks for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "lora_tpu")


def manifest() -> dict:
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def read_metric(name: str, ctx: dict):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, n_devices: int = 1, device_kind: str = "cpu",
             limits=None, cfg=None, mix=None) -> dict:
    """One run of `cell` on `device`: the result line's dict and the
    checked numbers."""
    import torch

    from benchmark import compare, inputs
    from benchmark.serving import ServeCell
    from benchmark.training import TrainCell

    entry = cell_entry(bench, cell)
    cfg = cfg or inputs.load_json("configs", entry["config"] + ".json")
    mix = mix or inputs.load_json("traffic", entry["traffic"] + ".json")
    lim = compare.limits(cell) if limits is None else limits
    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        t0 = time.perf_counter()
        cls = TrainCell if mix["runner"] == "train_db" else ServeCell
        run = cls(cfg, mix, seed, device, tmpdir)
        run.setup()
        setup_s = time.perf_counter() - t0
        run.run(seconds, trace)
        e2e = run.end_to_end()
        peak = run.memory_peak()
        attempted, failed = run.counts()
        ctx = run.per_layer_context() if trace else None
        run.close()
        numbers = run.check()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    e2e["setup_s"] = setup_s
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in cell_metrics(bench, cell, kind):
        v = read_metric(m["name"], ctx) if trace else e2e.get(m["name"])
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = compare.verdict(numbers, lim) and (
        trace or all(m["name"] in metrics for m in
                     cell_metrics(bench, cell, "end_to_end")))
    device_info = {"platform": "gpu" if device_kind != "cpu" else "cpu",
                   "kind": device_kind, "count": n_devices,
                   "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace and ctx.get("trace") is not None:
        t = ctx["trace"]
        device_info["busy_s"] = t.busy_s
        device_info["window_s"] = t.window_s
        labels = ctx.get("labels") or t
        result["breakdown"] = {"device_ops": t.device_ops(),
                               "idle_gaps": labels.idle_gaps()}
    result["checks"] = {k: {"value": numbers.get(k), "limit": v}
                        for k, v in lim.items()}
    result["readings"] = {k: v for k, v in numbers.items() if k not in lim}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    entry = cell_entry(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the program's kernel builds go to a fixed directory of the checkout
    os.environ["LORA_TPU_TORCH_BUILD_DIR"] = os.path.join(HERE, "_build")
    torch.cuda.set_device(0)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", entry["chips"],
                      torch.cuda.get_device_name(0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that a run may not load: {bad}",
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
