"""Readings for a cell's comparison limits, on the chip at the cell's own
size: the sound program over several seeds, and the control, in one
process (set-up is paid per seed; the window is short).

    python3 benchmark/control.py --config <config> --traffic <mix> \
        --mode <mode> --seeds 1,2,3 [--seconds 6] [--out FILE]

The cell is given by its files (benchmark/configs/<config>.json,
benchmark/traffic/<mix>.json), so a cell can be read before BENCHMARK.json
lists it. Modes: "sound" (the program as the configuration states it);
"fp8" (the control: the reference put in the program's place with the
operands of every product and convolution rounded to fp8 e4m3, against
the float32 reference); "half_batch" (training: the step fed every other
row of its batch, its loss the mean over the rest). One JSON line per
seed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def reading(cfg, mix, seed, mode, seconds, device) -> dict:
    import torch

    from benchmark.serving import ServeCell
    from benchmark.training import TrainCell

    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        t0 = time.perf_counter()
        if mix["runner"] == "train_db":
            cell = TrainCell(cfg, mix, seed, device, tmp)
            if mode == "half_batch":
                orig = cell.setup

                def setup():
                    # the fault sits under the step the set-up drives
                    import lora_tpu_torch.training.train_step as ts
                    make = ts.make_train_step

                    def patched(**kw):
                        fn = make(**kw)

                        def step(trainable, base, batch, generator=None,
                                 **draws):
                            b = {k: v[::2] for k, v in batch.items()}
                            d = {k: v[::2] for k, v in draws.items()}
                            return fn(trainable, base, b, generator, **d)
                        return step
                    ts.make_train_step = patched
                    try:
                        orig()
                    finally:
                        ts.make_train_step = make
                cell.setup = setup
            cell.setup()
            setup_s = time.perf_counter() - t0
            cell.close()
            numbers = cell.check(control=(mode == "fp8"))
        else:
            cell = ServeCell(cfg, mix, seed, device, tmp)
            cell.setup()
            setup_s = time.perf_counter() - t0
            cell.run(seconds, False)
            cell.close()
            numbers = cell.check(control=(mode == "fp8"))
        return {"seed": seed, "mode": mode, "setup_s": setup_s,
                "seconds": time.perf_counter() - t0, **numbers}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache() if torch.cuda.is_available() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--mode", default="sound",
                    choices=("sound", "fp8", "half_batch"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import inputs

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    os.environ["LORA_TPU_TORCH_BUILD_DIR"] = os.path.join(HERE, "_build")
    cfg = inputs.load_json("configs", args.config + ".json")
    mix = inputs.load_json("traffic", args.traffic + ".json")
    for s in args.seeds.split(","):
        r = reading(cfg, mix, int(s), args.mode, args.seconds, "cuda:0")
        r["cell"] = f"{args.config}.{args.traffic}"
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
