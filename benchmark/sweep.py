"""The open-loop cell's knee: one server, the open-loop mix offered at each
of several rates in turn, and per rate the tail, the share served and
whether the backlog grew (the last third's latencies against the first
third's). The highest rate with no growing backlog is the knee; the cell
runs at a fixed share of it.

    python3 benchmark/sweep.py --config sd15 --traffic open_poisson_512 \
        --rates 1.0,1.2,1.4,1.6 --seconds 40 --seed 1 [--out FILE]

The cell is given by its files, as in benchmark/control.py.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import inputs, windows
    from benchmark.serving import ServeCell

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    os.environ["LORA_TPU_TORCH_BUILD_DIR"] = os.path.join(HERE, "_build")
    cfg = inputs.load_json("configs", args.config + ".json")
    mix = inputs.load_json("traffic", args.traffic + ".json")
    with tempfile.TemporaryDirectory(prefix="portbench-sweep-") as tmp:
        cell = ServeCell(cfg, mix, args.seed, "cuda:0", tmp)
        cell.setup()
        for rate in (float(r) for r in args.rates.split(",")):
            cell.mix = dict(mix, rate_per_s=rate)
            cell.requests = []
            cell.run(args.seconds, False)
            reqs = cell.requests
            lat = [r.t_done - r.t_due for r in reqs
                   if r.error is None and r.t_done]
            third = max(1, len(reqs) // 3)
            first = [r.t_done - r.t_due for r in reqs[:third] if r.t_done]
            last = [r.t_done - r.t_due for r in reqs[-third:] if r.t_done]
            mean = statistics.mean
            row = {"rate_per_s": rate, "sent": len(reqs),
                   "served": len(lat),
                   "p50_s": statistics.median(lat) if lat else None,
                   "p90_s": windows.nearest_rank(lat, 0.9) if lat else None,
                   "first_third_mean_s": mean(first) if first else None,
                   "last_third_mean_s": mean(last) if last else None,
                   "mean_rows": (len(lat) / sum(
                       1.0 / r.batched_with for r in reqs if r.batched_with)
                       if lat else None)}
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            time.sleep(2.0)
        cell.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
