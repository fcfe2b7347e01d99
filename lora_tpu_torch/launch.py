"""The multi-process launcher, the counterpart of lora_tpu/launch.py
(`accelerate launch` / torchrun): it starts N local worker processes with
torch.distributed's environment set (MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE; init_method="env://", which
parallel/mesh.initialize_distributed_from_env reads in the trainer CLIs) and
supervises them:

  - each child's output is streamed with a [pN] prefix;
  - SIGTERM, and a SIGINT (Ctrl-C) translated into SIGTERM, goes to every
    rank, so each rank's preemption checkpoint runs (PreemptionGuard handles
    SIGTERM); workers run in their own session, so a terminal's Ctrl-C
    reaches them only that way;
  - it fails fast: when a rank exits non-zero the survivors, which would
    block in their next collective, get SIGTERM, --grace-s seconds to
    checkpoint, then SIGKILL;
  - it exits 1 if any rank failed.

Usage:

    lora_launch_torch --nproc 2 -- lora_db_torch --instance_data_dir ... \\
        --data_parallel
    lora_launch_torch --cpu --nproc 2 -- \\
        python -m lora_tpu_torch.cli.lora_db ... --data_parallel \\
        --device cpu                          # ranks on the CPU over gloo

Each rank trains on one device: cuda:LOCAL_RANK, or with more ranks than
cards, ranks that share a card over gloo. --cpu puts every rank on the CPU
over gloo.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

from .parallel.mesh import DEVICE_ENV


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stream(proc: subprocess.Popen, tag: str) -> None:
    for line in proc.stdout:
        sys.stdout.write(f"[{tag}] {line}")
        sys.stdout.flush()


def _supervise(procs, grace_s: float = 30.0, poll_s: float = 0.2):
    """Wait on every worker, failing fast: once a rank exits non-zero, the
    survivors get SIGTERM, grace_s seconds to checkpoint, then SIGKILL."""
    while True:
        rcs = [p.poll() for p in procs]
        if all(rc is not None for rc in rcs):
            return rcs
        if any(rc not in (None, 0) for rc in rcs):
            break
        time.sleep(poll_s)
    crashed = [(i, rc) for i, rc in enumerate(rcs) if rc not in (None, 0)]
    print(f"lora_launch_torch: "
          f"{', '.join(f'p{i} exited rc{rc}' for i, rc in crashed)}; "
          f"terminating surviving ranks (grace {grace_s:.0f}s)",
          file=sys.stderr, flush=True)
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return [p.poll() for p in procs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="lora_launch_torch",
        description="Start N torch.distributed worker processes "
                    "(the accelerate-launch / torchrun counterpart).")
    ap.add_argument("--nproc", type=int, required=True,
                    help="number of worker processes (ranks)")
    ap.add_argument("--port", type=int, default=0,
                    help="MASTER_PORT (0 = pick a free one)")
    ap.add_argument("--grace-s", type=float, default=30.0,
                    help="on a rank's failure, seconds the surviving ranks "
                         "get to run their preemption checkpoint (SIGTERM) "
                         "before SIGKILL")
    ap.add_argument("--cpu", action="store_true",
                    help="every rank on the CPU over gloo")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="worker command after `--` (console script or "
                         "python -m ...)")
    args = ap.parse_args(argv)

    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("missing worker command (put it after `--`)")
    if shutil.which(cmd[0]) is None and cmd[0] != sys.executable:
        ap.error(f"worker command {cmd[0]!r} not found on PATH")

    port = args.port or _free_port()
    procs, threads = [], []
    for r in range(args.nproc):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(args.nproc),
                   LOCAL_WORLD_SIZE=str(args.nproc))
        if args.cpu:
            env[DEVICE_ENV] = "cpu"
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
        procs.append(p)
        t = threading.Thread(target=_stream, args=(p, f"p{r}"), daemon=True)
        t.start()
        threads.append(t)

    def forward(signum, _frame):
        # every rank gets SIGTERM, the signal PreemptionGuard handles
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)

    old_term = signal.signal(signal.SIGTERM, forward)
    old_int = signal.signal(signal.SIGINT, forward)
    try:
        rcs = _supervise(procs, grace_s=args.grace_s)
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join(timeout=5)

    bad = [(i, rc) for i, rc in enumerate(rcs) if rc != 0]
    if bad:
        print(f"lora_launch_torch: worker(s) failed: "
              f"{', '.join(f'p{i}=rc{rc}' for i, rc in bad)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
