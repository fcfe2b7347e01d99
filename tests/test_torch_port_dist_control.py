"""Control across processes in the port: lora_launch_torch's supervision
(against tests/test_launch.py:45-105, and a failed handshake), the trainer
CLIs under the launcher, a SIGTERM to one rank then a resume, and the
kernels' build lock.

  - two workers join one gloo group and all-reduce; a failing rank fails
    the launch; the survivors of a crash get SIGTERM, and SIGKILL after
    the grace period; a SIGTERM to the launcher reaches every rank; a
    handshake that cannot complete raises on every rank after the timeout;
  - `lora_launch_torch --cpu --nproc 2 -- python -m
    lora_tpu_torch.cli.lora_db ... --data_parallel --device cpu` (and the
    PTI and legacy TI CLIs) train, rank 0 writing;
  - a SIGTERM to rank 1 alone stops both ranks at the same step, rank 0
    writes train_state.safetensors, and a resume from it ends with the
    leaves of a straight run;
  - two processes that build into one directory at once (ops/build.py and
    native/build.py, on stub compilers): one compiles, the other waits and
    takes its library.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lora_tpu_torch.models.hf_import import save_pipeline_params  # noqa: E402
from lora_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from lora_tpu_torch.training import dreambooth as t_db  # noqa: E402

from test_torch_port_dp import (  # noqa: E402
    DB,
    REPO,
    launch,
    leaves_of,
    ok,
    tiny_pipe,
    write_images,
)

ENV = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


def _launch_py(*launcher_args, worker, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "lora_tpu_torch.launch", *launcher_args,
         "--", sys.executable, "-c", worker],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=ENV)


WORKER_OK = """
import torch
from lora_tpu_torch.parallel import mesh
assert mesh.initialize_distributed_from_env()
m = mesh.mesh_from_flags(data_parallel=True)
x = torch.tensor([float(mesh.rank() + 1)])
m.all_reduce(x)
print(f"RANK {mesh.rank()} sum={float(x)} dp={m.shape['dp']}")
"""


def test_launch_two_cpu_workers():
    r = _launch_py("--cpu", "--nproc", "2", worker=WORKER_OK)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[p0] RANK 0 sum=3.0 dp=2" in r.stdout
    assert "[p1] RANK 1 sum=3.0 dp=2" in r.stdout
    assert ("[p0] lora_tpu_torch: joined a process group: backend=gloo "
            "world_size=2 devices=['cpu', 'cpu']") in r.stdout


def test_launch_propagates_worker_failure():
    r = _launch_py("--nproc", "2", worker=(
        "import sys, os; sys.exit(3 if os.environ['RANK'] == '1' else 0)"))
    assert r.returncode == 1
    assert "p1=rc3" in r.stderr


def test_launch_fail_fast_terminates_survivors():
    worker = ("import os, signal, sys, time\n"
              "if os.environ['RANK'] == '1':\n"
              "    time.sleep(2)\n"
              "    os._exit(3)\n"
              "def h(s, f):\n"
              "    print('SURVIVOR_TERM', flush=True)\n"
              "    sys.exit(0)\n"
              "signal.signal(signal.SIGTERM, h)\n"
              "time.sleep(300)\n")
    t0 = time.time()
    r = _launch_py("--nproc", "2", "--grace-s", "10", worker=worker)
    assert r.returncode == 1, r.stdout + r.stderr
    assert time.time() - t0 < 60
    assert "p1 exited rc3" in r.stderr
    assert "SURVIVOR_TERM" in r.stdout


def test_launch_fail_fast_kills_hung_survivor_after_grace():
    worker = ("import os, signal, time\n"
              "if os.environ['RANK'] == '1':\n"
              "    time.sleep(2)\n"
              "    os._exit(3)\n"
              "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
              "print('HUNG_READY', flush=True)\n"
              "time.sleep(300)\n")
    t0 = time.time()
    r = _launch_py("--nproc", "2", "--grace-s", "3", worker=worker)
    assert r.returncode == 1, r.stdout + r.stderr
    assert time.time() - t0 < 60
    assert "p0=rc-9" in r.stderr


def test_launch_forwards_sigterm():
    worker = ("import signal, sys, time, os\n"
              "def h(s, f):\n"
              "    print('GOT_TERM rank', os.environ['RANK'], flush=True)\n"
              "    sys.exit(0)\n"
              "signal.signal(signal.SIGTERM, h)\n"
              "print('READY', flush=True)\n"
              "time.sleep(300)\n")
    p = subprocess.Popen(
        [sys.executable, "-m", "lora_tpu_torch.launch", "--nproc", "2", "--",
         sys.executable, "-c", worker], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO, env=ENV)
    ready, lines = 0, []
    while ready < 2:
        line = p.stdout.readline()
        assert line, "".join(lines)
        lines.append(line)
        ready += "READY" in line
    p.send_signal(signal.SIGTERM)
    out, _ = p.communicate(timeout=60)
    assert p.returncode == 0, "".join(lines) + out
    assert "GOT_TERM rank 0" in out and "GOT_TERM rank 1" in out


def test_failed_handshake_raises_on_every_rank():
    """Rank 1 is sent to a port where no rank 0 listens: both ranks raise
    after the handshake timeout (none trains alone), and the launch
    fails. The ranks ignore the launcher's SIGTERM to rank 1 after rank 0
    fails, so that each shows its own error."""
    worker = ("import os, signal, socket\n"
              "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
              "if os.environ['RANK'] == '1':\n"
              "    s = socket.socket(); s.bind(('localhost', 0))\n"
              "    os.environ['MASTER_PORT'] = str(s.getsockname()[1])\n"
              "    s.close()\n"
              "from lora_tpu_torch.parallel import mesh\n"
              "try:\n"
              "    mesh.initialize_distributed_from_env()\n"
              "except Exception as e:\n"
              "    print('HANDSHAKE_FAILED', type(e).__name__, flush=True)\n"
              "    raise\n"
              "print('TRAINING_ALONE', flush=True)\n")
    env_timeout = {mesh_lib.TIMEOUT_ENV: "3"}
    r = subprocess.run(
        [sys.executable, "-m", "lora_tpu_torch.launch", "--cpu", "--nproc",
         "2", "--grace-s", "30", "--", sys.executable, "-c", worker],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**ENV, **env_timeout})
    assert r.returncode == 1, r.stdout + r.stderr
    assert "TRAINING_ALONE" not in r.stdout
    assert "[p0] HANDSHAKE_FAILED" in r.stdout, r.stdout
    assert "[p1] HANDSHAKE_FAILED" in r.stdout, r.stdout


# ---------------------------------------------------------------------------
# the CLIs under the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    save_pipeline_params(tiny_pipe(), str(d / "model"))
    write_images(str(d / "inst"), 2, 0)
    return d


CLI_CASES = {
    "lora_db": (["--instance_prompt", "a photo of sks dog",
                 "--max_train_steps", "2", "--save_steps", "0",
                 "--cached_latents", "--data_parallel"],
                "lora_weight.safetensors"),
    "lora_pti": (["--placeholder_tokens", "<s1>", "--use_template", "object",
                  "--max_train_steps_ti", "1", "--max_train_steps_tuning",
                  "1", "--gradient_accumulation_steps", "1",
                  "--color_jitter", "False", "--data_parallel"],
                 "final_lora.safetensors"),
    "lora_ti": (["--placeholder_token", "<s>", "--max_train_steps", "2",
                 "--unfreeze_lora_step", "1", "--save_steps", "0"],
                "lora_ti_final.safetensors"),
}


@pytest.mark.parametrize("cli", list(CLI_CASES))
def test_cli_under_launcher(model_dir, cli):
    flags, artifact = CLI_CASES[cli]
    out = model_dir / cli
    r = subprocess.run(
        [sys.executable, "-m", "lora_tpu_torch.launch", "--cpu", "--nproc",
         "2", "--", sys.executable, "-m", f"lora_tpu_torch.cli.{cli}",
         "--pretrained_model_name_or_path", str(model_dir / "model"),
         "--instance_data_dir", str(model_dir / "inst"), "--resolution",
         "64", "--lora_rank", "2", "--device", "cpu", "--output_dir",
         str(out), *flags],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={**ENV, "LORA_TPU_ALLOW_HASHED_TOKENIZER": "1"})
    assert r.returncode == 0, r.stdout[-6000:] + r.stderr[-3000:]
    assert "[p0] lora_tpu_torch: joined a process group: backend=gloo " \
        "world_size=2" in r.stdout
    assert (out / artifact).exists(), sorted(os.listdir(out))
    # rank 0 alone logs: one metrics line per logged step
    with open(out / "metrics.jsonl") as f:
        steps = [ln for ln in f if '"step": 1,' in ln]
    assert len(steps) == (2 if cli == "lora_pti" else 1), steps


# ---------------------------------------------------------------------------
# preemption of one rank, then a resume
# ---------------------------------------------------------------------------

PREEMPT = dict(DB, cached_latents=True, data_parallel=True,
               train_batch_size=1, max_train_steps=4, save_steps=0,
               preemption_sync_every=1, save_train_state=True)


def _preempted_rank1_after(k: int):
    """Rank 1 sends itself SIGTERM after its k-th micro-step."""
    real = t_db.make_train_step
    calls = [0]

    def make_train_step(**kw):
        step = real(**kw)

        def hooked(*a, **k2):
            loss = step(*a, **k2)
            calls[0] += 1
            if calls[0] == k and mesh_lib.rank() == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return loss

        return hooked

    t_db.make_train_step = make_train_step
    return real


def worker(argv) -> None:
    torch.set_num_threads(1)
    root = argv[0]
    assert mesh_lib.initialize_distributed_from_env()
    inst = os.path.join(root, "inst")
    straight = t_db.train_dreambooth(tiny_pipe(), t_db.DreamBoothConfig(
        **PREEMPT, instance_data_dir=inst,
        output_dir=os.path.join(root, "straight")))
    real = _preempted_rank1_after(2)
    try:
        pre = t_db.train_dreambooth(tiny_pipe(), t_db.DreamBoothConfig(
            **PREEMPT, instance_data_dir=inst,
            output_dir=os.path.join(root, "pre")))
    finally:
        t_db.make_train_step = real
    resumed = t_db.train_dreambooth(tiny_pipe(), t_db.DreamBoothConfig(
        **PREEMPT, instance_data_dir=inst,
        output_dir=os.path.join(root, "resumed"),
        resume_state=os.path.join(root, "pre", "train_state.safetensors")))
    print(f"RANK {mesh_lib.rank()} preempted={pre['preempted']} "
          f"steps={pre['steps']} resumed_steps={resumed['steps']}",
          flush=True)
    if mesh_lib.is_main_process():
        np.savez(os.path.join(root, "leaves.npz"),
                 *leaves_of(straight["trainable"]),
                 *leaves_of(resumed["trainable"]))


def test_sigterm_to_one_rank_then_resume(tmp_path):
    # one image: the resumed run's sample stream starts again, as in one
    # process, so only with one image is it the straight run's
    write_images(str(tmp_path / "inst"), 1, 0)
    out = ok(launch(__file__, [str(tmp_path)], timeout=240))
    # rank 1 got the signal after micro-step 2; the flags are agreed before
    # micro-step 3, so both ranks stop with 2 steps done
    assert "[p0] RANK 0 preempted=True steps=2 resumed_steps=4" in out, out
    assert "[p1] RANK 1 preempted=True steps=2 resumed_steps=4" in out, out
    pre = sorted(os.listdir(tmp_path / "pre"))
    assert "train_state.safetensors" in pre, pre
    assert "lora_weight_spreempt_2.safetensors" in pre, pre
    assert not any(f.startswith("lora_weight.") for f in pre), pre
    with np.load(tmp_path / "leaves.npz") as z:
        arrays = [z[k] for k in sorted(z.files,
                                       key=lambda k: int(k.split("_")[1]))]
    half = len(arrays) // 2
    for a, b in zip(arrays[:half], arrays[half:]):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# the build lock
# ---------------------------------------------------------------------------

STUB = textwrap.dedent("""\
    #!{python}
    import sys, time
    with open({log!r}, "a") as f:
        f.write("compile\\n")
    time.sleep(2)
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(out, "wb") as f:
        f.write(b"stub library")
    """)

BUILD_TWICE = """
import sys
which = sys.argv[1]
if which == "native":
    from lora_tpu_torch.native.build import build
    print("PATH", build(), flush=True)
else:
    from lora_tpu_torch.ops.build import build
    print("PATH", build(["adam8bit"])["adam8bit"], flush=True)
"""


@pytest.mark.parametrize("which", ["native", "ops"])
def test_build_lock_one_process_compiles(tmp_path, which):
    log = tmp_path / "compiles.log"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / ("cc" if which == "native" else "nvcc")
    stub.write_text(STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    env = {**ENV, "LORA_TPU_TORCH_BUILD_DIR": str(tmp_path / "build"),
           "CC": str(stub), "PATH": f"{bindir}{os.pathsep}{ENV['PATH']}",
           "CUDA_HOME": str(tmp_path / "no_cuda")}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_TWICE, which],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.split("PATH ")[1].strip() for out, _ in outs}
    assert len(paths) == 1
    with open(paths.pop(), "rb") as f:
        assert f.read() == b"stub library"
    assert log.read_text() == "compile\n"


STAMP_STUB = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    src = os.path.basename(sys.argv[-1])
    with open({log!r}, "a") as f:
        f.write(f"start {{src}} {{time.time()}}\\n")
    time.sleep(2)
    with open(out, "wb") as f:
        f.write(b"stub library")
    with open({log!r}, "a") as f:
        f.write(f"end {{src}} {{time.time()}}\\n")
    """)

BUILD_THREADS = """
import threading
from lora_tpu_torch.ops.build import build
paths = {}
def run(i, stem):
    paths[i] = build([stem])[stem]
threads = [threading.Thread(target=run, args=(i, s)) for i, s in
           enumerate(["adam8bit", "int8_matmul", "adam8bit"])]
for t in threads:
    t.start()
for t in threads:
    t.join()
print("PATHS", paths[0] == paths[2], paths[0] != paths[1], flush=True)
"""


def test_build_lock_sources_build_side_by_side(tmp_path):
    """Threads of one process building two sources at once compile them
    side by side (each source's lock alone held), while two threads asking
    for the same source compile it once."""
    log = tmp_path / "compiles.log"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "nvcc"
    stub.write_text(STAMP_STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    env = {**ENV, "LORA_TPU_TORCH_BUILD_DIR": str(tmp_path / "build"),
           "PATH": f"{bindir}{os.pathsep}{ENV['PATH']}",
           "CUDA_HOME": str(tmp_path / "no_cuda")}
    proc = subprocess.run([sys.executable, "-c", BUILD_THREADS],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "PATHS True True" in proc.stdout
    events = [line.split() for line in log.read_text().splitlines()]
    spans = {}
    for kind, src, t in events:
        spans.setdefault(src, {}).setdefault(kind, []).append(float(t))
    assert sorted(spans) == ["adam8bit.cu", "int8_matmul.cu"]
    assert all(len(v["start"]) == 1 for v in spans.values())
    a, b = spans["adam8bit.cu"], spans["int8_matmul.cu"]
    assert a["start"][0] < b["end"][0] and b["start"][0] < a["end"][0]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(sys.argv[2:])
