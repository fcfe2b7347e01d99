"""The port's packaging: its own distribution (lora_tpu_torch/pyproject.toml)
stands alone, the wheels carry the CUDA sources the kernels are built from,
and an installed (read-only) package builds them elsewhere."""

import os
import shutil
import subprocess
import sys
import zipfile

import pytest

torch = pytest.importorskip("torch")

from lora_tpu_torch.ops import build as t_build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "lora_tpu_torch", "ops", "csrc")


def test_wheel_carries_the_kernel_sources(tmp_path):
    """`pip wheel` of a copy of setup.py, setup.cfg and lora_tpu_torch/
    packs every csrc/*.cu and *.cuh beside ops/build.py; nothing is written
    into the repository."""
    src = tmp_path / "src"
    src.mkdir()
    for name in ("setup.py", "setup.cfg"):
        shutil.copy(os.path.join(REPO, name), src / name)
    shutil.copytree(os.path.join(REPO, "lora_tpu_torch"),
                    src / "lora_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = sorted(os.listdir(REPO))
    env = dict(os.environ, PIP_NO_CACHE_DIR="1",
               PIP_DISABLE_PIP_VERSION_CHECK="1")
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "-w", str(tmp_path / "dist"),
         str(src)],
        check=True, capture_output=True, cwd=tmp_path, env=env, timeout=300)
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    sources = {f"lora_tpu_torch/ops/csrc/{n}" for n in os.listdir(CSRC)
               if n.endswith((".cu", ".cuh"))}
    assert any(n.endswith(".cuh") for n in sources)
    assert any(n.endswith("flash_fwd_wgmma.cu") for n in sources)
    assert sources <= names, sorted(sources - names)
    assert "lora_tpu_torch/ops/build.py" in names
    assert "lora_tpu_torch/native/imgops.c" in names
    # what a wheel build writes beside its setup.py (other tests running
    # at the same time may add caches to the repository root)
    made = set(os.listdir(REPO)) - set(before)
    assert not {n for n in made
                if n in ("build", "dist") or n.endswith(".egg-info")}, made


def test_port_wheel_stands_alone(tmp_path):
    """`pip wheel` of lora_tpu_torch/ alone (its own pyproject.toml) builds
    offline a wheel that requires torch and numpy, not jax; whose console
    scripts start the port's server, its DreamBooth, PTI and TI trainers,
    its lora_add, lora_distill and kohya-converter tools and its
    multi-process launcher; that carries
    every package of the port and every csrc source (the blockwise-int8
    Adam's among them), the SDXL pipeline, the native resize's C source,
    and nothing of lora_tpu."""
    pkg = os.path.join(REPO, "lora_tpu_torch")
    src = tmp_path / "lora_tpu_torch"
    shutil.copytree(pkg, src, ignore=shutil.ignore_patterns(
        "_build", "__pycache__", "build", "*.egg-info"))
    env = dict(os.environ, PIP_NO_CACHE_DIR="1",
               PIP_DISABLE_PIP_VERSION_CHECK="1")
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "-w", str(tmp_path / "dist"),
         str(src)],
        check=True, capture_output=True, cwd=tmp_path, env=env, timeout=300)
    (wheel,) = (tmp_path / "dist").glob("lora_tpu_torch-*.whl")
    zf = zipfile.ZipFile(wheel)
    names = set(zf.namelist())
    info = next(n.split("/")[0] for n in names if n.endswith("/METADATA"))
    meta = zf.read(f"{info}/METADATA").decode()
    requires = sorted(line.split(":", 1)[1].strip()
                      for line in meta.splitlines()
                      if line.startswith("Requires-Dist:"))
    assert requires == ["numpy", "torch"], requires
    scripts = zf.read(f"{info}/entry_points.txt").decode()
    assert "lora_serve_torch = lora_tpu_torch.serve:main" in scripts
    assert "lora_db_torch = lora_tpu_torch.cli.lora_db:main" in scripts
    assert "lora_pti_torch = lora_tpu_torch.cli.lora_pti:main" in scripts
    assert "lora_ti_torch = lora_tpu_torch.cli.lora_ti:main" in scripts
    assert "lora_add_torch = lora_tpu_torch.cli.lora_add:main" in scripts
    assert ("lora_distill_torch = lora_tpu_torch.cli.lora_distill:main"
            in scripts)
    assert ("lora_kohya_torch = lora_tpu_torch.cli.kohya_convert:main"
            in scripts)
    assert "lora_launch_torch = lora_tpu_torch.launch:main" in scripts
    assert "lora_tpu." not in scripts, scripts
    assert not {n for n in names if n.startswith("lora_tpu/")}
    packages = {os.path.relpath(d, REPO) for d, _, files in os.walk(pkg)
                if "__init__.py" in files}
    carried = {os.path.dirname(n) for n in names if n.endswith("__init__.py")}
    assert carried == packages, sorted(packages ^ carried)
    sources = {f"lora_tpu_torch/ops/csrc/{n}" for n in os.listdir(CSRC)
               if n.endswith((".cu", ".cuh"))}
    assert sources <= names, sorted(sources - names)
    assert "lora_tpu_torch/ops/csrc/adam8bit.cu" in names
    assert "lora_tpu_torch/pipelines/sdxl.py" in names
    assert {"lora_tpu_torch/launch.py",
            "lora_tpu_torch/parallel/mesh.py"} <= names
    assert "lora_tpu_torch/native/imgops.c" in names
    assert {n.split("/")[0] for n in names} == {"lora_tpu_torch", info}


def test_build_dir_override_and_read_only_package(tmp_path, monkeypatch):
    """$LORA_TPU_TORCH_BUILD_DIR decides where libraries are built; without
    it a writable package builds beside its sources and a read-only one
    under the user's cache directory."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// a\n")
    pkg = tmp_path / "site" / "lora_tpu_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setattr(t_build, "_CSRC_DIR", str(src))
    monkeypatch.setattr(t_build, "_BUILD_DIR", str(pkg / "_build"))
    monkeypatch.setattr(t_build, "_find_nvcc", lambda: "nvcc")

    class Proc:  # nvcc that "builds" by writing its output file
        returncode = 0

        def __init__(self, cmd, **kw):
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            return "", ""

        def poll(self):
            return 0

    monkeypatch.setattr(t_build.subprocess, "Popen", Proc)
    override = tmp_path / "kernels"
    monkeypatch.setenv(t_build.BUILD_DIR_ENV, str(override))
    assert t_build.build_dir() == str(override)
    path = t_build.build(["a"])["a"]
    assert os.path.dirname(path) == str(override) and os.path.exists(path)
    assert not (pkg / "_build").exists()

    monkeypatch.delenv(t_build.BUILD_DIR_ENV)
    assert t_build.build_dir() == str(pkg / "_build")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    access = os.access
    monkeypatch.setattr(t_build.os, "access", lambda p, mode: (
        False if str(p).startswith(str(pkg)) else access(p, mode)))
    cache = tmp_path / "cache" / "lora_tpu_torch" / "build"
    assert t_build.build_dir() == str(cache)
    assert os.path.dirname(t_build.build(["a"])["a"]) == str(cache)
