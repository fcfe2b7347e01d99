"""train_dreambooth with the v target (SD-2.1 768-v's objective) in the
port against lora_tpu's, in float32 on the tiny SD-2 configs with the
published 768-v schedule: 2 steps from cached latents and a starting UNet
LoRA written by lora_tpu's save_all, lora_tpu's draws handed in through
test_torch_port_dreambooth.py's seams. A file of its own beside
test_torch_port_sd21.py, whose pipes it shares: its JAX train step's
compile takes most of a minute."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lora_tpu.core.save import save_all as j_save_all  # noqa: E402
from lora_tpu.core.sites import unet_lora_sites  # noqa: E402
from lora_tpu.models import config as j_cfg  # noqa: E402
from lora_tpu.training import dreambooth as j_db  # noqa: E402
from lora_tpu_torch.convert import trainable_to_numpy  # noqa: E402
from lora_tpu_torch.training import dreambooth as t_db  # noqa: E402

from test_torch_port_dreambooth import (  # noqa: E402
    hand_in_jax_draws,
    write_images,
)
from test_torch_port_sd21 import pipes  # noqa: E402, F401
from test_torch_port_training import random_lora  # noqa: E402
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401


def test_train_dreambooth_v_target_matches_jax(pipes, tmp_path, monkeypatch):
    """train_dreambooth for 2 steps on the v-prediction pipes (cached
    latents, a starting UNet LoRA written by lora_tpu's save_all), with
    lora_tpu's draws handed in: the same losses and final LoRA."""
    jpipe, pipe = pipes
    sites = unet_lora_sites(j_cfg.TINY_SD2_UNET)
    start = str(tmp_path / "start.pt")
    j_save_all(start, lora_unet=random_lora(sites, 1, r=2, scale=1.0),
               unet_sites=sites, lora_text=None, text_sites=[],
               save_ti=False, safe_form=False)
    flags = dict(resolution=64, lora_rank=2, max_train_steps=2,
                 save_steps=10, seed=0, instance_prompt="a photo of sks dog",
                 learning_rate=1e-4, cached_latents=True, resume_unet=start,
                 instance_data_dir=write_images(tmp_path / "inst", 2, 0))
    hand_in_jax_draws(monkeypatch, flags["seed"])
    j_res = j_db.train_dreambooth(jpipe, j_db.DreamBoothConfig(
        **flags, output_dir=str(tmp_path / "out_jax")))
    t_res = t_db.train_dreambooth(pipe, t_db.DreamBoothConfig(
        **flags, output_dir=str(tmp_path / "out_torch")))
    assert t_res["steps"] == j_res["steps"] == 2
    np.testing.assert_allclose(t_res["final_loss"], j_res["final_loss"],
                               rtol=1e-4)
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        np.asarray, j_res["trainable"]["lora_unet"]))
    got = dict(jax.tree_util.tree_leaves_with_path(
        trainable_to_numpy(t_res["trainable"])["lora_unet"]))
    w = np.concatenate([np.ravel(x) for _, x in want])
    g = np.concatenate([np.ravel(got[path]) for path, _ in want])
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-4
