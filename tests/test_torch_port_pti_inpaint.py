"""The port's pivotal tuning trainer against lora_tpu's on a 9-channel
inpainting UNet (the seams and checks of tests/test_torch_port_pti.py):
train_inpainting with random cutout holes, cached (the masked-image
latents and the latent-resolution hole mask encoded once) and uncached
(both images through the VAE at every micro-step, the masked image's
posterior noise handed in from lora_tpu's key)."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_port_pti import (  # noqa: E402, F401
    BASE,
    INPAINT_UNET,
    _one_torch_thread,
    base_params,
    check_same_run,
    run_both,
)
from _torch_port_threads import _one_torch_thread  # noqa: E402, F401

CASES = {"cached": dict(train_inpainting=True),
         "uncached": dict(train_inpainting=True, cached_latents=False)}


@pytest.fixture(scope="module")
def params():
    return base_params(INPAINT_UNET)


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    return {case: run_both(dict(BASE, **flags), params,
                           tmp_path_factory.mktemp(case), INPAINT_UNET)
            for case, flags in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_inpainting_pti_matches_jax(case, runs):
    names = check_same_run(case, *runs[case])
    assert names == ["final_lora.safetensors", "metrics.jsonl",
                     "step_2.safetensors", "step_inv_2.safetensors"]
