"""The port's training loss against lora_tpu's, continued from
tests/test_torch_port_training.py (its helpers and cases): the uncached
latents (the VAE encode inside the loss) and precomputed text embeddings.
A file of its own, so that its JAX compiles run on another test worker.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_port_training import (  # noqa: E402, F401
    _one_torch_thread,
    bases,
    check_loss_step,
)

CASES_HERE = ("uncached", "precomputed_embeddings")


@pytest.mark.parametrize("case", CASES_HERE)
def test_loss_step_matches_jax(bases, case):  # noqa: F811
    check_loss_step(bases, case)
