"""The port's training loss against lora_tpu's, continued from
tests/test_torch_port_training.py (its helpers and cases): cached
latents, v-prediction, and prior preservation with per-row instance
flags. A file of its own, so that its JAX compiles run on another test
worker.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_port_training import (  # noqa: E402, F401
    CASES,
    _one_torch_thread,
    bases,
    check_loss_step,
)

CASES_HERE = ("cached", "v_prediction", "prior_is_instance")


@pytest.mark.parametrize("case", CASES_HERE)
def test_loss_step_matches_jax(bases, case):  # noqa: F811
    check_loss_step(bases, case)


def test_cases_are_split_without_overlap():
    """The three files' cases cover CASES once each."""
    import test_torch_port_loss_uncached as b
    import test_torch_port_training as a

    cases = a.CASES_HERE + b.CASES_HERE + CASES_HERE
    assert sorted(cases) == sorted(CASES)
