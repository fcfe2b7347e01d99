"""The port's DreamBooth trainer on SDXL against lora_tpu's, continued
from tests/test_torch_port_sdxl_train_db.py (its helpers and checks): the
recipe's flags (recipes/run_lora_db_xl.sh), both text encoders trained
with gradient checkpointing on uncached latents. A file of its own, so
that this run takes a test worker of its own.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_port_sdxl_train_db import (  # noqa: E402, F401
    CASES,
    _one_torch_thread,
    check_train_dreambooth_xl,
    params,
)

CASES_HERE = ("text_remat",)


@pytest.mark.parametrize("case", CASES_HERE)
def test_train_dreambooth_xl_matches_jax(case, params, tmp_path,  # noqa: F811
                                         monkeypatch):
    check_train_dreambooth_xl(case, params, tmp_path, monkeypatch)


def test_cases_are_split_without_overlap():
    """The two files' cases cover CASES once each."""
    import test_torch_port_sdxl_train_db as a

    assert sorted(a.CASES_HERE + CASES_HERE) == sorted(CASES)
