"""`correct` comes out false when the timed path is broken underneath:
each fault a cell can have, planted in the program, drives the rest of a
run (the look for a chip skipped) at the tiny size against the cell's own
limits; and the control (the reference in fp8 operands in the program's
place) fails them too, here and, marked `card`, at the cell's size."""

import numpy as np
import pytest

from benchmark import compare, run
from benchmark.tests.tiny import TINY, bench_with_all_cells, tiny_mix

BENCH = bench_with_all_cells(run.manifest())
SERVE_CELLS = [w["name"] for w in BENCH["workloads"]
               if not w["traffic"].startswith("db_")]
TRAIN_CELLS = [w["name"] for w in BENCH["workloads"]
               if w["traffic"].startswith("db_")]


def _run(cell, mix_name, **over):
    return run.run_cell(BENCH, cell, 77, 1.5, False, "cpu", cfg=TINY,
                        mix=tiny_mix(mix_name, **over))


def _mix_of(cell):
    return run.cell_entry(BENCH, cell)["traffic"]



@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_sound_run_passes_the_check(cell):
    r = _run(cell, _mix_of(cell), **({"rate_per_s": 3.0}
                                     if "open" in cell else {}))
    assert compare.verdict({k: v["value"] for k, v in r["checks"].items()},
                           compare.limits(cell))


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    """A group's images handed to the wrong requests (rotated by one)."""
    from lora_tpu_torch import serve

    real = serve.PipelineServer._scatter

    def rotated(group, counts, imgs):
        real(group, counts, np.roll(imgs, 1, axis=0))

    monkeypatch.setattr(serve.PipelineServer, "_scatter",
                        staticmethod(rotated))
    r = _run(cell, _mix_of(cell), **({"rate_per_s": 8.0}
                                     if "open" in cell else {}))
    assert r["correct"] is False


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_one_batch_row_altered(cell, monkeypatch):
    """Only the last row of each group comes back wrong (its image
    inverted): the check covers every row of a group, so it cannot miss
    that row."""
    from lora_tpu_torch import serve

    real = serve.PipelineServer._scatter

    def last_row_wrong(group, counts, imgs):
        imgs = np.array(imgs, copy=True)
        last = sum(counts) - 1  # the rows after it pad the bucket
        imgs[last] = 1.0 - imgs[last]
        real(group, counts, imgs)

    monkeypatch.setattr(serve.PipelineServer, "_scatter",
                        staticmethod(last_row_wrong))
    r = _run(cell, _mix_of(cell), **({"rate_per_s": 8.0}
                                     if "open" in cell else {}))
    assert r["correct"] is False


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_state_left_unchanged(cell, monkeypatch):
    from lora_tpu_torch.training import optim

    monkeypatch.setattr(optim.GroupedAdamW, "step",
                        lambda self: self.zero_grad())
    r = _run(cell, _mix_of(cell))
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert r["correct"] is False


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_half_batch_left_out(cell, monkeypatch):
    """Every other row of the batch reaches the loss, its mean over them."""
    import lora_tpu_torch.training.train_step as ts

    make = ts.make_train_step

    def halved(**kw):
        fn = make(**kw)

        def step(trainable, base, batch, generator=None, **draws):
            return fn(trainable, base, {k: v[::2] for k, v in batch.items()},
                      generator, **{k: v[::2] for k, v in draws.items()})
        return step

    monkeypatch.setattr(ts, "make_train_step", halved)
    r = _run(cell, _mix_of(cell))
    assert r["correct"] is False


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_check_at_tiny_size(cell, tmp_path):
    from benchmark.serving import ServeCell
    from benchmark.training import TrainCell

    mix = tiny_mix(_mix_of(cell), **({"rate_per_s": 3.0}
                                      if "open" in cell else {}))
    cls = TrainCell if mix["runner"] == "train_db" else ServeCell
    c = cls(TINY, mix, 5, "cpu", str(tmp_path))
    c.setup()
    if mix["runner"] != "train_db":
        c.run(1.0, False)
    c.close()
    assert not compare.verdict(c.check(control=True), compare.limits(cell))


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_check_at_cell_size(cell, card):
    """Three seeds of the control at the cell's own size on the card."""
    import os

    from benchmark import control, inputs

    os.environ["LORA_TPU_TORCH_BUILD_DIR"] = os.path.join(
        run.HERE, "_build")
    w = run.cell_entry(BENCH, cell)
    cfg = inputs.load_json("configs", w["config"] + ".json")
    mix = inputs.load_json("traffic", w["traffic"] + ".json")
    for seed in (9001, 9002, 9003):
        r = control.reading(cfg, mix, seed, "fp8", 6.0, card)
        assert not compare.verdict(r, compare.limits(cell)), r
