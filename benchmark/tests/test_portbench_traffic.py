"""The traffic generator and the window arithmetic."""

import numpy as np

from benchmark import inputs, windows


def _mix(rate):
    return {"rate_per_s": rate, "arrival_seed": 7}


def test_arrivals_rate_and_seed():
    a = inputs.arrivals(_mix(2.5), 40.0, 11)
    assert len(a) == 100
    assert a[0] == 0.0 and a[-1] < 40.0 and np.all(np.diff(a) > 0)
    assert np.array_equal(a, inputs.arrivals(_mix(2.5), 40.0, 11))
    b = inputs.arrivals(_mix(2.5), 40.0, 2**31 + 5)
    assert not np.array_equal(a, b)
    # the same gaps in another order: every seed offers the same load
    ga = np.sort(np.diff(np.append(a, 40.0)))
    gb = np.sort(np.diff(np.append(b, 40.0)))
    assert abs(a[-1] + ga.max() - (b[-1] + gb.max())) < 40.0
    assert np.allclose(np.sort(np.diff(a)).sum() + 0, np.diff(a).sum())
    assert abs(len(a) / 40.0 - 2.5) < 1e-9


def test_zipf_prefers_the_first_prompts():
    rng = np.random.default_rng(0)
    k = inputs.zipf_choices(rng, 64, 1.1, 20000)
    counts = np.bincount(k, minlength=64)
    assert counts[0] > counts[1] > counts[10] > 0


def test_group_rate_does_not_depend_on_where_the_window_cuts():
    rng = np.random.default_rng(3)
    done = []
    for g in range(40):  # a group of 8 every 2.5 s, members within 80 ms
        t = 1.0 + 2.5 * g
        done += [(t + rng.uniform(0, 0.08), 1) for _ in range(8)]
    rates = []
    for start in np.linspace(0.5, 3.0, 11):  # windows cut anywhere
        r, n, span = windows.group_rate(done, start, start + 40.0, 0.3)
        rates.append(r)
        assert n % 8 == 0
    assert max(rates) / min(rates) < 1.01
    assert abs(np.mean(rates) - 8 / 2.5) < 0.05


def test_group_rate_leaves_out_a_stalled_span():
    """Groups every 2.5 s, but none from 10 s to 22 s (a stall); with the
    stall cut out the rate is the groups' own."""
    done = []
    for g in range(40):
        t = 1.0 + 2.5 * g
        if 10.0 <= t <= 22.0:
            continue
        done += [(t + 0.01 * k, 1) for k in range(8)]
    stalled = windows.group_rate(done, 0.0, 60.0, 0.3)[0]
    rate, n, _ = windows.group_rate(done, 0.0, 60.0, 0.3, cut=(9.0, 23.0))
    assert stalled < 0.8 * 8 / 2.5
    assert abs(rate - 8 / 2.5) < 0.05 and n % 8 == 0


def test_nearest_rank():
    v = list(range(1, 101))
    assert windows.nearest_rank(v, 0.9) == 90
    assert windows.nearest_rank(v[:11], 0.9) == 10
