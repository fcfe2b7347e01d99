"""Window arithmetic on the host clock: group completions, rates and tails.

A served group's requests complete together (the server sets all of a
group's results at once; each client then encodes its own PNG), so
completions closer than `gap_s` are one group. The rate of a window is the
images of the groups completed in it after the first, over the time from
the first group's completion to the last's: it does not depend on where
the window's edges cut a group.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple


def groups(times: Sequence[float], gap_s: float) -> List[List[float]]:
    """Completion times split into groups at gaps longer than gap_s."""
    out: List[List[float]] = []
    for t in sorted(times):
        if out and t - out[-1][-1] <= gap_s:
            out[-1].append(t)
        else:
            out.append([t])
    return out


def group_rate(done: Sequence[Tuple[float, int]], t0: float, t1: float,
               gap_s: float, cut: Optional[Tuple[float, float]] = None
               ) -> Tuple[float, int, float]:
    """(images per second, images counted, seconds spanned) over the groups
    whose last completion lies in [t0, t1]; done holds (completion time,
    images) per request. With cut = (a, b), groups completed in [a, b] are
    left out and each side of the cut is reckoned on its own: a group that
    ran while the cut held the program up only anchors the span after it."""
    per_time = {}
    for t, n in done:
        per_time[t] = per_time.get(t, 0) + n
    every = groups(per_time, gap_s)
    spans = [(t0, t1)] if cut is None else [(t0, cut[0]), (cut[1], t1)]
    images, span = 0, 0.0
    for a, b in spans:
        gs = [g for g in every if a <= g[-1] <= b]
        if len(gs) < 2:
            continue
        images += sum(per_time[t] for g in gs[1:] for t in g)
        span += gs[-1][-1] - gs[0][-1]
    if span <= 0:
        return float("nan"), 0, 0.0
    return images / span, images, span


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile by nearest rank (the value at rank ceil(q n))."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]
