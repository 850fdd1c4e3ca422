"""Plain proximity edge selection: DROID-SLAM's ``add_proximity_factors``
(``covisible_graph.py``) as DBA-Fusion's scheduler runs it, one loop per
rule, in float64.

Candidates ``k < cc`` lie on a grid of ``src`` source rows (frames
``t0 ...``) by ``win`` target columns (frames ``t1 ...``); the candidates
from ``cc`` on are skip edges.  In order:

1. a candidate whose target is not at least ``rad`` frames behind its
   source, or whose distance is over 100, is out;
2. every existing edge (i, j) suppresses the grid cells within Manhattan
   distance ``clamp(|i - j| - 2, 0, nms)`` of (i, j);
3. each source frame i takes the forced edges to its ``rad + 1`` frames
   before it, both ways, and their cells are taken;
4. the candidates in order of distance: one still on the grid, not
   suppressed and within ``thresh`` gives an edge both ways and suppresses
   its neighbours, until more than ``max_factors`` edges are out;
5. the skip candidate of least distance, if within ``thresh`` and above 0,
   gives an edge both ways.

The list is cut at ``max_out`` entries.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def select(d: Sequence[float], ii: Sequence[int], jj: Sequence[int], cc: int,
           exist: Sequence[Tuple[int, int]], t0: int, t1: int, t: int, *, src: int, win: int,
           rad: int, nms: int, thresh: float, max_factors: int,
           max_out: int) -> List[Tuple[int, int]]:
    d = [math.inf if (ii[k] - rad < jj[k] or d[k] > 100.0) else float(d[k])
         for k in range(len(d))]
    grid = d[:cc]

    def cell(i, j):
        gi, gj = i - t0, j - t1
        if 0 <= gi < src and i < t and 0 <= gj < win and j < t:
            return gi * win + gj
        return None

    def suppress(i, j):
        r = max(min(abs(i - j) - 2, nms), 0)
        for di in range(-nms, nms + 1):
            for dj in range(-nms, nms + 1):
                c = cell(i + di, j + dj)
                if abs(di) + abs(dj) <= r and c is not None:
                    grid[c] = math.inf

    for i, j in exist:
        suppress(int(i), int(j))
    out: List[Tuple[int, int]] = []
    for i in range(t0, min(t0 + src, t)):
        for j in range(max(i - rad - 1, 0), i):
            out += [(i, j), (j, i)]
            c = cell(i, j)
            if c is not None:
                grid[c] = math.inf
    for k in sorted(range(len(d)), key=lambda k: d[k]):
        if k >= cc or grid[k] > thresh:
            continue
        if min(len(out), max_out) > max_factors:
            break
        i, j = int(ii[k]), int(jj[k])
        out += [(i, j), (j, i)]
        suppress(i, j)
    if len(d) > cc:
        k = min(range(cc, len(d)), key=lambda k: d[k])
        if thresh > d[k] > 0:
            out += [(int(ii[k]), int(jj[k])), (int(jj[k]), int(ii[k]))]
    return out[:max_out]


def mismatches(prog: Sequence[Tuple[int, int]], ref: Sequence[Tuple[int, int]]) -> int:
    """Positions at which two edge lists differ, the longer's tail included."""
    n = max(len(prog), len(ref))
    return sum(1 for k in range(n)
               if k >= len(prog) or k >= len(ref) or tuple(prog[k]) != tuple(ref[k]))
