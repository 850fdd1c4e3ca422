"""TUM-format trajectory files, ``t x y z qx qy qz qw`` [+ ECEF x y z]
(port of ``dbaf_tpu/eval/traj_io.py``).

The reference writes this format per keyframe (dbaf_frontend.py:179-186,
266-274); its evaluation scripts read it (evaluate_tumvi.py:122-130).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def write_tum(path: str, rows: Iterable[Sequence[float]]) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(f"{x:.6f}" for x in r) + "\n")


def read_tum(path: str) -> np.ndarray:
    """Rows of floats; blank lines and ``#`` comments skipped, commas taken
    as separators."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.replace(",", " ").split()])
    return np.asarray(rows)
