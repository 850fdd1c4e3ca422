"""Reading back exported reconstructions (the numpy part of
``dbaf_tpu/eval/visualize.py``): load the ``.pkl`` files that
:func:`dbaf_tpu_torch.eval.export.save_reconstruction` writes, merge their
point blocks, and place camera frusta.  The matplotlib and Open3D viewers
are not ported yet.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np


def load_reconstruction(path: str) -> dict:
    """A reconstruction this package wrote (pickle: load only trusted files)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def merge_points(recon: dict, max_points: int = 500000,
                 z_clip: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Every keyframe's points and colours, (M, 3) each, points at or above
    ``z_clip`` dropped; above ``max_points`` a seeded random subset."""
    pts_all, clr_all = [], []
    for entry in recon["points"].values():
        pts = np.asarray(entry["pts"])
        clr = np.asarray(entry["clr"])
        if len(pts) == 0:
            continue
        if z_clip is not None:
            m = pts[:, 2] < z_clip
            pts, clr = pts[m], clr[m]
        pts_all.append(pts)
        clr_all.append(clr)
    if not pts_all:
        return np.zeros((0, 3)), np.zeros((0, 3))
    pts = np.concatenate(pts_all)
    clr = np.concatenate(clr_all)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts, clr = pts[sel], clr[sel]
    return pts, clr


def camera_frustum(T: np.ndarray, scale: float = 0.1) -> np.ndarray:
    """The 5 points of a camera frustum wireframe (centre, 4 corners) in
    world coordinates, for a camera-to-world ``T`` (4, 4)."""
    corners = scale * np.array([[-1, -0.75, 1.5], [1, -0.75, 1.5], [1, 0.75, 1.5],
                                [-1, 0.75, 1.5]])
    pts = np.vstack([np.zeros(3), corners])
    return pts @ T[:3, :3].T + T[:3, 3]
