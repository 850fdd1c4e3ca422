"""Numpy face of :mod:`dbaf_tpu_torch.ops.lie` for host bookkeeping.

The host side of the coupled solve -- the IMU pose seed, the cull
hysteresis, the VI alignment's pose rewrite and the synthetic scene -- does
its pose algebra on numpy arrays (7-vectors ``[tx, ty, tz, qx, qy, qz,
qw]``), with no device round trip.  Each function here runs the torch
formula of the same name on CPU tensors of the input's dtype (float64 on
the host), so every formula has one implementation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import lie


def _on_numpy(fn):
    @functools.wraps(fn)
    def wrapped(*arrays: np.ndarray) -> np.ndarray:
        return fn(*(torch.tensor(np.ascontiguousarray(a)) for a in arrays)).numpy()
    return wrapped


quat_to_matrix = _on_numpy(lie.quat_to_matrix)
matrix_to_quat = _on_numpy(lie.matrix_to_quat)
se3_mul = _on_numpy(lie.se3_mul)
se3_inv = _on_numpy(lie.se3_inv)
se3_matrix = _on_numpy(lie.se3_matrix)
se3_from_matrix = _on_numpy(lie.se3_from_matrix)
