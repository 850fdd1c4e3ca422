"""Numpy face of :mod:`dbaf_tpu_torch.ops.lie` for host bookkeeping.

The host side of the coupled solve -- the IMU pose seed, the cull
hysteresis, the VI alignment's pose rewrite and the synthetic scene -- does
its pose algebra on numpy arrays (7-vectors ``[tx, ty, tz, qx, qy, qz,
qw]``), with no device round trip.  Every public function of ``ops/lie``
has a twin here of the same name (as ``dbaf_tpu/ops/lie_np.py`` derives
them from its ``ops/lie``), which runs the torch formula on CPU tensors of
the input's dtype (float64 on the host), so every formula has one
implementation.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

from . import lie


def _on_numpy(fn):
    @functools.wraps(fn)
    def wrapped(*arrays: np.ndarray) -> np.ndarray:
        return fn(*(torch.tensor(np.ascontiguousarray(a)) for a in arrays)).numpy()
    return wrapped


def se3_identity(shape=(), dtype=np.float32) -> np.ndarray:
    """Identity poses of shape ``shape + (7,)`` in numpy ``dtype``."""
    return lie.se3_identity(shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype).numpy()


_exported = [name for name, fn in inspect.getmembers(lie, inspect.isfunction)
             if not name.startswith("_") and fn.__module__ == lie.__name__]
globals().update({name: _on_numpy(getattr(lie, name))
                  for name in _exported if name != "se3_identity"})
__all__ = _exported
