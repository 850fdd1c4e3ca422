"""Seeded DROID weights in the reference checkpoint's format, made on the
device in one draw.

The recipe is that of ``dbaf_tpu_torch/models/convert.py:150-165``
(``synth_reference_state_dict``, the port at commit fc1ed8f): conv kernels
N(0, 1/fan_in), norm scales 1 + 0.1 N, other vectors 0.02 N.  Here one
``torch.randn`` on the device draws every leaf at once from a generator on
the card, so the weights are made where they are served.  The keys and
shapes are the published checkpoint's, ``perfbench/data/droid_sd_manifest.json``
(a copy of ``tests/data/droid_sd_manifest.json``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import torch

MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "droid_sd_manifest.json")


def manifest() -> List[Tuple[str, Tuple[int, ...]]]:
    with open(MANIFEST) as f:
        return [(k, tuple(s)) for k, s in json.load(f)]


def reference_state_dict(seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, f32 on ``device``, by reference key."""
    leaves = [(k, s) for k, s in manifest() if s and not k.endswith("num_batches_tracked")]
    sizes = [int(torch.Size(s).numel()) for _, s in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    sd = {}
    for (key, shape), part in zip(leaves, torch.split(flat, sizes)):
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            sd[key] = part.reshape(shape) / fan_in ** 0.5
        elif len(shape) == 1 and key.endswith(".weight"):
            sd[key] = 1.0 + 0.1 * part
        elif len(shape) == 1:
            sd[key] = 0.02 * part
        else:
            sd[key] = 0.1 * part.reshape(shape)
    return sd
