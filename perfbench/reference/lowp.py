"""The lower precisions the controls compute in.

``fp8`` rounds a tensor to float8 e4m3 with one scale per tensor (its
largest magnitude to the format's largest, 448), and back to float32:
the next precision below bfloat16.  Products of rounded operands are then
summed in float32, as an fp8 tensor-core product accumulates.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    amax = t.abs().amax()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (t * scale).to(torch.float8_e4m3fn).float() / scale
