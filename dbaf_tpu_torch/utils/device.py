"""Device resolution for the port's entry points.

Entry points default to the card.  Without one they raise instead of
falling back to the CPU; the CPU runs only where a caller asks for it
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dbaf_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        configure_cuda_numerics()
    return dev


def configure_cuda_numerics() -> None:
    """Full-f32 matrix products and convolutions on the card.

    The dense-BA Gram products and Schur complement are solver-grade (the
    JAX package runs them at ``Precision.HIGHEST``), and TF32 keeps only
    about three decimal digits, so both switches are off: matmuls
    (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
    (``torch.backends.cudnn.allow_tf32``, which PyTorch turns on by
    default).  The network's bf16 convolutions are unaffected; the f32
    network used for parity checks stays exact.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
