"""Device resolution and numeric pins for the PyTorch port.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no device given and no card present they raise
rather than drop to the CPU quietly.
"""

from __future__ import annotations

import torch


def pin_precision() -> None:
    """Full-f32 matmuls and convolutions.

    The JAX package pins ``jax_default_matmul_precision="highest"``: a
    single-pass (TF32/bf16) product costs −52 dB against the golden, far
    outside the −80 dBFS budget (CLAUDE.md).  The bus contraction and the
    listener transforms are f32 products, so the port pins the same."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card, raising when there is none; otherwise the
    device the caller named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
