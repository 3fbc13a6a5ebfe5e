"""Device choice for the port's entry points.

Entry points default to ``cuda`` and raise when it is missing: a run
asked for (or defaulted to) the card never quietly continues on the CPU.
Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch.device to run on: ``device``, or ``cuda`` when None.

    Also pins float32 matrix products and convolutions to full f32
    (TF32 off): the serve engine is f32 throughout and its card-vs-CPU
    parity checks assume so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (the port's default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
