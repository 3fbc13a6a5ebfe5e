"""Model-FLOPs accounting and MFU against the card's published peak.

Port of ``tf_operator_tpu/train/metrics.py:42-143``. The peak table holds
NVIDIA data-sheet dense bf16 rates (tensor cores, no sparsity), chosen by
``torch.cuda.get_device_name``; a card that is not in the table raises
rather than getting a guessed peak.
"""

from __future__ import annotations

from typing import Optional

import torch

# (marker in the device name, dense bf16 FLOP/s), most specific first.
_PEAK_BF16_FLOPS = (
    ("H100 PCIE", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),  # SXM: "NVIDIA H100 80GB HBM3"
    ("H200", 989e12),
    ("A100", 312e12),
)


def peak_flops_per_chip(device: Optional[torch.device] = None) -> float:
    """Dense bf16 peak FLOP/s of the CUDA card ``device`` (default: the
    current one). Raises for a card outside the table and off CUDA."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no peak FLOP/s for device {dev}: MFU is a CUDA-card metric")
    name = torch.cuda.get_device_name(dev).upper()
    for marker, flops in _PEAK_BF16_FLOPS:
        if marker in name:
            return flops
    raise ValueError(f"no published bf16 peak known for card {name!r}")


def mfu(model_flops_per_step: float, step_seconds: float, n_chips: int,
        device: Optional[torch.device] = None) -> float:
    """Model FLOPs utilization: achieved / peak."""
    return model_flops_per_step / (step_seconds * peak_flops_per_chip(device) * n_chips)


def transformer_train_flops(n_params: int, tokens_per_step: int) -> float:
    """6ND: forward 2ND + backward 4ND. Excludes the attention score and
    value products, which scale with sequence length (see _exact)."""
    return 6.0 * n_params * tokens_per_step


def attention_train_flops(n_layers: int, d_model: int, seq_len: int,
                          tokens_per_step: int) -> float:
    """Attention products, PaLM appendix-B accounting: 12·L·t·d per token
    for forward plus backward, over the full t² score matrix even when
    causal (a kernel that skips masked tiles then shows as a higher MFU)."""
    return 12.0 * n_layers * seq_len * d_model * tokens_per_step


def transformer_train_flops_exact(n_params: int, tokens_per_step: int, n_layers: int,
                                  d_model: int, seq_len: int) -> float:
    """6ND plus the attention term."""
    return transformer_train_flops(n_params, tokens_per_step) + attention_train_flops(
        n_layers, d_model, seq_len, tokens_per_step)


def resnet_train_flops(fwd_flops_per_image: float, images_per_step: int) -> float:
    """Training ~ 3x forward."""
    return 3.0 * fwd_flops_per_image * images_per_step
