"""Decoder transformer family (Llama-2 recipe) — what serving needs.

Port of ``tf_operator_tpu/models/transformer.py``: the config and its
presets (same numbers), parameter init (same tree, keys, stacked
``[L, ...]`` shapes and distributions), RMSNorm and rotary embeddings at
absolute positions. The full forward, the loss and the remat modes come
with the training slice.

Init draws from an explicit ``torch.Generator``; it cannot reproduce
``jax.random``'s bits, so parity tests convert the JAX package's params
(``compat.params_from_numpy``) instead of re-seeding.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict

import torch

from tf_operator_tpu_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class TransformerConfig:
    """Same fields as the JAX config except ``dtype``: the port's serving
    path is f32 throughout. Training-only fields are kept so every
    workload dict that configures the JAX package configures this one."""

    vocab: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq: int = 4096
    causal: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    remat: Any = True
    attn_impl: str = "dense"
    cp_axis: str = "cp"
    fused_xent: bool = True
    n_experts: int = 0
    moe_top_k: int = 1
    capacity_factor: float = 2.0
    ep_axis: str = "ep"
    moe_dispatch: str = "sort"
    moe_aux_weight: float = 0.01
    moe_zloss_weight: float = 1e-3
    pp_microbatches: int = 0
    pp_axis: str = "pp"
    pp_schedule: str = "1f1b"
    pp_chunks: int = 1

    def __post_init__(self):
        if self.n_experts and not (1 <= self.moe_top_k <= self.n_experts):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in [1, n_experts="
                f"{self.n_experts}]"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def n_params(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        kv = self.n_kv_heads * self.head_dim
        mlp = 3 * d * f
        if self.n_experts:
            mlp = self.n_experts * mlp + d * self.n_experts
        per_layer = d * d + 2 * d * kv + d * d + mlp + 2 * d
        return v * d + L * per_layer + d


PRESETS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(
        vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
        max_seq=128, remat=False,
    ),
    "tiny-moe": TransformerConfig(
        vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
        max_seq=128, remat=False, n_experts=4,
    ),
    "gpt-small": TransformerConfig(
        vocab=50257, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12, d_ff=3072,
        max_seq=1024,
    ),
    "moe-small": TransformerConfig(
        vocab=32000, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12, d_ff=3072,
        max_seq=1024, n_experts=8, moe_dispatch="gmm",
    ),
    "bert-base": TransformerConfig(
        vocab=30522, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12, d_ff=3072,
        max_seq=512, causal=False,
    ),
    # The repo's north-star preset: ~795M params, GQA 16q/4kv, head_dim 128.
    "gqa-2048": TransformerConfig(
        vocab=32000, d_model=2048, n_layers=12, n_heads=16, n_kv_heads=4,
        d_ff=8192, max_seq=4096,
    ),
    "llama2-7b": TransformerConfig(
        vocab=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32, d_ff=11008,
        max_seq=4096,
    ),
    "llama2-13b": TransformerConfig(
        vocab=32000, d_model=5120, n_layers=40, n_heads=40, n_kv_heads=40, d_ff=13824,
        max_seq=4096,
    ),
    "llama2-70b": TransformerConfig(
        vocab=32000, d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8, d_ff=28672,
        max_seq=4096,
    ),
    "mixtral-8x7b": TransformerConfig(
        vocab=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq=4096, n_experts=8, moe_top_k=2,
        moe_dispatch="gmm",
    ),
}


def preset(name: str, **overrides) -> TransformerConfig:
    return replace(PRESETS[name], **overrides)


# Workload-dict keys accepted as TransformerConfig overrides (the JAX
# package's set, so one workload dict builds the same config in both).
CONFIG_OVERRIDE_FIELDS = frozenset(
    {
        "vocab", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
        "max_seq", "causal", "remat", "fused_xent", "n_experts",
        "moe_top_k", "capacity_factor", "moe_aux_weight", "moe_zloss_weight",
        "moe_dispatch", "pp_microbatches", "pp_schedule",
    }
)


def preset_from_workload(workload: Dict[str, Any]) -> TransformerConfig:
    """TransformerConfig from a workload dict: ``preset`` plus any
    CONFIG_OVERRIDE_FIELDS, with ``attn`` mapping to ``attn_impl``."""
    overrides = {k: workload[k] for k in CONFIG_OVERRIDE_FIELDS if k in workload}
    if workload.get("attn") in ("ring", "ulysses", "flash", "dense"):
        overrides["attn_impl"] = workload["attn"]
    return preset(workload.get("preset", "tiny"), **overrides)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_transformer(
    cfg: TransformerConfig,
    generator: torch.Generator,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """f32 params with the JAX package's tree: layer leaves stacked on a
    leading [n_layers] axis, dense weights N(0, 1/fan_in), embed
    N(0, 0.02²), norms ones. ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    d, f = cfg.d_model, cfg.d_ff
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L = cfg.n_layers

    def normal(scale, *shape):
        t = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return t.mul_(scale)

    def dense(fan_in, *shape):
        return normal(fan_in ** -0.5, *shape)

    embed = normal(0.02, cfg.vocab, d)
    layers = {
        "attn_norm": torch.ones(L, d, device=dev),
        "wq": dense(d, L, d, nh * hd),
        "wk": dense(d, L, d, nkv * hd),
        "wv": dense(d, L, d, nkv * hd),
        "wo": dense(nh * hd, L, nh * hd, d),
        "mlp_norm": torch.ones(L, d, device=dev),
    }
    if cfg.n_experts:
        E = cfg.n_experts
        layers.update(
            {
                "w_router": dense(d, L, d, E),
                "w_gate": dense(d, L, E, d, f),
                "w_up": dense(d, L, E, d, f),
                "w_down": dense(f, L, E, f, d),
            }
        )
    else:
        layers.update(
            {
                "w_gate": dense(d, L, d, f),
                "w_up": dense(d, L, d, f),
                "w_down": dense(f, L, f, d),
            }
        )
    return {
        "embed": embed,
        "final_norm": torch.ones(d, device=dev),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma.to(x.dtype)


def rope_at_positions(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding at explicit ABSOLUTE positions. x: [b, t, h, d_head];
    positions: [b, t] int. A decode step's token sits at position
    seq_len, and a prefill chunk starts mid-sequence, so the rotation
    must use the absolute position, never the index inside the call."""
    half = x.shape[-1] // 2
    # f64, rounded once to f32: torch's f32 pow is off by an ulp for some
    # exponents, and at positions in the thousands an ulp of a frequency
    # moves the angle by ~1e-6 rad.
    freqs = (theta ** (
        -torch.arange(0, half, dtype=torch.float64, device=x.device) / half
    )).to(torch.float32)
    angles = positions.to(torch.float32)[..., None] * freqs  # [b, t, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
