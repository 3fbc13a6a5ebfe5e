"""Decoder transformer family (Llama-2 recipe): serving and training.

Port of ``tf_operator_tpu/models/transformer.py``: the config and its
presets (same numbers), parameter init (same tree, keys, stacked
``[L, ...]`` shapes and distributions), RMSNorm and rotary embeddings,
the decoder layer with ``dense``, ``flash``, ``ring`` or ``ulysses``
attention and a dense SwiGLU or a top-k MoE MLP (every ``moe_dispatch``,
parallel/moe.py), every remat mode of the JAX package (none, full,
``dots`` and the ``save:`` names, on ``torch.utils.checkpoint``), the
forward, the causal LM loss and the bidirectional (BERT-class) masked-LM
loss, fused or not, with the MoE router losses and telemetry. Master
params stay f32 and are cast to ``cfg.dtype`` inside the layer, as in the
JAX package.

Under a mesh (``mesh``: a DeviceMesh over dp, fsdp, ep, cp and tp;
params laid out by ``transformer_logical_axes`` and
``parallel.sharding.DEFAULT_RULES``, each rank holding its blocks) the
model is explicit SPMD: each layer all-gathers its fsdp-split leaves
inside the layer (a remat region gathers again in its recompute, as FSDP
does), wq/wk/wv and w_gate/w_up are column-parallel behind
``tp_region_enter`` and wo and w_down row-parallel before
``tp_region_exit``, attention runs on the local batch and heads (K and V
gathered and repeated to the query heads first where ``n_kv_heads % tp
!= 0``), the tied embedding is gathered whole for the lookup and the CE
(its gradient reduce-scattered back over fsdp), and the loss is the
global one: its numerator and denominator are summed over the data axes
and cp.

Under cp each rank holds its block of the sequence through the whole
layer: RoPE rotates at global positions, ``ring`` and ``ulysses`` run
parallel/ring_attention.py and parallel/ulysses.py, and ``flash`` and
``dense`` compute what GSPMD computes for them in JAX, attention over the
whole sequence: Q, K and V are all-gathered over cp, attended, and the
rank keeps its block of the output (K/V alone would do only with a query
offset in the causal mask, which the kernels do not take). The causal
LM's last position of a block takes its target from the next rank's
block. The MoE MLP under a mesh runs ``moe_apply`` on the rank's tokens
with its experts (split over ep, gathered over fsdp and tp), its router
from ``w_router`` gathered over fsdp and ep, and its router losses from
the global stats.

Under a pp axis with ``pp_microbatches`` the layer stack runs as a
pipeline (``transformer_hidden_pp``, parallel/pipeline.py): each pp rank
runs its stage's layers (its contiguous block of the stacked leaves, or,
interleaved, the chunks it gets by one exchange over pp a step), gathered
over fsdp once a step; tp inside a stage is the Megatron split as
without pp, and MoE runs on the microbatch's rows, its experts
replicated in the stage or split over ep, ep then a batch axis of the
pipeline.

Not ported yet, and raising where asked for: MoE together with a cp axis
of more than one (ROADMAP Queue 1 item 12); a pp axis together with a cp
axis of more than one, and a pp axis without ``pp_microbatches`` (both
ROADMAP Queue 3).

Declared differences: the masked-LM loss without an explicit ``mask``
uses a fixed mask drawn with ``np.random.RandomState(0)`` (JAX: the
bits of ``jax.random.bernoulli(PRNGKey(0), ...)``; both use one mask at
every step). Remat policies are built from checkpointed regions (named
policies) and selective activation checkpointing (``dots``); what is
stored and recomputed matches the JAX policy, the values are the same.

Init draws from an explicit ``torch.Generator``; it cannot reproduce
``jax.random``'s bits, so parity tests convert the JAX package's params
(``compat.params_from_numpy``) instead of re-seeding.
"""

from __future__ import annotations

import functools
import importlib
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.parallel import collectives as coll
from tf_operator_tpu_torch.parallel.sharding import DEFAULT_RULES, MeshPlan


@dataclass(frozen=True)
class TransformerConfig:
    """Same fields as the JAX config, so every workload dict that
    configures the JAX package configures this one. ``dtype`` is the
    activation dtype of the training forward (bf16, as in JAX); the
    serving engine ignores it and runs f32 throughout."""

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
    dtype: torch.dtype = torch.bfloat16
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

    def n_active_params(self) -> int:
        """Params touched per token (= n_params for dense; top-k MoE
        activates k experts): the N of 6ND FLOP accounting."""
        if not self.n_experts:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        inactive = (self.n_experts - self.moe_top_k) * 3 * d * f
        return self.n_params() - L * inactive


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


def init_transformer_numpy(cfg: TransformerConfig, seed: int) -> Dict[str, Any]:
    """f32 numpy params with ``init_transformer``'s tree and distributions,
    drawn from ``np.random.default_rng(seed)`` (f32 normals, leaf by leaf
    in the tree's order): the same arrays on any host, for either package
    (``compat.params_from_numpy`` hands them to this one)."""
    rng = np.random.default_rng(int(seed))
    d, f = cfg.d_model, cfg.d_ff
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L = cfg.n_layers

    def dense(fan_in, *shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(fan_in ** -0.5)
        return x

    embed = rng.standard_normal((cfg.vocab, d), dtype=np.float32)
    embed *= np.float32(0.02)
    layers = {
        "attn_norm": np.ones((L, d), np.float32),
        "wq": dense(d, L, d, nh * hd),
        "wk": dense(d, L, d, nkv * hd),
        "wv": dense(d, L, d, nkv * hd),
        "wo": dense(nh * hd, L, nh * hd, d),
        "mlp_norm": np.ones((L, d), np.float32),
    }
    if cfg.n_experts:
        E = cfg.n_experts
        layers.update({"w_router": dense(d, L, d, E), "w_gate": dense(d, L, E, d, f),
                       "w_up": dense(d, L, E, d, f), "w_down": dense(f, L, E, f, d)})
    else:
        layers.update({"w_gate": dense(d, L, d, f), "w_up": dense(d, L, d, f),
                       "w_down": dense(f, L, f, d)})
    return {"embed": embed, "final_norm": np.ones(d, np.float32), "layers": layers}


def transformer_logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Logical axis names per param leaf (the params' tree), the JAX
    package's table."""
    layers = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", "embed"),
    }
    if cfg.n_experts:
        layers.update({"w_router": ("layers", "embed", "expert"),
                       "w_gate": ("layers", "expert", "embed", "mlp"),
                       "w_up": ("layers", "expert", "embed", "mlp"),
                       "w_down": ("layers", "expert", "mlp", "embed")})
    else:
        layers.update({"w_gate": ("layers", "embed", "mlp"),
                       "w_up": ("layers", "embed", "mlp"),
                       "w_down": ("layers", "mlp", "embed")})
    return {"embed": ("vocab", "embed"), "final_norm": ("embed",), "layers": layers}


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma.to(x.dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Rope(torch.autograd.Function):
    """The rotation and its transpose (the rotation by -angle). cos and sin
    are constants of the positions and ride the context as attributes, not
    as saved tensors: a checkpointed region that ends at a rotated
    projection then stores nothing after the product, so its recompute
    stops before the product runs again (the JAX policy keeps the
    projection out of the recompute too)."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.cos, ctx.sin = cos, sin
        return _rotate(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.cos, -ctx.sin), None, None


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
    return _Rope.apply(x, cos, sin)


def _rope(x: torch.Tensor, theta: float, offset: int = 0) -> torch.Tensor:
    """Rotary embedding at positions offset..offset+t-1 (the training
    forward; ``offset`` is a cp rank's first global position):
    rope_at_positions at arange(t) + offset. x: [b, t, h, d_head]."""
    b, t = x.shape[:2]
    pos = (torch.arange(t, device=x.device) + offset).expand(b, t)
    return rope_at_positions(x, pos, theta)


def _attention(q, k, v, cfg: TransformerConfig, spmd: Optional["_Spmd"] = None):
    """q: [b, t, nh, hd]; k/v: [b, t, nkv, hd]. GQA-native on every path:
    no [b, t, nh, hd] K/V tensor exists. ``flash`` runs the hand-written
    kernels on the card (ops/flash_attention.py); ``dense`` the grouped
    einsum with an f32 softmax, the same math. Under a mesh with a cp
    axis ``ring`` and ``ulysses`` run their modules on the rank's sequence
    block (without one they fall to ``dense``, as in JAX), and ``flash``
    and ``dense`` attend over the sequence gathered over cp and keep the
    rank's block."""
    from tf_operator_tpu_torch.ops.flash_attention import (
        flash_attention,
        reference_attention,
    )

    has_cp = spmd is not None and cfg.cp_axis in spmd.mesh.mesh_dim_names
    if cfg.attn_impl == "ring" and has_cp:
        from tf_operator_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, spmd.mesh, axis_name=cfg.cp_axis, causal=cfg.causal)
    if cfg.attn_impl == "ulysses" and has_cp:
        from tf_operator_tpu_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, spmd.mesh, axis_name=cfg.cp_axis, causal=cfg.causal)
    if cfg.attn_impl not in ("flash", "dense", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    fn = flash_attention if cfg.attn_impl == "flash" else reference_attention
    cp = 1 if spmd is None else spmd.cp
    if cp == 1:
        return fn(q, k, v, causal=cfg.causal)
    t = q.shape[1]
    whole = [coll.all_gather(x, spmd.mesh, cfg.cp_axis, dim=1) for x in (q, k, v)]
    out = fn(*whole, causal=cfg.causal)
    return out.narrow(1, coll.axis_index(spmd.mesh, cfg.cp_axis) * t, t)


def _swiglu_experts(wp, toks):
    """The SwiGLU expert body over stacked experts: toks [E, C, d], wp's
    leaves [E, ...] (cast to the tokens' dtype), one batched product each."""
    gate = F.silu(toks @ wp["w_gate"].to(toks.dtype))
    return (gate * (toks @ wp["w_up"].to(toks.dtype))) @ wp["w_down"].to(toks.dtype)


def _moe_mlp(h, lp, cfg: TransformerConfig):
    """Top-k expert MLP: the router product in the activation dtype, then
    parallel/moe.py's dispatch (cfg.moe_dispatch) with the SwiGLU expert
    body (sort, einsum: one batched product over the stacked [E, C, d]
    inbox; ragged: ragged_swiglu; gmm: the grouped matmul kernels, which
    compute the same body); under a mesh on the rank's tokens and experts.
    Returns (out, aux): aux holds the UNWEIGHTED router losses (the loss
    head weighs them) and telemetry, of the global batch: the Switch
    load-balance loss E·Σ load·mean_gate (load comes from the discrete
    assignment and carries no gradient), the ST-MoE z-loss
    mean(logsumexp(f32 logits)²), expert_load [E] and drop_frac."""
    from tf_operator_tpu_torch.parallel.moe import moe_apply, ragged_swiglu

    spmd = _spmd_of(lp)
    mesh = None if spmd is None else spmd.mesh
    b, t, d = h.shape
    flat = h.reshape(b * t, d)
    gate_logits = flat @ lp["w_router"].to(h.dtype)
    experts = {k: lp[k] for k in ("w_gate", "w_up", "w_down")}
    in_stage = isinstance(lp, _StageLayer)
    if in_stage:
        out, stats = _moe_in_stage(flat, gate_logits, experts, cfg, spmd)
    else:
        out, stats = moe_apply(
            flat, gate_logits, experts, _swiglu_experts, mesh, axis_name=cfg.ep_axis,
            capacity_factor=cfg.capacity_factor, dropped="zero", k_top=cfg.moe_top_k,
            return_stats=True, dispatch_impl=cfg.moe_dispatch, ragged_expert_fn=ragged_swiglu)
    lb_loss = cfg.n_experts * (stats["expert_load"] * stats["mean_gate"]).sum()
    z_loss = torch.logsumexp(gate_logits.float(), dim=-1).square().mean()
    if spmd is not None and not in_stage:  # the mean over the global tokens
        z_loss = coll.all_reduce_mean(z_loss, mesh, spmd.plan.data_axes)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss,
           "expert_load": stats["expert_load"], "drop_frac": stats["drop_frac"]}
    return out.reshape(b, t, d), aux


def _moe_in_stage(flat, gate_logits, experts, cfg: TransformerConfig, spmd: "_Spmd"):
    """The MoE MLP in a pipeline stage, on the microbatch's rows: without an
    ep axis moe_apply on one device (the experts replicated in the stage,
    the capacity from these rows); with one the per-device dispatch on the
    ep axis (gmm padding-free, every other dispatch as sort, as the JAX
    pipeline runs them), its rows routed to their experts' owners and the
    stats averaged over ep alone. (out, stats)."""
    from tf_operator_tpu_torch.parallel import moe

    if spmd.plan.size(cfg.ep_axis) == 1:
        return moe.moe_apply(
            flat, gate_logits, experts, _swiglu_experts, None,
            capacity_factor=cfg.capacity_factor, dropped="zero", k_top=cfg.moe_top_k,
            return_stats=True, dispatch_impl=cfg.moe_dispatch,
            ragged_expert_fn=moe.ragged_swiglu)
    mesh = spmd.mesh
    if cfg.moe_dispatch == "gmm":
        out, stats = moe._moe_local_gmm(flat, gate_logits, experts, mesh, cfg.ep_axis,
                                        cfg.moe_top_k, moe._block_rows())
    else:
        capacity = moe.expert_capacity(cfg.capacity_factor, cfg.moe_top_k, flat.shape[0],
                                       cfg.n_experts)
        out, stats = moe._moe_local(flat, gate_logits, experts, _swiglu_experts, mesh,
                                    cfg.ep_axis, capacity, "zero", cfg.moe_top_k, "sort")
    return out, moe._global_stats(stats, mesh, (cfg.ep_axis,))


_EXPERT_LEAVES = frozenset({"w_gate", "w_up", "w_down"})


class _ShardedLayer(dict):
    """One layer's params on a mesh: ``lp[name]`` is the leaf gathered over
    its fsdp split (tp blocks stay), gathered at first access and kept for
    this object's life. ``fresh()`` gives an empty one, so each layer call
    and each remat region (and its recompute) gathers for itself."""

    def __init__(self, local: dict, spmd: "_Spmd") -> None:
        super().__init__()
        self.local, self.spmd = local, spmd

    def __missing__(self, name):
        # the experts stay split over ep and are gathered whole over tp (the
        # MoE runs alike on every tp rank); the router is gathered whole
        # (its product runs on every ep rank's tokens alike)
        keep, replicated = {"w_router": ((), ("ep",))}.get(
            name, (("ep",), ("tp",)) if name in _EXPERT_LEAVES and self.spmd.moe
            else (("tp",), ()))
        value = self.spmd.plan.gather(self.local[name], self.spmd.layer_placement[name],
                                      keep=keep, replicated=replicated)
        self[name] = value
        return value

    def fresh(self) -> "_ShardedLayer":
        return _ShardedLayer(self.local, self.spmd)


class _StageLayer(_ShardedLayer):
    """One layer's params inside a pipeline stage: the stage's leaves were
    gathered over fsdp once for the step, so a name is the leaf itself."""

    def __missing__(self, name):
        self[name] = self.local[name]
        return self[name]

    def fresh(self) -> "_StageLayer":
        return _StageLayer(self.local, self.spmd)


def _fresh(lp):
    return lp.fresh() if isinstance(lp, _ShardedLayer) else lp


def _spmd_of(lp) -> Optional["_Spmd"]:
    return lp.spmd if isinstance(lp, _ShardedLayer) else None


def _tp_enter(lp, h):
    return coll.tp_region_enter(h, lp.spmd.mesh) if isinstance(lp, _ShardedLayer) else h


def _tp_exit(lp, y):
    return coll.tp_region_exit(y, lp.spmd.mesh) if isinstance(lp, _ShardedLayer) else y


def _heads(h, lp, name: str, cfg: TransformerConfig, rotate: bool):
    """h @ lp[name] split into heads [b, t, n, hd], rotated for q and k.
    Under tp with n_kv_heads % tp != 0 the K/V columns are gathered over tp,
    rotated, repeated to the query heads and this rank's heads kept."""
    b, t, _ = h.shape
    y = h @ lp[name].to(h.dtype)
    spmd = _spmd_of(lp)
    offset = 0 if spmd is None else spmd.plan.seq_index * t  # global positions under cp
    if spmd is not None and name != "wq" and spmd.kv_repeat:
        y = coll.all_gather(y, spmd.mesh, "tp", dim=-1)
        y = y.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
        if rotate:
            y = _rope(y, cfg.rope_theta, offset)
        local = cfg.n_heads // spmd.tp
        first = coll.axis_index(spmd.mesh, "tp") * local
        y = y.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
        return y[:, :, first:first + local]
    y = y.reshape(b, t, -1, cfg.head_dim)
    return _rope(y, cfg.rope_theta, offset) if rotate else y


def _resid_mid(lp, cfg: TransformerConfig, x, q, k, v):
    """x + attention: the first half of the layer's residual stream."""
    b, t, _ = x.shape
    attn = _attention(q, k, v, cfg, _spmd_of(lp)).reshape(b, t, -1)
    return x + _tp_exit(lp, attn @ lp["wo"].to(x.dtype))


def _swiglu_out(lp, cfg: TransformerConfig, x, z_gate, up):
    """resid_mid + the SwiGLU MLP of its two products: (layer output, None)."""
    return x + _tp_exit(lp, (F.silu(z_gate) * up) @ lp["w_down"].to(x.dtype)), None


def _moe_out(lp, cfg: TransformerConfig, x, h):
    """resid_mid + the MoE MLP of its normed h: (layer output, aux)."""
    out, aux = _moe_mlp(h, lp, cfg)
    return x + out, aux


# One decoder layer as named values: name -> (the values it reads, how it
# is computed from them). The names of the JAX model's checkpoint_name
# tags (flash_q/k/v: flash's inputs after RoPE; resid_mid; mlp_gate and
# mlp_up: the MLP's pre-activation products), the two normed activations
# between them, and "out", the layer's (output, aux).
_LAYER_VALUES = {
    "h_attn": (("x",), lambda lp, cfg, x: _tp_enter(
        lp, _rms_norm(x, lp["attn_norm"], cfg.norm_eps))),
    "flash_q": (("h_attn",), lambda lp, cfg, h: _heads(h, lp, "wq", cfg, True)),
    "flash_k": (("h_attn",), lambda lp, cfg, h: _heads(h, lp, "wk", cfg, True)),
    "flash_v": (("h_attn",), lambda lp, cfg, h: _heads(h, lp, "wv", cfg, False)),
    "resid_mid": (("x", "flash_q", "flash_k", "flash_v"), _resid_mid),
    "h_mlp": (("resid_mid",), lambda lp, cfg, x: _tp_enter(
        lp, _rms_norm(x, lp["mlp_norm"], cfg.norm_eps))),
    "mlp_gate": (("h_mlp",), lambda lp, cfg, h: h @ lp["w_gate"].to(h.dtype)),
    "mlp_up": (("h_mlp",), lambda lp, cfg, h: h @ lp["w_up"].to(h.dtype)),
    "out": (("resid_mid", "mlp_gate", "mlp_up"), _swiglu_out),
}
# An MoE layer has no mlp_gate/mlp_up: its MLP is the expert dispatch, which
# runs alike on every tp rank, so its input is no tp region's.
_MOE_LAYER_VALUES = {k: v for k, v in _LAYER_VALUES.items() if not k.startswith("mlp_")} | {
    "h_mlp": (("resid_mid",), lambda lp, cfg, x: _rms_norm(x, lp["mlp_norm"], cfg.norm_eps)),
    "out": (("resid_mid", "h_mlp"), _moe_out)}


def _layer_values(cfg: TransformerConfig) -> dict:
    return _MOE_LAYER_VALUES if cfg.n_experts else _LAYER_VALUES


def _value(name: str, env: dict, lp, cfg: TransformerConfig):
    """The layer value ``name``, computed (and kept in ``env``) from the
    values ``env`` already holds."""
    if name not in env:
        reads, fn = _layer_values(cfg)[name]
        env[name] = fn(lp, cfg, *[_value(r, env, lp, cfg) for r in reads])
    return env[name]


def _inputs_of(name: str, have, cfg: TransformerConfig) -> list:
    """The values of ``have`` that computing ``name`` reads, through the
    values that are not in ``have``; in _LAYER_VALUES order."""
    found = set()

    def walk(n):
        if n in have:
            found.add(n)
        else:
            for r in _layer_values(cfg)[n][0]:
                walk(r)

    walk(name)
    return [n for n in ("x", *_LAYER_VALUES) if n in found]


def _layer(x, lp, cfg: TransformerConfig):
    """One decoder layer (pre-norm attention, then the pre-norm MLP):
    (x, aux), aux None for a dense layer."""
    return _value("out", {"x": x}, _fresh(lp), cfg)


# Remat policies of the JAX package (name -> the activations it saves).
_REMAT_SAVE_SETS: Dict[str, tuple] = {
    "save_mid": ("resid_mid",),
    "save_qkv": ("flash_q", "flash_k", "flash_v"),
    "save_qkv_mid": ("flash_q", "flash_k", "flash_v", "resid_mid"),
    "save_qkv_mid_up": ("flash_q", "flash_k", "flash_v", "resid_mid", "mlp_up"),
    "save_qkv_mid_mlp": (
        "flash_q", "flash_k", "flash_v", "resid_mid", "mlp_up", "mlp_gate",
    ),
    "save_mlp_mid": ("resid_mid", "mlp_gate", "mlp_up"),
}

# Every activation name the JAX model tags: the validation domain of
# "save:" policies.
KNOWN_SAVE_NAMES = frozenset(
    {"flash_q", "flash_k", "flash_v", "resid_mid", "mlp_gate", "mlp_up"}
)


def remat_save_names(remat) -> Optional[tuple]:
    """The activation names a remat mode saves (None for non-name modes):
    a _REMAT_SAVE_SETS alias or ``"save:name1,name2"``. Unknown names in a
    ``save:`` policy raise: a typo would otherwise save nothing."""
    if isinstance(remat, str):
        if remat in _REMAT_SAVE_SETS:
            return _REMAT_SAVE_SETS[remat]
        if remat.startswith("save:"):
            names = tuple(n.strip() for n in remat[5:].split(",") if n.strip())
            unknown = sorted(set(names) - KNOWN_SAVE_NAMES)
            if unknown:
                raise ValueError(
                    f"remat policy {remat!r}: unknown activation name(s) "
                    f"{unknown}; known names: {sorted(KNOWN_SAVE_NAMES)}"
                )
            return names
    return None


def kept_names(cfg: TransformerConfig) -> tuple:
    """The named values a layer keeps under cfg's names policy, in layer
    order: the policy's names that the layer tags, as the JAX model tags
    them (flash_q/k/v only under ``attn_impl="flash"``, where the flash
    entry tags its inputs; mlp_gate/mlp_up only in a dense MLP), and
    resid_mid too where the policy keeps an MLP product without it (a
    declared difference: both MLP regions read resid_mid, which would
    otherwise run the attention half twice in the forward, where the JAX
    policy runs it once and recomputes it in the backward)."""
    names = set(remat_save_names(cfg.remat) or ())
    if cfg.attn_impl != "flash":
        names -= {"flash_q", "flash_k", "flash_v"}
    if cfg.n_experts:
        names -= {"mlp_gate", "mlp_up"}
    if names & {"mlp_gate", "mlp_up"}:
        names.add("resid_mid")
    return tuple(n for n in _LAYER_VALUES if n in names)


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots`` (JAX's dots_with_no_batch_dims_saveable): keep the outputs
    of 2-D products, recompute everything else, batched products included.
    Replays go by op order; the flash and grouped-matmul kernels are ctypes
    launches into buffers from ``aten.empty``, invisible here, so no
    allocation may be kept or a replay would skip the launch that fills it."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _saving_layer(cfg: TransformerConfig):
    """layer(x, lp) under a names policy: each kept name is the output of a
    checkpointed region that reads the layer input and the kept names
    before it, and the layer's output another, so what the outer graph
    keeps is exactly the layer input and the kept names, and the backward
    recomputes the rest (a region's recompute stops at its last stored
    tensor: the product that makes a kept name does not run again)."""
    saved = kept_names(cfg)

    def region(name, env, lp):
        reads = _inputs_of(name, env, cfg)

        def run(*tensors):
            return _value(name, dict(zip(reads, tensors)), _fresh(lp), cfg)

        return checkpoint(run, *[env[r] for r in reads], use_reentrant=False)

    def layer(x, lp):
        env = {"x": x}
        for name in saved:
            env[name] = region(name, env, lp)
        return region("out", env, lp)

    return layer


def _remat_wrap(cfg: TransformerConfig):
    """layer(x, lp) -> (x, aux) under cfg.remat. ``full`` saves only the
    layer input and recomputes the layer in the backward; ``dots`` keeps
    the 2-D products' outputs (selective activation checkpointing); a
    names policy keeps the layer input and kept_names (_saving_layer).
    The flash forward runs again in the backward under every mode but
    none, as in JAX, whose flash boundary keeps no (o, lse). The MoE aux
    leaves are outputs of the checkpointed regions."""
    remat = cfg.remat
    if remat in (True, "full"):
        return lambda x, lp: checkpoint(_layer, x, lp, cfg, use_reentrant=False)
    if remat in (False, None, "none"):
        return lambda x, lp: _layer(x, lp, cfg)
    if remat == "dots":
        contexts = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda x, lp: checkpoint(_layer, x, lp, cfg, use_reentrant=False,
                                        context_fn=contexts)
    if remat_save_names(remat) is None:
        raise ValueError(f"unknown remat mode {remat!r}")
    return _saving_layer(cfg)


def check_supported(cfg: TransformerConfig, mesh) -> None:
    """Raise for what the port does not run yet, naming its item."""
    if mesh is None:
        return
    sizes = {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.mesh.shape)}
    pp = sizes.get(cfg.pp_axis, 1)
    if pp > 1 and not cfg.pp_microbatches:
        raise NotImplementedError(
            f"a pp axis of {pp} without pp_microbatches: the port runs a pp axis only as a "
            "pipeline (the JAX package's GSPMD placement of the layer stack without one is "
            "not ported; ROADMAP Queue 3)")
    if pp > 1 and sizes.get(cfg.cp_axis, 1) > 1:
        raise NotImplementedError(
            f"a pp axis of {pp} with a cp axis of {sizes[cfg.cp_axis]}: the JAX pipeline "
            "splits no sequence, so every cp rank would run its stage on the whole sequence; "
            "cp inside a pipeline stage is not ported (ROADMAP Queue 3)")
    if cfg.n_experts and sizes.get(cfg.cp_axis, 1) > 1:
        raise NotImplementedError(
            f"MoE under a cp axis of {sizes[cfg.cp_axis]} is not ported yet (ROADMAP Queue 1 "
            "item 12: the token order of the capacity queues across sequence blocks)")


class _Spmd:
    """What the model needs of a mesh: the plan (placements, coordinates,
    data split) of transformer_logical_axes under DEFAULT_RULES, the tp and
    cp sizes, whether K/V must be repeated before the heads split, and
    whether the layers are MoE's."""

    def __init__(self, cfg: TransformerConfig, mesh) -> None:
        self.mesh = mesh
        self.plan = MeshPlan(mesh, transformer_logical_axes(cfg), DEFAULT_RULES)
        self.tp = self.plan.size("tp")
        self.cp_axis = cfg.cp_axis
        self.cp = self.plan.size(cfg.cp_axis)
        self.moe = bool(cfg.n_experts)
        if cfg.n_heads % self.tp:
            raise ValueError(f"n_heads {cfg.n_heads} does not split over tp={self.tp}")
        self.kv_repeat = cfg.n_kv_heads % self.tp != 0
        # the per-layer leaves' placements, without the [n_layers] dim
        self.layer_placement = {k: v[1:] for k, v in self.plan.placements["layers"].items()}

    def embed(self, params):
        """The whole tied table: gathered over fsdp (its gradient
        reduce-scattered back) and tp (the lookup and the CE run on every
        tp rank alike, so the backward keeps this rank's rows)."""
        return self.plan.gather(params["embed"], self.plan.placements["embed"],
                                replicated=("tp",))

    def final_norm(self, params):
        return self.plan.gather(params["final_norm"], self.plan.placements["final_norm"])


def _spmd(cfg: TransformerConfig, mesh) -> Optional[_Spmd]:
    check_supported(cfg, mesh)
    return None if mesh is None else _Spmd(cfg, mesh)


def transformer_hidden(params, tokens, cfg: TransformerConfig, mesh=None,
                       with_aux: bool = False, embed: Optional[torch.Tensor] = None):
    """tokens: [b, t] int -> final-norm hidden states [b, t, d] (cfg.dtype),
    or (h, aux) with ``with_aux``: for MoE configs the per-layer router
    losses averaged over layers, expert_load [L, E] and drop_frac [L];
    None for dense ones. A Python loop over the stacked [L, ...] layer
    leaves. The embedding row is gathered in f32 and then cast (the same
    values as JAX's gather from the cast table), so its gradient
    accumulates in f32. Under a mesh, ``tokens`` are this rank's rows and
    ``params`` its blocks; ``embed`` is the whole table when the caller
    gathered it already (the tied CE reads it too)."""
    spmd = _spmd(cfg, mesh)
    if embed is None:
        embed = params["embed"] if spmd is None else spmd.embed(params)
    if _use_pipeline(cfg, spmd):
        h, aux = transformer_hidden_pp(params, embed, tokens, cfg, spmd)
        return (h, aux) if with_aux else h
    return _hidden(params, embed, tokens, cfg, spmd, with_aux)


def _use_pipeline(cfg: TransformerConfig, spmd: Optional[_Spmd]) -> bool:
    return bool(cfg.pp_microbatches and spmd is not None and spmd.plan.size(cfg.pp_axis) > 1)


def _stage_leaves(params, cfg: TransformerConfig, spmd: _Spmd) -> dict:
    """This rank's stage: each stacked layer leaf's pp block (interleaved:
    the chunks it runs, by one exchange over pp), gathered over fsdp (and,
    under ep, the router over ep) once for the step, [v, per, ...]. The
    experts stay split over ep; the tp blocks stay; the router's gradient
    is reduce-scattered over ep, whose ranks route their own rows."""
    from tf_operator_tpu_torch.parallel.pipeline import interleave_chunks

    v = cfg.pp_chunks
    out = {}
    for name, leaf in params["layers"].items():
        leaf = interleave_chunks(leaf, spmd.mesh, cfg.pp_axis, v)
        keep = (cfg.pp_axis, cfg.ep_axis) if spmd.moe and name in _EXPERT_LEAVES else \
            (cfg.pp_axis, "tp")
        leaf = spmd.plan.gather(leaf, spmd.plan.placements["layers"][name], keep=keep)
        out[name] = leaf.reshape((v, leaf.shape[0] // v) + tuple(leaf.shape[1:]))
    return out


def transformer_hidden_pp(params, embed, tokens, cfg: TransformerConfig, spmd: _Spmd):
    """The layer stack as a pipeline over the pp axis (the JAX package's
    ``transformer_hidden_pp``): n_layers / (pp · pp_chunks) contiguous
    layers a virtual stage through ``pipeline.pipeline_apply`` under
    cfg.pp_schedule, each stage a loop over its layers with the same
    remat-wrapped layer as ``_hidden``, so every remat policy holds in a
    stage. Composes with dp and fsdp (pipeline data axes), tp inside a
    stage (the Megatron split, n_heads, n_kv_heads and d_ff divisible by
    tp) and ep inside a stage (ep a data axis too: each ep rank pipelines
    its own rows and the MoE layers exchange them with the experts'
    owners). The MoE router losses ride the pipeline's aux channel, summed
    per (layer, microbatch) and normalised back to means here, the
    load-balance fractions per microbatch; expert_load and drop_frac are
    not carried (None). MoE with tp in a stage raises, as in JAX.
    Returns (final-norm h, aux or None)."""
    from tf_operator_tpu_torch.parallel.pipeline import pipeline_apply
    from tf_operator_tpu_torch.parallel.sharding import split_axes

    tp = spmd.tp
    if cfg.n_experts and tp > 1:
        raise NotImplementedError(
            "MoE + tp-within-stage is not supported (the expert MLP has "
            "no tensor-parallel split); use pp x ep x dp for MoE pipelines"
        )
    ep = spmd.plan.size(cfg.ep_axis)
    if cfg.n_experts and ep > 1 and cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts not divisible by {cfg.ep_axis}={ep}")
    n_virtual = spmd.plan.size(cfg.pp_axis) * cfg.pp_chunks
    if cfg.n_layers % n_virtual:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp*pp_chunks={n_virtual}")
    if tp > 1:
        for nm, val in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                        ("d_ff", cfg.d_ff)):
            if val % tp:
                raise ValueError(f"{nm}={val} not divisible by tp={tp}")
    layer_fn = _remat_wrap(cfg)
    if cfg.remat not in (False, None, "none"):
        # torch.utils.checkpoint imports torch._dynamo at its first call (~3 s
        # on an idle host, ~10 s on a busy one): import it here, so every
        # stage pays it before the first tick, at once, and not stage after
        # stage inside the pipeline
        importlib.import_module("torch._dynamo")
    moe = bool(cfg.n_experts)
    per = cfg.n_layers // n_virtual

    def stage_fn(chunk, xb):
        layers = {name: leaf.unbind(0) for name, leaf in chunk.items()}
        acc = torch.zeros(2, dtype=torch.float32, device=xb.device)
        for j in range(per):
            xb, aux = layer_fn(xb, _StageLayer({n: ls[j] for n, ls in layers.items()}, spmd))
            if moe:
                acc = acc + torch.stack([aux["lb_loss"], aux["z_loss"]]).float()
        return (xb, acc) if moe else xb

    x = embed[tokens].to(cfg.dtype)
    res = pipeline_apply(_stage_leaves(params, cfg, spmd), x, stage_fn, spmd.mesh,
                         cfg.pp_microbatches, cfg.pp_axis,
                         batch_axes=split_axes(spmd.plan.batch_part),
                         schedule=cfg.pp_schedule, aux_size=2 if moe else 0,
                         n_chunks=cfg.pp_chunks)
    final_norm = spmd.final_norm(params)
    if not moe:
        return _rms_norm(res, final_norm, cfg.norm_eps), None
    h, sums = res
    denom = cfg.n_layers * cfg.pp_microbatches
    return _rms_norm(h, final_norm, cfg.norm_eps), {
        "lb_loss": sums[0] / denom, "z_loss": sums[1] / denom,
        "expert_load": None, "drop_frac": None}


def _hidden(params, embed, tokens, cfg: TransformerConfig, spmd: Optional[_Spmd],
            with_aux: bool):
    layer_fn = _remat_wrap(cfg)
    x = embed[tokens].to(cfg.dtype)
    # unbind once: its backward stacks the L per-layer grads in one op,
    # where indexing leaf[i] per layer would add a full [L, ...] zero-padded
    # grad into the stack L times
    layers = {name: leaf.unbind(0) for name, leaf in params["layers"].items()}
    auxes = []
    for i in range(cfg.n_layers):
        lp = {name: leaf[i] for name, leaf in layers.items()}
        x, aux = layer_fn(x, lp if spmd is None else _ShardedLayer(lp, spmd))
        auxes.append(aux)
    final_norm = params["final_norm"] if spmd is None else spmd.final_norm(params)
    h = _rms_norm(x, final_norm, cfg.norm_eps)
    if not with_aux:
        return h
    if not cfg.n_experts:
        return h, None
    return h, {
        "lb_loss": torch.stack([a["lb_loss"] for a in auxes]).mean(),
        "z_loss": torch.stack([a["z_loss"] for a in auxes]).mean(),
        "expert_load": torch.stack([a["expert_load"] for a in auxes]),  # [L, E]
        "drop_frac": torch.stack([a["drop_frac"] for a in auxes]),  # [L]
    }


def transformer_forward(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens: [b, t] int -> logits [b, t, vocab] (f32); tied output head."""
    spmd = _spmd(cfg, mesh)
    embed = params["embed"] if spmd is None else spmd.embed(params)
    x = transformer_hidden(params, tokens, cfg, mesh, embed=embed)
    return (x @ embed.to(cfg.dtype).T).float()


MASK_TOKEN = 0


@functools.lru_cache(maxsize=8)
def mlm_mask(shape: tuple, mask_rate: float, device: torch.device) -> torch.Tensor:
    """The masked-LM loss's fixed mask: ``np.random.RandomState(0)
    .random_sample(shape) < mask_rate`` as a bool tensor on ``device``,
    drawn on the host (the card and the CPU then mask the same positions)
    and kept per shape and device. JAX draws its fixed mask from
    ``PRNGKey(0)`` (a declared difference: other bits, the same rate)."""
    m = np.random.RandomState(0).random_sample(shape) < mask_rate
    return torch.from_numpy(m).to(device)


def lm_loss_and_metrics(params, tokens, cfg: TransformerConfig, mesh=None, *,
                        mask: Optional[torch.Tensor] = None, mask_rate: float = 0.15):
    """(total_loss, metrics). Causal: next-token cross entropy.
    Bidirectional (BERT-class): masked language modeling, the positions
    of ``mask`` (bool [b, t]; by default ``mlm_mask``, the same at every
    call, as JAX's default key gives) replaced with MASK_TOKEN and only
    those positions weighed in the cross entropy, sum(w·xent) / max(sum w,
    1). Fused (ops/fused_cross_entropy.py, no [b, t, vocab] logits in
    memory) or the unfused log-softmax, the same math. For MoE configs the
    total adds ``moe_aux_weight`` times the load-balance loss and
    ``moe_zloss_weight`` times the z-loss, and metrics carries the router
    telemetry beside ``ce_loss``: moe_lb_loss, moe_z_loss (unweighted),
    moe_expert_entropy (mean over layers, nats; uniform routing = ln(E))
    and moe_drop_frac.

    Under a mesh ``tokens`` (and ``mask``) are this rank's block: its rows
    and, under cp, its block of the sequence; the default mask is the
    global batch's, cut to that block; the loss and metrics are the global
    batch's: sum(w·xent) and sum(w) are summed over the data axes and cp
    before the division, as JAX's mean over the sharded batch. Under cp
    the causal LM's last position of a block takes the first token of the
    next rank's block as its target, and the sequence's last position
    (the last rank's) none."""
    spmd = _spmd(cfg, mesh)
    cp = 1 if spmd is None else spmd.cp
    if cfg.causal and cp > 1:
        targets, weights = _cp_targets(tokens, spmd)
        inputs = tokens
    elif cfg.causal:
        inputs, targets, weights = tokens, tokens[:, 1:], None
    else:
        if mask is None:
            plan = None if spmd is None else spmd.plan
            shape = (tokens.shape[0] * (1 if plan is None else plan.data_size),
                     tokens.shape[1] * (1 if plan is None else plan.seq_size))
            mask = mlm_mask(shape + tuple(tokens.shape[2:]), float(mask_rate), tokens.device)
            if plan is not None:
                mask = plan.local_batch(mask)
        mask = mask.to(tokens.device)
        inputs = tokens.masked_fill(mask, MASK_TOKEN)
        targets, weights = tokens, mask
    embed = params["embed"] if spmd is None else spmd.embed(params)
    h, aux = transformer_hidden(params, inputs, cfg, mesh, with_aux=True, embed=embed)
    if cfg.causal and cp == 1:
        h = h[:, :-1]
    b, t, d = h.shape
    data_axes = () if spmd is None else spmd.plan.loss_axes
    if cfg.fused_xent:
        from tf_operator_tpu_torch.ops.fused_cross_entropy import (
            fused_cross_entropy,
            fused_cross_entropy_sums,
        )

        flat_w = None if weights is None else weights.reshape(b * t)
        if data_axes:
            num, den = fused_cross_entropy_sums(h.reshape(b * t, d), embed,
                                                targets.reshape(b * t), weights=flat_w)
            ce = _global_ratio(num, den, spmd)
        else:
            ce = fused_cross_entropy(h.reshape(b * t, d), embed, targets.reshape(b * t),
                                     weights=flat_w)
    else:
        logits = (h @ embed.to(cfg.dtype).T).float()
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
        w = torch.ones_like(ll) if weights is None else weights.float()
        if data_axes:
            ce = _global_ratio(-(ll * w).sum(), w.sum(), spmd)
        elif weights is None:
            ce = -ll.mean()
        else:
            ce = -(ll * w).sum() / w.sum().clamp(min=1.0)
    metrics = {"ce_loss": ce}
    if aux is None:
        return ce, metrics
    total = ce + cfg.moe_aux_weight * aux["lb_loss"] + cfg.moe_zloss_weight * aux["z_loss"]
    metrics.update(moe_lb_loss=aux["lb_loss"], moe_z_loss=aux["z_loss"])
    load = aux["expert_load"]  # [L, E]; None under a pipeline (scalar losses only)
    if load is not None:
        p = load / load.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        entropy = -(p * p.clamp(min=1e-9).log()).sum(dim=-1)  # [L]
        metrics.update(moe_expert_entropy=entropy.mean(), moe_drop_frac=aux["drop_frac"].mean())
    return total, metrics


def _cp_targets(tokens, spmd: _Spmd):
    """(targets [b, t], weights [b, t]) of a causal block under cp: the
    next position's token, the block's last taking the next rank's first
    token (all-gathered over cp), weight 0 at the sequence's end."""
    plan = spmd.plan
    firsts = coll.gather_no_grad(tokens[:, 0].contiguous(), spmd.mesh, (spmd.cp_axis,))
    nxt = firsts[(plan.seq_index + 1) % plan.seq_size]
    targets = torch.cat([tokens[:, 1:], nxt[:, None]], dim=1)
    weights = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    if plan.seq_index == plan.seq_size - 1:
        weights[:, -1] = False
    return targets, weights


def _global_ratio(num, den, spmd: _Spmd):
    """sum(num) / max(sum(den), 1) over the loss axes (the data axes and
    cp): num's sum is differentiated (its cotangent summed back over
    them), den carries no gradient."""
    axes = spmd.plan.loss_axes
    total = coll.all_reduce_sum(num, spmd.mesh, axes)
    return total / torch.clamp(coll.sum_no_grad(den.detach(), spmd.mesh, axes), min=1.0)


def lm_loss(params, tokens, cfg: TransformerConfig, mesh=None, *,
            mask: Optional[torch.Tensor] = None, mask_rate: float = 0.15):
    """Scalar training loss (lm_loss_and_metrics without the metrics);
    includes the weighted MoE router losses for MoE configs."""
    return lm_loss_and_metrics(params, tokens, cfg, mesh, mask=mask, mask_rate=mask_rate)[0]
