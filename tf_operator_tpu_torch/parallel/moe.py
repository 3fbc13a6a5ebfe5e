"""Mixture-of-experts routing and dispatch for the port: the single-device
grouped-matmul path.

Port of the single-device subset of ``tf_operator_tpu/parallel/moe.py``:
``expert_capacity``, ``_moe_single_gmm`` (top-k routing, rows sorted by
expert and padded per expert only to the kernel's row block, the three
SwiGLU expert products as grouped matmuls, and the gate weights riding
the down projection as its row scale) and ``moe_apply``'s branch without
a mesh for ``dispatch_impl="gmm"``. Not ported yet, and raising: the
``sort``, ``einsum`` and ``ragged`` dispatches (ROADMAP M11) and every
expert-parallel path over a mesh (M8, then M11).

Routing follows ``jax.lax.top_k``'s tie rule (the lower expert index
first) through a stable descending sort: the router product runs in the
activation dtype, so bf16 logits tie often, and under full remat the
backward routes again, which must give the same experts.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.nn.functional as F

from tf_operator_tpu_torch.ops.grouped_matmul import gmm

GMM_PARAM_KEYS = frozenset({"w_gate", "w_up", "w_down"})


def expert_capacity(capacity_factor: float, k_top: int, local_tokens: int,
                    n_experts: int) -> int:
    """The per-expert queue length: cf·k·T_local/E, floored, at least 1."""
    return max(1, int(capacity_factor * k_top * local_tokens / n_experts))


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of each row's k largest entries, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def block_layout(counts, block_rows: int, nb: int):
    """(block_expert [nb] int32, pad_start [E]) of rows sorted by expert,
    with ``counts[e]`` rows of expert e padded to whole blocks of
    ``block_rows`` and at least one block per expert: pad_start[e] is the
    first padded row of expert e, and blocks past the last expert's belong
    to it (their rows are padding). nb must be at least the blocks used."""
    blocks_per_e = ((counts + block_rows - 1) // block_rows).clamp(min=1)
    pad_start = (blocks_per_e.cumsum(0) - blocks_per_e) * block_rows
    bstart = torch.arange(nb, device=counts.device) * block_rows
    block_expert = torch.searchsorted(pad_start, bstart, right=True) - 1
    return block_expert.to(torch.int32), pad_start


def _moe_single_gmm(x, gate_logits, expert_params, k_top: int = 1,
                    block_rows: int = 256):
    """All experts on one device over the grouped-matmul kernels: sort the
    T·k token choices by expert, pad each expert's rows only to the row
    block (every expert owns at least one block, so its dw is written, as
    exact zeros when it has no tokens), map blocks to experts, gather the
    padded rows, and run the SwiGLU experts as three grouped matmuls with
    the gate weights as the down projection's row scale. No token drops.

    x [T, d]; gate_logits [T, E]; expert_params {w_gate [E, d, f], w_up
    [E, d, f], w_down [E, f, d]} (cast to x's dtype here). Returns (out
    [T, d] in x's dtype, stats {expert_load [E], mean_gate [E],
    drop_frac}). Padded rows read row 0 of x; their outputs are never
    gathered back, so their cotangents are exact zeros."""
    tokens, d = x.shape
    n_experts = gate_logits.shape[-1]
    dev = x.device
    gate_probs = torch.softmax(gate_logits.float(), dim=-1)
    top_p, top_i = _top_k(gate_probs, k_top)  # [T, k]
    if k_top > 1:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    tk = tokens * k_top
    B = block_rows
    nb = -(-tk // B) + n_experts  # static bound, per-expert padding included
    flat_e = top_i.reshape(-1)  # [T*k], token-major
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(0) - counts  # unpadded sorted offsets
    rank_sorted = torch.arange(tk, device=dev) - offsets[flat_e[order]]
    ranks = torch.empty_like(order).scatter_(0, order, rank_sorted)

    block_expert, pad_start = block_layout(counts, B, nb)
    # padded slot -> source token (padding reads row 0)
    slot = torch.arange(nb * B, device=dev)
    e_s = block_expert.long()[slot // B]
    rank_s = slot - pad_start[e_s]
    valid = rank_s < counts[e_s]
    src_choice = order[(offsets[e_s] + rank_s).clamp(0, tk - 1)]
    x_pad = x[torch.where(valid, src_choice // k_top, 0)]  # [nb*B, d]

    zg = gmm(x_pad, expert_params["w_gate"].to(x.dtype), block_expert, block_rows=B)
    zu = gmm(x_pad, expert_params["w_up"].to(x.dtype), block_expert, block_rows=B)
    # the combine's gate weights ride the down projection as its row scale,
    # so the combine is a gather and a sum; padded slots scale by 0
    dst = pad_start[flat_e] + ranks  # [T*k], each choice's padded slot
    s_pad = torch.zeros(nb * B, dtype=torch.float32, device=dev).scatter(
        0, dst, top_p.reshape(-1))
    h = gmm(F.silu(zg) * zu, expert_params["w_down"].to(x.dtype), block_expert,
            row_scale=s_pad, block_rows=B)

    gathered = h[dst.reshape(tokens, k_top)]  # [T, k, d], already weighted
    out = gathered.float().sum(dim=1)
    stats = {
        "expert_load": counts.float() / tk,
        "mean_gate": gate_probs.mean(dim=0),
        "drop_frac": torch.zeros((), device=dev),
    }
    return out.to(x.dtype), stats


def moe_apply(x, gate_logits, expert_params, expert_fn: Callable = None, mesh=None,
              axis_name: str = "ep", capacity_factor: float = 2.0,
              dropped: str = "passthrough", batch_axes: tuple = ("dp", "fsdp"),
              k_top: int = 1, return_stats: bool = False, dispatch_impl: str = "sort",
              ragged_expert_fn=None):
    """Top-k MoE layer, the JAX package's signature. Ported: no mesh (or no
    ep axis) with ``dispatch_impl="gmm"``, which computes a SwiGLU expert
    from the stacked {w_gate, w_up, w_down} params, drops nothing, and
    reads its row block from ``TPUJOB_GMM_BLOCK_ROWS`` (default 256).
    ``expert_fn``, ``capacity_factor``, ``dropped`` and ``batch_axes`` do
    not affect that path. Returns out, or (out, stats) with
    ``return_stats``."""
    if dispatch_impl not in ("sort", "einsum", "ragged", "gmm"):
        raise ValueError(f"unknown dispatch_impl {dispatch_impl!r}")
    if mesh is not None and axis_name in getattr(mesh, "axis_names", ()) and (
            mesh.shape[axis_name] > 1):
        raise NotImplementedError(
            "expert parallelism over a mesh is not ported yet (ROADMAP M8, then M11)")
    if dispatch_impl != "gmm":
        raise NotImplementedError(
            f"dispatch_impl={dispatch_impl!r} is not ported yet (ROADMAP M11: "
            "the port runs 'gmm')")
    if set(expert_params) != GMM_PARAM_KEYS:
        raise ValueError(
            "dispatch_impl='gmm' computes a SwiGLU expert from {w_gate, w_up, "
            f"w_down}} stacked params; got param keys {sorted(expert_params)}")
    out, stats = _moe_single_gmm(
        x, gate_logits, expert_params, k_top,
        block_rows=int(os.environ.get("TPUJOB_GMM_BLOCK_ROWS", "256")))
    return (out, stats) if return_stats else out
