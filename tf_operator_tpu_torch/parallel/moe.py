"""Mixture-of-experts routing and dispatch for the port: every dispatch on
one device.

Port of the single-device subset of ``tf_operator_tpu/parallel/moe.py``:
``expert_capacity``; the capacity dispatches ``sort`` (``_route_sparse``:
a stable sort of the token choices, an inbox built by scatter-add with a
dump row for dropped choices, ``_combine_sparse`` a gather) and
``einsum`` (``_route``: one-hot [T, E, C] dispatch and combine products,
the sort path's parity oracle), both running ``expert_fn`` as one batched
product over the stacked [E, C, d] inbox, with ``dropped`` choosing what a
token that lost every choice yields (``_dropped_value``); ``ragged``
(``_moe_single_ragged``: the choices sorted by expert, no capacity, the
experts as one product per expert over their rows, ``ragged_swiglu``);
``gmm`` (``_moe_single_gmm``: rows padded per expert only to the
kernel's row block, the three SwiGLU expert products as grouped matmuls,
the gate weights riding the down projection as its row scale); and
``moe_apply``'s branch without a mesh. Not ported yet, and raising: every
expert-parallel path over a mesh (ROADMAP Queue 1 item 4).

Declared differences: ``expert_fn`` takes the stacked params and the
stacked [E, C, d] tokens (one batched product), where JAX vmaps a
one-expert function; ``ragged_swiglu`` casts the experts to the tokens'
dtype and syncs the host once a call for the segment sizes (JAX's
``ragged_dot`` takes them on the device).

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


def _routing(gate_logits, k_top: int):
    """(gate_probs [T, E] f32, top_p [T, k], top_i [T, k]): the router's
    softmax and each token's k best experts, their gate weights
    renormalised to sum to 1 when k > 1 (the Mixtral rule)."""
    gate_probs = torch.softmax(gate_logits.float(), dim=-1)
    top_p, top_i = _top_k(gate_probs, k_top)
    if k_top > 1:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return gate_probs, top_p, top_i


def _renormalise_survivors(w, kept, k_top: int, dropped: str):
    """``passthrough`` with k > 1: the weights renormalised over the choices
    that kept a slot, so a partly dropped token stays a full-strength mix;
    a token that kept none keeps its weights (its output is the dropped
    value). ``zero``: a dropped choice just contributes 0. The division
    runs on 1 where nothing survived: JAX divides by max(0, 1e-20) there,
    whose square flushes to 0 in the untaken branch's gradient and gives
    that token's router gradient NaN (ROADMAP Queue 3, F2); here it is 0."""
    if k_top > 1 and dropped == "passthrough":
        surviving = (w * kept).sum(dim=-1, keepdim=True)
        denom = torch.where(surviving > 0, surviving.clamp(min=1e-20), 1.0)
        w = torch.where(surviving > 0, w * kept / denom, w)
    return w


def _route(x, gate_logits, capacity: int, k_top: int = 1, dropped: str = "passthrough"):
    """One-hot routing (the einsum dispatch): each token's k choices claim
    queue slots in token order per expert; past ``capacity`` a choice
    drops. Returns (dispatch_w [T, E, C] combine weights, keep_any [T],
    inbox [E, C, d] f32, stats {expert_load [E], mean_gate [E],
    drop_frac})."""
    gate_probs, top_p, top_i = _routing(gate_logits, k_top)
    n_experts = gate_logits.shape[-1]
    choice_onehot = F.one_hot(top_i, n_experts).float()  # [T, k, E]
    assign = choice_onehot.sum(dim=1)  # [T, E], 0/1 (the choices are distinct)
    w = torch.einsum("tke,tk->te", choice_onehot, top_p)
    pos = (assign.cumsum(dim=0) - 1.0) * assign  # queue position of each choice
    kept = assign * (pos < capacity)
    w = _renormalise_survivors(w, kept, k_top, dropped)
    # one_hot of a position past the queue is all zeros, as in jax.nn.one_hot
    slots = torch.arange(capacity, device=x.device, dtype=pos.dtype)
    dispatch = kept[:, :, None] * (pos[:, :, None] == slots).float()  # [T, E, C] 0/1
    dispatch_w = dispatch * w[:, :, None]
    keep_any = kept.sum(dim=-1) > 0
    inbox = torch.einsum("tec,td->ecd", dispatch, x.float())
    n_choices = float(x.shape[0] * k_top)
    stats = {"expert_load": assign.sum(dim=0) / n_choices,
             "mean_gate": gate_probs.mean(dim=0),
             "drop_frac": 1.0 - kept.sum() / n_choices}
    return dispatch_w, keep_any, inbox, stats


def _sorted_choices(top_i, n_experts: int):
    """(flat_e [T·k] token-major, order: the choices sorted by expert, ties
    in token order (a stable sort, so each expert's queue is in token
    order), counts [E], ranks [T·k]: each choice's place in its expert's
    queue)."""
    flat_e = top_i.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.zeros(n_experts, dtype=torch.long, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = counts.cumsum(0) - counts
    rank_sorted = torch.arange(flat_e.numel(), device=flat_e.device) - offsets[flat_e[order]]
    ranks = torch.empty_like(order).scatter_(0, order, rank_sorted)
    return flat_e, order, counts, ranks


def _route_sparse(x, gate_logits, capacity: int, k_top: int = 1,
                  dropped: str = "passthrough"):
    """Sort-based routing with _route's queues (the same kept choices and
    stats) without the [T, E, C] tensors. Returns (slot [T, k]: each
    choice's flat inbox slot e·C + rank, or E·C (the dump row) where it
    dropped; w [T, k] f32 combine weights; keep_any [T]; inbox [E, C, d]
    f32, built by a scatter-add whose dump row is sliced off; stats)."""
    gate_probs, top_p, top_i = _routing(gate_logits, k_top)
    tokens, d = x.shape
    n_experts = gate_logits.shape[-1]
    flat_e, _, counts, ranks = _sorted_choices(top_i, n_experts)
    kept = (ranks < capacity).reshape(tokens, k_top)
    slot = torch.where(kept, (flat_e * capacity + ranks).reshape(tokens, k_top),
                       n_experts * capacity)
    w = _renormalise_survivors(top_p, kept, k_top, dropped)
    keep_any = kept.any(dim=-1)
    x_rep = x.float()[:, None, :].expand(tokens, k_top, d).reshape(tokens * k_top, d)
    inbox = torch.zeros(n_experts * capacity + 1, d, device=x.device).index_add(
        0, slot.reshape(-1), x_rep)
    inbox = inbox[:-1].reshape(n_experts, capacity, d)
    n_choices = float(tokens * k_top)
    stats = {"expert_load": counts.float() / n_choices,
             "mean_gate": gate_probs.mean(dim=0),
             "drop_frac": 1.0 - kept.sum() / n_choices}
    return slot, w, keep_any, inbox, stats


def _combine_sparse(outbox, slot, w):
    """out[t] = Σ_k w[t, k] · outbox_flat[slot[t, k]], with the dump row
    appended as zeros (a dropped choice adds nothing in ``zero`` mode,
    where its weight is kept)."""
    n_experts, capacity, d = outbox.shape
    flat = torch.cat([outbox.reshape(n_experts * capacity, d), outbox.new_zeros(1, d)])
    return torch.einsum("tk,tkd->td", w, flat[slot])


def _dropped_value(x, dropped: str):
    """What a token that lost every choice yields: its input
    (``passthrough``) or nothing (``zero``, for a residual branch)."""
    if dropped == "passthrough":
        return x.float()
    if dropped == "zero":
        return torch.zeros_like(x, dtype=torch.float32)
    raise ValueError(f"unknown dropped mode {dropped!r}")


def ragged_dot(x, w, sizes):
    """Rows of x grouped by expert (``sizes`` rows each, a list) times
    their expert's w [E, k, n]: one product per expert."""
    return torch.cat([seg @ w[e] for e, seg in enumerate(torch.split(x, sizes))])


def ragged_swiglu(expert_params, x_sorted, group_sizes):
    """The SwiGLU experts over rows sorted by expert, ``group_sizes`` [E]
    rows each (no capacity, no padding); the expert weights are cast to the
    rows' dtype. The sizes come to the host once a call."""
    sizes = group_sizes.tolist()
    w = {k: v.to(x_sorted.dtype) for k, v in expert_params.items()}
    zg = ragged_dot(x_sorted, w["w_gate"], sizes)
    zu = ragged_dot(x_sorted, w["w_up"], sizes)
    return ragged_dot(F.silu(zg) * zu, w["w_down"], sizes)


def _moe_single_ragged(x, gate_logits, expert_params, ragged_expert_fn, k_top: int = 1):
    """All experts on one device without capacity: the T·k choices sorted
    by expert (a row gather), the experts run by ``ragged_expert_fn`` over
    the actual per-expert counts, and a gather-combine. Nothing drops."""
    tokens, _ = x.shape
    n_experts = gate_logits.shape[-1]
    gate_probs, top_p, top_i = _routing(gate_logits, k_top)
    _, order, counts, _ = _sorted_choices(top_i, n_experts)
    h = ragged_expert_fn(expert_params, x[order // k_top], counts)  # [T·k, d]
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(),
                                                                  device=order.device))
    out = torch.einsum("tk,tkd->td", top_p, h[inv.reshape(tokens, k_top)].float())
    stats = {"expert_load": counts.float() / (tokens * k_top),
             "mean_gate": gate_probs.mean(dim=0),
             "drop_frac": torch.zeros((), device=x.device)}
    return out.to(x.dtype), stats


def _moe_single(x, gate_logits, expert_params, expert_fn, capacity: int, dropped: str,
                k_top: int = 1, dispatch_impl: str = "sort"):
    """The capacity dispatches on one device: route (sort or einsum), run
    ``expert_fn`` once over the stacked [E, C, d] inbox in x's dtype, and
    combine; a token that lost every choice yields _dropped_value."""
    if expert_fn is None:
        raise ValueError(f"dispatch_impl={dispatch_impl!r} needs an expert_fn")
    if dispatch_impl == "sort":
        slot, w, keep_any, inbox, stats = _route_sparse(x, gate_logits, capacity, k_top,
                                                        dropped)
    else:
        dispatch_w, keep_any, inbox, stats = _route(x, gate_logits, capacity, k_top, dropped)
    outbox = expert_fn(expert_params, inbox.to(x.dtype)).float()
    if dispatch_impl == "sort":
        combined = _combine_sparse(outbox, slot, w)
    else:
        combined = torch.einsum("tec,ecd->td", dispatch_w, outbox)
    out = torch.where(keep_any[:, None], combined, _dropped_value(x, dropped))
    return out.to(x.dtype), stats


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
    gate_probs, top_p, top_i = _routing(gate_logits, k_top)

    tk = tokens * k_top
    B = block_rows
    nb = -(-tk // B) + n_experts  # static bound, per-expert padding included
    flat_e, order, counts, ranks = _sorted_choices(top_i, n_experts)
    offsets = counts.cumsum(0) - counts  # unpadded sorted offsets

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
    """Top-k MoE layer, the JAX package's signature, without a mesh (or
    without an ep axis of more than one device). ``sort`` and ``einsum``
    route into capacity queues of cf·k·T/E and run ``expert_fn(stacked
    params, [E, C, d] tokens)``; ``ragged`` runs ``ragged_expert_fn``
    (e.g. ragged_swiglu) over the actual per-expert counts; ``gmm``
    computes a SwiGLU expert from the stacked {w_gate, w_up, w_down}
    params on the grouped-matmul kernels and reads its row block from
    ``TPUJOB_GMM_BLOCK_ROWS`` (default 256). ragged and gmm drop nothing
    and ignore ``capacity_factor`` and ``dropped``; ``batch_axes`` has no
    effect without a mesh. Returns out, or (out, stats) with
    ``return_stats``."""
    if dispatch_impl not in ("sort", "einsum", "ragged", "gmm"):
        raise ValueError(f"unknown dispatch_impl {dispatch_impl!r}")
    if mesh is not None and axis_name in getattr(mesh, "axis_names", ()) and (
            mesh.shape[axis_name] > 1):
        raise NotImplementedError(
            "expert parallelism over a mesh is not ported yet (ROADMAP Queue 1 item 4)")
    if dispatch_impl == "gmm":
        if set(expert_params) != GMM_PARAM_KEYS:
            raise ValueError(
                "dispatch_impl='gmm' computes a SwiGLU expert from {w_gate, w_up, "
                f"w_down}} stacked params; got param keys {sorted(expert_params)}")
        out, stats = _moe_single_gmm(
            x, gate_logits, expert_params, k_top,
            block_rows=int(os.environ.get("TPUJOB_GMM_BLOCK_ROWS", "256")))
    elif dispatch_impl == "ragged":
        if ragged_expert_fn is None:
            raise ValueError("dispatch_impl='ragged' needs a ragged_expert_fn "
                             "(e.g. parallel.moe.ragged_swiglu)")
        out, stats = _moe_single_ragged(x, gate_logits, expert_params, ragged_expert_fn,
                                        k_top)
    else:
        capacity = expert_capacity(capacity_factor, k_top, x.shape[0], gate_logits.shape[-1])
        out, stats = _moe_single(x, gate_logits, expert_params, expert_fn, capacity, dropped,
                                 k_top, dispatch_impl)
    return (out, stats) if return_stats else out
