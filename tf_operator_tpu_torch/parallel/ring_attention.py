"""Ring attention: exact attention over a context-parallel (cp) mesh axis.

Port of ``tf_operator_tpu/parallel/ring_attention.py``. The sequence of
Q/K/V is split over the ``cp`` axis; each rank attends its query block
to the K/V block it holds, then passes K/V on around the ring
(``collectives.ring_shift``). After cp hops every query block has seen
every K/V block. GQA-native: the ring carries the [b, t/cp, h_kv, d]
blocks, never repeated K/V.

Two bodies, as in the JAX package:

- ``flash`` (the default, ``_ring_attention_local_flash``): each hop runs
  ``flash_attention_lse`` (K1 on the card; its backward K2/K3 with the
  lse cotangent folded into delta) and the hops merge by their
  log-sum-exp (``_merge_partials``). The diagonal hop (the rank's own
  K/V) is the only one with a causal mask; under causal masking a block
  from a later rank lies wholly in the future and is skipped (its
  kernel never runs; the ring still turns).
- ``einsum`` (``_ring_attention_local``): the blockwise online softmax in
  f32, the oracle.

The inputs are this rank's blocks [b_local, t/cp, h, d]: its rows over
the batch axes and its block of the sequence. The backward flows through
the ring shifts' transposes (shifted back) and the kernels' VJP.

Declared difference: the flash body folds the hops in the order of the
ring (diagonal first, then the blocks of ranks i-1, i-2, ...) as JAX's
scan does; f32 merges of the same partials in another order would round
differently.
"""

from __future__ import annotations

from typing import Optional

import torch

from tf_operator_tpu_torch.ops.flash_attention import NEG_INF, flash_attention_lse
from tf_operator_tpu_torch.parallel import collectives as coll


def _ring_attention_local(q, k, v, mesh, axis_name: str, causal: bool):
    """The einsum body: q [b, t, h, d], k/v [b, t, h_kv, d] (this rank's
    blocks). The online-softmax accumulators in f32, one K/V block a hop,
    the causal mask from global positions. Returns [b, t, h, d] in q's
    dtype."""
    n = coll.axis_size(mesh, axis_name)
    my = coll.axis_index(mesh, axis_name)
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    g = h // h_kv
    scale = d ** -0.5
    qf = q.float().reshape(b, t, h_kv, g, d)
    o = torch.zeros(b, h_kv, g, t, d, device=q.device)
    m = torch.full((b, h_kv, g, t), float("-inf"), device=q.device)
    l = torch.zeros(b, h_kv, g, t, device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        if step:
            k_blk = coll.ring_shift(k_blk, mesh, axis_name)
            v_blk = coll.ring_shift(v_blk, mesh, axis_name)
        src = (my - step) % n  # the rank whose block this is
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_blk.float()) * scale
        if causal:
            q_pos = my * t + torch.arange(t, device=q.device)
            k_pos = src * t + torch.arange(t, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # exp(-inf - -inf) is nan: an empty running max contributes 0
        alpha = torch.exp(torch.where(torch.isneginf(m), float("-inf"), m - m_new))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(torch.isneginf(m_new)[..., None], 0.0, p)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk.float())
        m = m_new
    o = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return torch.einsum("bhgqd->bqhgd", o).reshape(b, t, h, d).to(q.dtype)


def _merge_partials(o, m, d_acc, o_j, lse_j):
    """Fold one normalised partial (o_j [b, t, h, d], lse_j [b, t, h]) into
    the running merge: o = Σ o_i·exp(lse_i - m) (f32), d_acc = Σ exp(lse_i
    - m), m the largest lse so far. A masked partial (lse <= NEG_INF/2,
    the kernels' finite sentinel or an empty carry's -inf) weighs 0."""
    m_new = torch.maximum(m, lse_j)
    alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
    beta = torch.where(lse_j <= NEG_INF / 2, 0.0, torch.exp(lse_j - m_new))
    o_new = o * alpha[..., None] + o_j.float() * beta[..., None]
    return o_new, m_new, d_acc * alpha + beta


def _in_future(src: int, my: int) -> bool:
    """Whether rank ``src``'s K/V block lies wholly after rank ``my``'s
    queries in the sequence (a causal hop that contributes nothing)."""
    return src > my


class _SkippedHop(torch.autograd.Function):
    """A hop whose block lies wholly in the future: the masked partial (o
    zeros, lse -inf) with zero cotangents for q, k and v. It stands where
    the flash call would, so every rank's graph has one node a hop and the
    backward runs the ring shifts' transposes in the same order on every
    rank (a block left out of the graph would skip its shift's transpose
    on this rank alone, and the ring would hang)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.like = [(x.shape, x.dtype) for x in (q, k, v)]
        b, t, h, _ = q.shape
        return torch.zeros_like(q), torch.full((b, t, h), float("-inf"), device=q.device)

    @staticmethod
    def backward(ctx, do, dlse):
        return tuple(torch.zeros(s, dtype=t, device=do.device) for s, t in ctx.like)


def _ring_attention_local_flash(q, k, v, mesh, axis_name: str, causal: bool):
    """The flash body: the diagonal hop (the rank's own K/V, the causal
    mask iff causal) first, then each arriving block unmasked, a block of a
    later rank skipped under causal masking; the partials merged by lse."""
    n = coll.axis_size(mesh, axis_name)
    my = coll.axis_index(mesh, axis_name)
    b, t, h, _ = q.shape
    o0, lse0 = flash_attention_lse(q, k, v, causal=causal)
    acc = _merge_partials(torch.zeros(o0.shape, device=q.device),
                          torch.full((b, t, h), float("-inf"), device=q.device),
                          torch.zeros(b, t, h, device=q.device), o0, lse0)
    k_blk, v_blk = k, v
    for step in range(1, n):
        k_blk = coll.ring_shift(k_blk, mesh, axis_name)
        v_blk = coll.ring_shift(v_blk, mesh, axis_name)
        if causal and _in_future((my - step) % n, my):
            part = _SkippedHop.apply(q, k_blk, v_blk)
        else:
            part = flash_attention_lse(q, k_blk, v_blk, causal=False)
        acc = _merge_partials(*acc, *part)
    o, _, d_acc = acc
    return (o / torch.where(d_acc == 0.0, 1.0, d_acc)[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "cp", causal: bool = False,
                   impl: Optional[str] = None):
    """Exact self-attention with the sequence split over ``axis_name``.

    q [b, t/cp, h, d], k/v [b, t/cp, h_kv, d]: this rank's blocks (its
    rows over the batch axes, which the computation keeps as they are).
    ``impl``: "flash" (default) or "einsum". Returns this rank's output block [b, t/cp, h, d]."""
    if q.shape[1] != k.shape[1] or k.shape[1] != v.shape[1]:
        raise ValueError(
            f"ring attention is self-attention: q/k/v seq lengths must match, "
            f"got {q.shape[1]}/{k.shape[1]}/{v.shape[1]}")
    if k.shape[2] != v.shape[2]:
        raise ValueError(f"k/v head mismatch: {k.shape[2]} vs {v.shape[2]}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]} "
            "(GQA group must divide evenly)")
    if impl not in (None, "flash", "einsum"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    body = _ring_attention_local if impl == "einsum" else _ring_attention_local_flash
    return body(q, k, v, mesh, axis_name, causal)
