"""Fused (blockwise) softmax cross-entropy over a tied vocab projection.

Port of ``tf_operator_tpu/ops/fused_cross_entropy.py``. The naive LM loss
holds f32 logits ``[n, vocab]`` in memory (gqa-2048 at b 6, t 2048:
12,282 x 32,000 x 4 B = 1.57 GB) and autodiff keeps them for the
backward. Here the hidden states go through in row blocks: each block's
``[rows, vocab]`` logits tile is reduced at once to a log-sum-exp and the
target logit, and the backward recomputes the tile to form
``softmax - onehot``. The only residual is the per-token LSE.

Not a kernel: the products are matrix products (cuBLAS on the card).
Precision follows the JAX package's ``preferred_element_type=f32``: the
logits tile, the LSE and the products of the backward are f32, computed
from the bf16-rounded operands (see ``_dot_f32``).
"""

from __future__ import annotations

from typing import Optional

import torch


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result and f32 accumulation, as JAX's
    ``jnp.dot(..., preferred_element_type=f32)``: a bf16 x bf16 product is
    exact in f32, so the only rounding is the f32 sums. On the card a bf16
    pair runs on the tensor cores with an f32 output (``out_dtype``); the
    CPU upcasts the operands, which gives the same products."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _WeightedXentSum(torch.autograd.Function):
    """sum(w * xent) over row blocks; saves x, embed and the per-row LSE."""

    @staticmethod
    def forward(ctx, x, embed, targets, weights, r):
        et = embed.to(x.dtype)  # one cast, reused by every block
        n_pad, d = x.shape
        lse = torch.empty(n_pad, dtype=torch.float32, device=x.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(0, n_pad, r):
            logits = _dot_f32(x[s: s + r], et.T)
            blk_lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(1, targets[s: s + r, None])[:, 0]
            loss_sum = loss_sum + (weights[s: s + r] * (blk_lse - tgt)).sum()
            lse[s: s + r] = blk_lse
        ctx.save_for_backward(x, embed, targets, weights, lse)
        ctx.r = r
        return loss_sum

    @staticmethod
    def backward(ctx, g):
        x, embed, targets, weights, lse = ctx.saved_tensors
        r = ctx.r
        et = embed.to(x.dtype)
        coef = g * weights
        dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        d_embed = torch.zeros(embed.shape, dtype=torch.float32, device=x.device)
        rows = torch.arange(r, device=x.device)
        for s in range(0, x.shape[0], r):
            x_c = x[s: s + r]
            p = torch.exp(_dot_f32(x_c, et.T) - lse[s: s + r, None])  # softmax, recomputed
            p[rows[: len(x_c)], targets[s: s + r]] -= 1.0  # minus onehot(target)
            pc = (p * coef[s: s + r, None]).to(x.dtype)
            dx[s: s + r] = _dot_f32(pc, et)
            d_embed += _dot_f32(pc.T, x_c)
        return dx.to(x.dtype), d_embed.to(embed.dtype), None, None, None


def fused_cross_entropy(
    x: torch.Tensor,
    embed: torch.Tensor,
    targets: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    row_block: int = 1024,
) -> torch.Tensor:
    """Mean softmax cross-entropy of ``x @ embed.T`` against ``targets``.

    x: [n, d] hidden states (bf16 or f32), differentiated. embed: [vocab, d]
    tied table (f32 params), differentiated. targets: [n] int class ids.
    weights: optional [n] per-token weights; the loss is
    ``sum(w * xent) / max(sum(w), 1)``, the plain mean when omitted.
    row_block: tokens per block. Returns a scalar f32 loss."""
    loss_sum, weight_sum = fused_cross_entropy_sums(x, embed, targets, weights,
                                                    row_block=row_block)
    return loss_sum / torch.clamp(weight_sum, min=1.0)


def fused_cross_entropy_sums(
    x: torch.Tensor,
    embed: torch.Tensor,
    targets: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    row_block: int = 1024,
):
    """``fused_cross_entropy``'s numerator ``sum(w * xent)`` (differentiated)
    and denominator ``sum(w)``, for a loss whose sums span ranks."""
    n, _ = x.shape
    if n == 0:
        raise ValueError(
            "fused_cross_entropy needs at least one row (n=0; causal lm_loss "
            "with seq_len=1 produces an empty target set)"
        )
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=x.device)
    weights = weights.float()
    targets = targets.long()
    r = min(row_block, _round_up(n, 8))
    n_pad = _round_up(n, r)
    if n_pad != n:
        x = torch.cat([x, x.new_zeros(n_pad - n, x.shape[1])])
        targets = torch.cat([targets, targets.new_zeros(n_pad - n)])
        weights = torch.cat([weights, weights.new_zeros(n_pad - n)])  # pad rows weigh zero
    return _WeightedXentSum.apply(x, embed, targets, weights, r), weights.sum()
