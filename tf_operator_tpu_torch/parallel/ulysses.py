"""Ulysses sequence parallelism: the heads/sequence all-to-all re-shard.

Port of ``tf_operator_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses). Where
ring attention keeps the heads whole and passes K/V blocks around the cp
ring, Ulysses re-shards once an attention: an ``all_to_all`` turns [t/cp,
all heads] into [all of t, h/cp heads], each rank runs ordinary attention
over the whole sequence on its heads (``flash_attention``: the kernels
K1-K3 on the card, their plain versions on the CPU), and a second
``all_to_all`` restores the sequence split. The backward is the reverse
all-to-alls (``collectives.all_to_all``).

GQA: with n_kv % cp == 0 K/V go through the all-to-all on their own head
dim, and the local attention is GQA-native (h/cp query and n_kv/cp KV
heads, the contiguous head blocks keeping query head j on KV head
j // group). Otherwise (``gather_kv``) K/V are all-gathered over cp on the
sequence dim and each rank takes the KV head of each of its h/cp query
heads, an equal-headed local problem.
"""

from __future__ import annotations

import torch

from tf_operator_tpu_torch.ops.flash_attention import flash_attention
from tf_operator_tpu_torch.parallel import collectives as coll


def _ulysses_local(q, k, v, mesh, axis_name: str, causal: bool, gather_kv: bool):
    """q/k/v: this rank's sequence blocks [b, t/cp, h, d]. Returns its
    output block [b, t/cp, h, d] in q's dtype."""
    n = coll.axis_size(mesh, axis_name)

    def seq_to_heads(x):  # [b, t/cp, h, d] -> [b, t, h/cp, d]
        return coll.all_to_all(x, mesh, axis_name, split_dim=2, concat_dim=1)

    qg = seq_to_heads(q)
    if gather_kv:
        h, h_kv = q.shape[2], k.shape[2]
        g, h_loc = h // h_kv, h // n
        kg = coll.all_gather(k, mesh, axis_name, dim=1)
        vg = coll.all_gather(v, mesh, axis_name, dim=1)
        first = coll.axis_index(mesh, axis_name) * h_loc
        head_map = (first + torch.arange(h_loc, device=q.device)) // g
        kg = kg.index_select(2, head_map).contiguous()
        vg = vg.index_select(2, head_map).contiguous()
    else:
        kg, vg = seq_to_heads(k), seq_to_heads(v)
    out = flash_attention(qg.contiguous(), kg.contiguous(), vg.contiguous(), causal=causal)
    # [b, t, h/cp, d] -> [b, t/cp, h, d]
    return coll.all_to_all(out.to(q.dtype), mesh, axis_name, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, mesh, axis_name: str = "cp", causal: bool = False):
    """Exact self-attention with the sequence split over ``axis_name`` by the
    head/sequence re-shard. q [b, t/cp, h, d], k/v [b, t/cp, h_kv, d]: this
    rank's blocks; h % cp == 0. The full-sequence attention is
    ``flash_attention`` (GQA-shaped K/V when n_kv % cp == 0)."""
    cp = coll.axis_size(mesh, axis_name)
    h, h_kv = q.shape[2], k.shape[2]
    if h % cp:
        raise ValueError(
            f"ulysses needs heads % cp == 0 (got {h} heads, cp={cp}) — "
            "use attn_impl='ring' for head counts the cp axis cannot split")
    if k.shape[2] != v.shape[2]:
        raise ValueError(f"k/v head mismatch: {k.shape[2]} vs {v.shape[2]}")
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    gather_kv = bool(h_kv != h and h_kv % cp)
    return _ulysses_local(q, k, v, mesh, axis_name, causal, gather_kv)
