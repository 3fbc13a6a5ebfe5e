"""Parameter trees across the JAX/PyTorch seam, as numpy arrays.

The JAX package's params are nested dicts and lists of arrays: the
transformer's ``embed``, ``final_norm`` and ``layers/{attn_norm,wq,wk,wv,
wo,mlp_norm,w_gate,w_up,w_down}`` (layer leaves stacked ``[L, ...]``);
ResNet's ``stem``, ``head`` and ``stage{i}``, each stage a list of block
dicts. The port keeps the same keys, order and shapes, so a tree converts
leaf by leaf with a plain copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from tf_operator_tpu_torch.device import DeviceLike, resolve_device


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of nested dicts, lists and tuples (the
    containers keep their type and order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """numpy (or array-like) leaves -> torch tensors on ``device``, same
    dtype and bits (each leaf is copied, never aliased)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """torch leaves -> numpy arrays on the host, same dtype and bits."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def _zip_placements(tree: Any, placement_tree: Any, fn: Callable) -> Any:
    """fn(leaf, placement) over a params tree and its placements tree (a
    placement is a tuple, so only dicts and lists are walked in it)."""
    if isinstance(tree, dict):
        return {k: _zip_placements(v, placement_tree[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_placements(v, p, fn) for v, p in zip(tree, placement_tree)]
    return fn(tree, placement_tree)


def shard_params(full: Dict[str, Any], mesh, logical_axes: Any, rank: int,
                 rules=None) -> Dict[str, Any]:
    """``rank``'s blocks of a whole params tree (numpy or torch leaves, as
    given) on ``mesh`` under ``logical_axes`` (DEFAULT_RULES by default):
    JAX's params load onto any mesh this way."""
    from tf_operator_tpu_torch.parallel.sharding import DEFAULT_RULES, placements, shard_tensor

    place = placements(mesh, logical_axes, rules or DEFAULT_RULES)
    return _zip_placements(full, place, lambda x, p: shard_tensor(x, mesh, p, rank))


def gather_params(blocks: Dict[int, Dict[str, Any]], mesh, logical_axes: Any,
                  rules=None) -> Dict[str, Any]:
    """The whole params tree, as numpy, from every rank's blocks
    (``{rank: tree}``): the inverse of ``shard_params``."""
    from tf_operator_tpu_torch.parallel.sharding import DEFAULT_RULES, gather_shards, placements

    place = placements(mesh, logical_axes, rules or DEFAULT_RULES)
    as_np = {r: tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                         else np.asarray(t), tree) for r, tree in blocks.items()}
    ranks = list(as_np)

    def leaf_paths(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: leaf_paths(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [leaf_paths(v, prefix + (i,)) for i, v in enumerate(tree)]
        return prefix

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    return _zip_placements(leaf_paths(as_np[ranks[0]]), place, lambda path, p: gather_shards(
        {r: at(as_np[r], path) for r in ranks}, mesh, p))
