"""Parameter trees across the JAX/PyTorch seam, as numpy arrays.

The JAX package's params are nested dicts of arrays (``embed``,
``final_norm``, ``layers/{attn_norm,wq,wk,wv,wo,mlp_norm,w_gate,w_up,
w_down}``, layer leaves stacked ``[L, ...]``). The port keeps the same
keys and shapes, so a tree converts leaf by leaf with a plain copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from tf_operator_tpu_torch.device import DeviceLike, resolve_device


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """numpy (or array-like) leaves -> torch tensors on ``device``, same
    dtype and bits (each leaf is copied, never aliased)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """torch leaves -> numpy arrays on the host, same dtype and bits."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
