"""Mesh construction: logical parallelism axes over the gang's ranks.

Port of ``tf_operator_tpu/parallel/mesh.py``: the axis vocabulary, the
canonical order (``tp`` innermost), ``MeshSpec`` with the same
resolution rules and errors, ``build_mesh`` and ``build_hybrid_mesh``.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose rank
array is laid out exactly as the JAX package lays out its device array
(one process drives one device, so a rank stands for a device). The
rank arrays come from ``mesh_ranks`` and ``hybrid_mesh_ranks`` as numpy
arrays, which need no process group.

- ``dp``    data parallelism (batch split, gradient all-reduce)
- ``fsdp``  fully-sharded data parallelism (batch split + param shards,
            all-gather params / reduce-scatter grads)
- ``tp``    tensor parallelism (column- and row-parallel products)
- ``cp``    context parallelism (ring attention, ROADMAP M12)
- ``pp``    pipeline parallelism (ROADMAP M13)
- ``ep``    expert parallelism (ROADMAP Queue 1 item 4)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

AXIS_DATA = "dp"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tp"
AXIS_CONTEXT = "cp"
AXIS_PIPELINE = "pp"
AXIS_EXPERT = "ep"

# Canonical order, outermost -> innermost (tp innermost: most traffic).
CANONICAL_ORDER = (AXIS_PIPELINE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_CONTEXT, AXIS_TENSOR)

# The axes a batch is split over: every rank of one (dp, fsdp) coordinate
# reads the same rows.
DATA_AXES = (AXIS_DATA, AXIS_FSDP)


@dataclass(frozen=True)
class MeshSpec:
    """A validated logical mesh layout: axis name -> size. One axis may be
    -1 and absorbs the remaining devices; an empty spec is one ``dp``
    axis over all of them."""

    axes: Dict[str, int] = field(default_factory=dict)

    def resolve(self, n_devices: int) -> "MeshSpec":
        axes = dict(self.axes) or {AXIS_DATA: n_devices}
        wild = [k for k, v in axes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = math.prod(v for v in axes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            axes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes {axes} multiply to {fixed} but there are {n_devices} devices"
            )
        return MeshSpec(axes)

    def ordered(self) -> Tuple[Tuple[str, int], ...]:
        """Axes in canonical order; unknown axes keep insertion order and
        come first (outermost)."""
        known = [a for a in CANONICAL_ORDER if a in self.axes]
        unknown = [a for a in self.axes if a not in CANONICAL_ORDER]
        return tuple((a, self.axes[a]) for a in unknown + known)


def mesh_ranks(axes: Optional[Dict[str, int]], ranks: Sequence[int],
               canonical: bool = True) -> Tuple[Tuple[str, ...], np.ndarray]:
    """(axis names, rank array) of a mesh over ``ranks``: the spec resolved
    against their count and the ranks reshaped into the axis sizes, in
    canonical order (``build_mesh``) or in the spec's insertion order
    (``canonical=False``: the job context's mesh)."""
    arr = np.asarray(ranks, dtype=np.int64)
    spec = MeshSpec(dict(axes or {})).resolve(arr.size)
    ordered = spec.ordered() if canonical else tuple(spec.axes.items())
    return tuple(a for a, _ in ordered), arr.reshape(tuple(s for _, s in ordered))


def hybrid_mesh_ranks(ici_axes: Dict[str, int], dcn_axes: Dict[str, int],
                      ranks: Sequence[int]) -> Tuple[Tuple[str, ...], np.ndarray]:
    """(axis names, rank array) of a multi-slice mesh: each axis's size is
    its ici size times its dcn size, and the dcn factor is the outer block
    of the axis. Contiguous equal blocks of ``ranks`` stand for the slices
    (the JAX package's layout off TPU, where the global device list orders
    by process, so process blocks are the slices)."""
    ranks = list(ranks)
    union = dict(dcn_axes)
    union.update({a: s for a, s in ici_axes.items()})
    if not union:
        raise ValueError("hybrid mesh needs at least one axis")
    names = tuple(a for a, _ in MeshSpec({a: 1 for a in union}).ordered())
    ici_shape = [int(ici_axes.get(a, 1)) for a in names]
    dcn_shape = [int(dcn_axes.get(a, 1)) for a in names]
    per_slice = math.prod(ici_shape)
    n_slices = math.prod(dcn_shape)
    if per_slice * n_slices != len(ranks):
        raise ValueError(
            f"hybrid mesh ici{dict(zip(names, ici_shape))} x "
            f"dcn{dict(zip(names, dcn_shape))} needs {per_slice * n_slices} "
            f"devices, have {len(ranks)}"
        )
    k = len(names)
    a = np.asarray(ranks, dtype=np.int64).reshape(tuple(dcn_shape) + tuple(ici_shape))
    perm = [j for i in range(k) for j in (i, i + k)]
    arr = a.transpose(perm).reshape([dcn_shape[i] * ici_shape[i] for i in range(k)])
    return names, arr


def _world_ranks() -> np.ndarray:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: pass ranks, or join the gang first "
                           "(rendezvous.context.initialize_distributed)")
    return np.arange(dist.get_world_size())


def device_mesh(names: Tuple[str, ...], arr: np.ndarray, device_type: str = "cpu"):
    """A DeviceMesh over the rank array ``arr`` with axis names ``names``.
    With a process group it creates one group per axis; without one (the
    CPU tests' layout checks) it creates none and stands at rank 0."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    mesh = torch.from_numpy(np.ascontiguousarray(arr)).to(torch.int)
    if dist.is_available() and dist.is_initialized():
        return DeviceMesh(device_type, mesh, mesh_dim_names=names)
    return DeviceMesh(device_type, mesh, mesh_dim_names=names, _init_backend=False, _rank=0)


def build_mesh(axes: Optional[Dict[str, int]] = None, ranks: Optional[Sequence[int]] = None,
               device_type: str = "cpu"):
    """The DeviceMesh of a logical axis spec in canonical order over
    ``ranks`` (default: every rank of the gang)."""
    names, arr = mesh_ranks(axes, _world_ranks() if ranks is None else ranks)
    return device_mesh(names, arr, device_type)


def build_hybrid_mesh(ici_axes: Dict[str, int], dcn_axes: Dict[str, int],
                      ranks: Optional[Sequence[int]] = None, device_type: str = "cpu"):
    """The DeviceMesh of a multi-slice layout (``hybrid_mesh_ranks``)."""
    names, arr = hybrid_mesh_ranks(ici_axes, dcn_axes,
                                   _world_ranks() if ranks is None else ranks)
    return device_mesh(names, arr, device_type)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, in its order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
