"""Sharding rules: logical array axes -> mesh axes -> placements.

Port of ``tf_operator_tpu/parallel/sharding.py``. Models annotate arrays
with logical axis names ("batch", "embed", "mlp", "heads", ...) and a
``ShardingRules`` table maps them to mesh axes. Where the JAX package
returns a ``NamedSharding``, the port returns a placement: for each
tensor dimension the mesh axes it is split over, as the entries of a
``PartitionSpec`` (None, an axis name, or a tuple of names, major to
minor), with the axes the mesh lacks dropped. ``shard_tensor`` and
``gather_shards`` cut a whole array into a rank's block and put the
blocks back together.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from tf_operator_tpu_torch.parallel.mesh import (
    AXIS_CONTEXT,
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPELINE,
    AXIS_TENSOR,
)

MeshAxes = Union[str, Tuple[str, ...], None]


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


@dataclass(frozen=True)
class ShardingRules:
    """Logical-name -> mesh-axis mapping. None = replicate."""

    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def mesh_axes_for(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)

    def placement(self, mesh, logical_axes: Sequence[Optional[str]]) -> Tuple[MeshAxes, ...]:
        """The PartitionSpec entries of an array with these logical axes
        on ``mesh``; references to axes the mesh lacks are dropped."""
        names = _names(mesh)
        parts = []
        for ax in logical_axes:
            m = self.mesh_axes_for(ax)
            if isinstance(m, str) and m not in names:
                m = None
            elif isinstance(m, tuple):
                m = tuple(a for a in m if a in names) or None
                if m is not None and len(m) == 1:
                    m = m[0]  # as PartitionSpec normalizes a 1-tuple
            parts.append(m)
        return tuple(parts)


# The transformer rule set (scaling-book layout): batch over dp+fsdp,
# params sharded over fsdp (all-gathered per layer) and tp (stay
# sharded), sequence over cp, experts over ep, stacked layers over pp.
DEFAULT_RULES = ShardingRules(
    rules={
        "batch": (AXIS_DATA, AXIS_FSDP),
        "seq": AXIS_CONTEXT,
        "embed": AXIS_FSDP,
        "heads": AXIS_TENSOR,
        "kv_heads": AXIS_TENSOR,
        "mlp": AXIS_TENSOR,
        "vocab": AXIS_TENSOR,
        "expert": AXIS_EXPERT,
        "layers": AXIS_PIPELINE,
        "head_dim": None,
        "kv": None,
    }
)


def split_axes(part: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one placement entry, major to minor."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def batch_sharding(mesh, rules: ShardingRules = DEFAULT_RULES) -> Tuple[MeshAxes, ...]:
    """The placement of a [batch, ...] data array's leading dim."""
    return rules.placement(mesh, ["batch"])


def placements(mesh, logical_axes: Any, rules: ShardingRules = DEFAULT_RULES) -> Any:
    """A placement for every leaf of a logical-axes tree (leaves are tuples
    of logical names; nested dicts and lists keep their structure)."""
    if isinstance(logical_axes, dict):
        return {k: placements(mesh, v, rules) for k, v in logical_axes.items()}
    if isinstance(logical_axes, list):
        return [placements(mesh, v, rules) for v in logical_axes]
    return rules.placement(mesh, list(logical_axes))


def axis_coords(mesh, rank: int) -> Dict[str, int]:
    """{axis: index} of ``rank`` in the mesh's rank array."""
    where = np.argwhere(mesh.mesh.numpy() == rank)
    if not len(where):
        raise ValueError(f"rank {rank} is not in the mesh")
    return dict(zip(_names(mesh), (int(i) for i in where[0])))


def _blocks(mesh, part: MeshAxes, coords: Dict[str, int]) -> Tuple[int, int]:
    """(block count, this coordinate's block index) of one dimension: the
    dimension is cut into the product of its axes' sizes, the first axis
    major."""
    shape = dict(zip(_names(mesh), mesh.mesh.shape))
    n, idx = 1, 0
    for ax in split_axes(part):
        n, idx = n * shape[ax], idx * shape[ax] + coords[ax]
    return n, idx


def shard_tensor(x, mesh, placement: Sequence[MeshAxes], rank: int):
    """``rank``'s block of the whole array ``x`` (numpy or torch) under
    ``placement``; each split dimension must divide evenly."""
    coords = axis_coords(mesh, rank)
    out = x
    for dim, part in enumerate(placement):
        n, idx = _blocks(mesh, part, coords)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split {n} ways "
                             f"({part})")
        size = x.shape[dim] // n
        index = [slice(None)] * len(x.shape)
        index[dim] = slice(idx * size, (idx + 1) * size)
        out = out[tuple(index)]
    return out


def gather_shards(blocks: Dict[int, Any], mesh, placement: Sequence[MeshAxes]):
    """The whole numpy array from every rank's block (``{rank: block}``),
    the inverse of ``shard_tensor``; ranks holding the same block must
    hold equal copies."""
    first = next(iter(blocks.values()))
    counts = []
    for dim, part in enumerate(placement):
        n, _ = _blocks(mesh, part, axis_coords(mesh, next(iter(blocks))))
        counts.append(n)
    shape = tuple(s * n for s, n in zip(first.shape, counts))
    out = np.empty(shape, dtype=np.asarray(first).dtype)
    for rank, block in blocks.items():
        coords = axis_coords(mesh, rank)
        index = []
        for dim, part in enumerate(placement):
            _, idx = _blocks(mesh, part, coords)
            size = block.shape[dim]
            index.append(slice(idx * size, (idx + 1) * size))
        out[tuple(index)] = np.asarray(block)
    return out


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class MeshPlan:
    """How one rank holds a params tree on a mesh: each leaf's placement
    (from logical axes and rules; a leaf without logical axes is
    replicated), this rank's coordinates, and the data split of a batch
    (its block of the leading dim over the batch axes, dp then fsdp)."""

    def __init__(self, mesh, logical_axes: Any = None,
                 rules: ShardingRules = DEFAULT_RULES, rank: Optional[int] = None) -> None:
        from tf_operator_tpu_torch.parallel.mesh import DATA_AXES

        self.mesh = mesh
        self.rules = rules
        self.rank = _rank() if rank is None else int(rank)
        self.coords = axis_coords(mesh, self.rank)
        self.sizes = dict(zip(_names(mesh), (int(s) for s in mesh.mesh.shape)))
        self.placements = None if logical_axes is None else placements(mesh, logical_axes, rules)
        # the data axes a batch is split over, and the ones of size > 1
        # whose gradients are summed
        self.batch_part = batch_sharding(mesh, rules)[0]
        self.data_axes = tuple(a for a in DATA_AXES if self.sizes.get(a, 1) > 1)
        self.data_size, self.data_index = _blocks(mesh, self.batch_part, self.coords)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def data_rows(self, x):
        """This rank's rows of a global batch (leading dim)."""
        n = x.shape[0]
        if n % self.data_size:
            raise ValueError(f"batch {n} does not split over {self.data_size} data ranks "
                             f"({self.batch_part})")
        rows = n // self.data_size
        return x[self.data_index * rows:(self.data_index + 1) * rows]

    def gather(self, x, placement: Sequence[MeshAxes], keep: Sequence[str] = (),
               replicated: Sequence[str] = ()):
        """The leaf ``x`` all-gathered over its split axes but ``keep``
        (e.g. tp for a column- or row-parallel weight); the backward
        reduce-scatters, or keeps this rank's block over the axes in
        ``replicated`` (a cotangent the same on every rank of the axis)."""
        from tf_operator_tpu_torch.parallel.collectives import all_gather

        for dim, part in enumerate(placement):
            for ax in reversed(split_axes(part)):
                if ax not in keep:
                    x = all_gather(x, self.mesh, ax, dim, replicated_grad=ax in replicated)
        return x
