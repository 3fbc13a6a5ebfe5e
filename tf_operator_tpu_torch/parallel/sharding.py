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

The block algebra of a checkpoint (``train/checkpoint.py``): under a
placement a dimension split over axes of sizes s1, s2 (major to minor)
is cut into s1 * s2 equal blocks, so a leaf is a grid of blocks
(``block_counts``); ``block_index`` is a rank's place in that grid,
``block_owner`` the one rank that writes a block (the lowest coordinate
along every mesh axis the leaf is not split on: one copy of a replicated
block), and ``recut`` lists, for a block of another layout (another mesh,
placement or world), the saved blocks it overlaps and the slice of each.
"""

from __future__ import annotations

import itertools
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


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, in its order."""
    return dict(zip(_names(mesh), (int(s) for s in mesh.mesh.shape)))


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
    shape = mesh_sizes(mesh)
    n, idx = 1, 0
    for ax in split_axes(part):
        n, idx = n * shape[ax], idx * shape[ax] + coords[ax]
    return n, idx


def block_counts(sizes: Dict[str, int], placement: Sequence[MeshAxes]) -> Tuple[int, ...]:
    """How many blocks each dimension is cut into under ``placement`` on a
    mesh of axis ``sizes`` ({} or an axis the placement does not name: 1)."""
    return tuple(int(np.prod([sizes.get(a, 1) for a in split_axes(part)], dtype=np.int64))
                 for part in placement)


def block_index(mesh, placement: Sequence[MeshAxes], rank: int) -> Tuple[int, ...]:
    """``rank``'s block of a leaf under ``placement``: its index along each
    dimension of the leaf's block grid."""
    coords = axis_coords(mesh, rank)
    return tuple(_blocks(mesh, part, coords)[1] for part in placement)


def block_owner(mesh, placement: Sequence[MeshAxes], index: Sequence[int]) -> int:
    """The rank that writes block ``index`` of a leaf: the one holding it
    at the lowest coordinate along every mesh axis the leaf is not split
    on (a replicated leaf's one block: the rank at the mesh's origin)."""
    sizes = mesh_sizes(mesh)
    coords = dict.fromkeys(sizes, 0)
    for part, idx in zip(placement, index):
        for ax in reversed(split_axes(part)):  # minor axis first
            idx, coords[ax] = divmod(int(idx), sizes[ax])
    return int(mesh.mesh.numpy()[tuple(coords[a] for a in sizes)])


def block_slices(shape: Sequence[int], counts: Sequence[int],
                 index: Sequence[int]) -> Tuple[slice, ...]:
    """Where block ``index`` of a grid of ``counts`` blocks lies in a leaf of
    global ``shape``; each dimension must divide evenly."""
    out = []
    for dim, (size, n, i) in enumerate(zip(shape, counts, index)):
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split {n} ways")
        step = size // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def recut(shape: Sequence[int], saved_sizes: Dict[str, int],
          saved_placement: Sequence[MeshAxes], mesh=None,
          placement: Optional[Sequence[MeshAxes]] = None, rank: int = 0) -> list:
    """The saved blocks a new block reads: for a leaf of global ``shape``
    saved under ``saved_placement`` on a mesh of axis sizes
    ``saved_sizes``, and ``rank``'s block under ``placement`` on ``mesh``
    (the whole leaf without a mesh), a list of (saved block index, the
    slice of that block to read, where it lands in the new block)."""
    saved = block_counts(saved_sizes, saved_placement)
    if mesh is None:
        want = tuple(slice(0, s) for s in shape)
    else:
        want = block_slices(shape, block_counts(mesh_sizes(mesh), placement),
                            block_index(mesh, placement, rank))
    per_dim = []
    for size, n, w in zip(shape, saved, want):
        step = size // n
        hits = []
        for i in range(w.start // step, -(-w.stop // step)):
            lo, hi = max(w.start, i * step), min(w.stop, (i + 1) * step)
            hits.append((i, slice(lo - i * step, hi - i * step), slice(lo - w.start,
                                                                      hi - w.start)))
        per_dim.append(hits)
    return [tuple(tuple(c[k] for c in combo) for k in range(3))
            for combo in itertools.product(*per_dim)]


def shard_tensor(x, mesh, placement: Sequence[MeshAxes], rank: int):
    """``rank``'s block of the whole array ``x`` (numpy or torch) under
    ``placement``; each split dimension must divide evenly."""
    counts = block_counts(mesh_sizes(mesh), placement)
    return x[block_slices(x.shape, counts, block_index(mesh, placement, rank))]


def gather_shards(blocks: Dict[int, Any], mesh, placement: Sequence[MeshAxes]):
    """The whole numpy array from every rank's block (``{rank: block}``),
    the inverse of ``shard_tensor``; ranks holding the same block must
    hold equal copies."""
    first = np.asarray(next(iter(blocks.values())))
    counts = block_counts(mesh_sizes(mesh), placement)
    shape = tuple(s * n for s, n in zip(first.shape, counts))
    out = np.empty(shape, dtype=first.dtype)
    for rank, block in blocks.items():
        out[block_slices(shape, counts, block_index(mesh, placement, rank))] = np.asarray(block)
    return out


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class MeshPlan:
    """How one rank holds a params tree on a mesh: each leaf's placement
    (from logical axes and rules; a leaf without logical axes is
    replicated), this rank's coordinates, and the data split of a batch
    (its block of the leading dim over the batch axes, dp then fsdp, and
    of the sequence dim over cp). The loss axes are the batch axes and cp:
    a loss's numerator and denominator are summed over them, and so are
    the gradients of the leaves not split on them. On a mesh with pp and
    ep both above 1 (the pipeline with ep inside a stage) ep is a batch
    axis too, the minor one: every ep rank then routes rows of its own.
    pp is never a loss axis: every pp rank holds the same copy of the
    loss."""

    def __init__(self, mesh, logical_axes: Any = None,
                 rules: ShardingRules = DEFAULT_RULES, rank: Optional[int] = None) -> None:
        self.mesh = mesh
        self.rules = rules
        self.rank = _rank() if rank is None else int(rank)
        self.coords = axis_coords(mesh, self.rank)
        self.sizes = dict(zip(_names(mesh), (int(s) for s in mesh.mesh.shape)))
        self.placements = None if logical_axes is None else placements(mesh, logical_axes, rules)
        # the data axes a batch is split over, and the ones of size > 1
        # whose gradients are summed
        self.batch_part = batch_sharding(mesh, rules)[0]
        if self.size(AXIS_PIPELINE) > 1 and self.size(AXIS_EXPERT) > 1:
            # ep inside a pipeline stage: each ep rank routes its own rows
            self.batch_part = split_axes(self.batch_part) + (AXIS_EXPERT,)
        self.data_axes = tuple(a for a in split_axes(self.batch_part) if self.size(a) > 1)
        self.data_size, self.data_index = _blocks(mesh, self.batch_part, self.coords)
        self.seq_part = rules.placement(mesh, ["seq"])[0]
        self.seq_size, self.seq_index = _blocks(mesh, self.seq_part, self.coords)
        self.loss_axes = self.data_axes + tuple(a for a in split_axes(self.seq_part)
                                                if self.sizes[a] > 1)
        self.loss_size = self.data_size * self.seq_size

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

    def seq_cols(self, x):
        """This rank's block of a [rows, seq, ...] array's sequence dim."""
        t = x.shape[1]
        if t % self.seq_size:
            raise ValueError(f"sequence {t} does not split over {self.seq_size} cp ranks "
                             f"({self.seq_part})")
        cols = t // self.seq_size
        return x[:, self.seq_index * cols:(self.seq_index + 1) * cols]

    def local_batch(self, x):
        """This rank's block of a global [batch, seq, ...] array: its data
        rows, and of them its block of the sequence."""
        return self.seq_cols(self.data_rows(x))

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
