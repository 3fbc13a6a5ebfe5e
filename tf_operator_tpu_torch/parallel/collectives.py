"""Named collectives over a mesh axis, differentiable.

Port of ``tf_operator_tpu/parallel/collectives.py``. Each collective runs
over the process group of one axis of a ``DeviceMesh``
(``mesh.get_group(axis)``) and is a ``torch.autograd.Function`` whose
backward is the transpose JAX uses inside ``shard_map``: a sum's
cotangent is summed again (a psum transposes to a psum), an all-gather's
is reduce-scattered and a reduce-scatter's all-gathered, a ring shift's
shifted back, an all-to-all's sent back by the reverse all-to-all.
Megatron's pair ``tp_region_enter`` (identity forward, sum backward) and
``tp_region_exit`` (sum forward, identity backward) pin the transposes
of a tensor-parallel region; ``ep_region_enter`` (this rank's block of
the tokens, all-gather backward) and ``ep_region_exit`` (all-gather
forward, this rank's block backward) those of an expert-parallel one.
ep and tp are not loss axes: every rank of them holds the same copy of
the loss, so no collective over them sums a cotangent back the way a
data-axis collective does (``all_reduce_mean``'s ``replicated`` axes).
An axis of size 1 (or one the mesh lacks) makes every collective the
identity.

gloo on CUDA tensors: gloo carries some collectives for CUDA tensors
itself (``GLOO_CUDA_NATIVE``); for the others the call copies the input
to a pinned host buffer, runs the collective there and copies the result
back, only when the group's backend is gloo and the tensor is on the
card. ``staged_bytes`` counts the bytes those copies move (both ways),
``collective_s`` the host seconds spent inside collective calls and
``collective_calls`` their number; an NCCL or a CPU call never stages.
"""

from __future__ import annotations

import time
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

# The collectives here that gloo runs on CUDA tensors itself on the GPU
# host's torch (2.11, tools/gloo_cuda_probe.py, each checked on two ranks
# of one card; all_to_all_single and broadcast pass there too). Its
# send/recv writes from the device pointer and kills the process ("writev:
# Bad address"), so the ring shift stages through the host
# (chip_smoke.ring_shift_on_card runs it on two ranks of the card).
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                              "all_to_all_single"})

staged_bytes = 0  # bytes copied card <-> pinned host for gloo
collective_s = 0.0  # host seconds inside collective calls
collective_calls = 0
all_to_all_bytes = 0  # bytes this rank sent through all_to_all (its own chunk included)


def reset_counters() -> None:
    global staged_bytes, collective_s, collective_calls, all_to_all_bytes
    staged_bytes, collective_s, collective_calls, all_to_all_bytes = 0, 0.0, 0, 0


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` in ``mesh`` (1 when the mesh lacks it)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 when the mesh lacks it)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


def _active(mesh, axes) -> Tuple[str, ...]:
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if axis_size(mesh, a) > 1)


def _call(op: str, fn, out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """fn(out, inp, group): staged through pinned host buffers for gloo on
    CUDA tensors where gloo lacks ``op``."""
    global staged_bytes, collective_s, collective_calls
    t0 = time.perf_counter()
    if (inp.is_cuda and op not in GLOO_CUDA_NATIVE
            and dist.get_backend(group) == dist.Backend.GLOO):
        h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
        h_in.copy_(inp)
        h_out = h_in if out is inp else torch.empty(out.shape, dtype=out.dtype,
                                                   pin_memory=True)
        fn(h_out, h_in, group)
        out.copy_(h_out)
        staged_bytes += inp.numel() * inp.element_size() + out.numel() * out.element_size()
    else:
        fn(out, inp, group)
    collective_s += time.perf_counter() - t0
    collective_calls += 1


def _sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """x summed over every rank of ``axes`` (a new tensor)."""
    y = x.contiguous().clone()
    for a in _active(mesh, axes):
        _call("all_reduce", lambda o, i, g: dist.all_reduce(i, group=g), y, y,
              mesh.get_group(a))
    return y


def _gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    _call("all_gather_into_tensor",
          lambda o, i, g: dist.all_gather_into_tensor(o, i, group=g), out, xt,
          mesh.get_group(axis))
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {xt.shape[0]} does not split "
                         f"{n} ways over {axis!r}")
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _call("reduce_scatter_tensor",
          lambda o, i, g: dist.reduce_scatter_tensor(o, i, group=g), out, xt,
          mesh.get_group(axis))
    return out.movedim(0, dim)


def _block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (no communication)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axis) * size, size).contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, scale, replicated=()):
        ctx.mesh, ctx.scale = mesh, scale
        ctx.axes = tuple(a for a in _active(mesh, axes) if a not in replicated)
        y = _sum(x, mesh, axes)
        return y * scale if scale != 1 else y

    @staticmethod
    def backward(ctx, g):
        y = _sum(g, ctx.mesh, ctx.axes)
        return (y * ctx.scale if ctx.scale != 1 else y), None, None, None, None


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """psum over ``axes`` (a name or a tuple of names)."""
    if not _active(mesh, axes):
        return x
    return _AllReduce.apply(x, mesh, axes, 1)


def all_reduce_mean(x: torch.Tensor, mesh, axes, replicated: Sequence[str] = ()) -> torch.Tensor:
    """pmean over ``axes`` (a name or a tuple of names). The backward sums
    the cotangent over the axes but those in ``replicated``: axes whose
    ranks all hold the same copy of the loss (ep), where the cotangent is
    already the whole one and each rank's input takes its 1/n share."""
    active = _active(mesh, axes)
    if not active:
        return x
    n = 1
    for a in active:
        n *= axis_size(mesh, a)
    return _AllReduce.apply(x, mesh, axes, 1.0 / n, tuple(replicated))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, replicated_grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.rep = mesh, axis, dim, replicated_grad
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.rep:
            return _block(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None, None
        return _scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0,
               replicated_grad: bool = False) -> torch.Tensor:
    """Tiled all-gather along ``dim`` (the FSDP param gather); the backward
    reduce-scatters the cotangent. With ``replicated_grad`` the cotangent
    is the same on every rank of the axis (the gathered value is used by a
    replicated computation, as the tied embedding under tp) and the
    backward keeps this rank's block of it."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim, replicated_grad)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def reduce_scatter_sum(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Sum over ``axis``, then this rank's block along ``dim`` (the FSDP
    gradient reduce); the backward all-gathers."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis, dim)


def _shift(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    i = axis_index(mesh, axis)
    ranks = mesh.mesh.numpy()
    # the global ranks along this rank's row of the axis
    names = mesh.mesh_dim_names
    coord = [int(c) for c in mesh.get_coordinate()]
    def peer(j):
        c = list(coord)
        c[names.index(axis)] = j % n
        return int(ranks[tuple(c)])

    src, dst = peer(i - shift), peer(i + shift)
    xc = x.contiguous()
    y = torch.empty_like(xc)

    def run(o, inp, g):
        ops = [dist.P2POp(dist.isend, inp, dst, g), dist.P2POp(dist.irecv, o, src, g)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    _call("send_recv", run, y, xc, mesh.get_group(axis))
    return y


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def ring_shift(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the ring: index i receives index i - shift's."""
    if axis_size(mesh, axis) == 1 or shift % axis_size(mesh, axis) == 0:
        return x
    return _RingShift.apply(x, mesh, axis, shift)


class _TpEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


class _TpExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def tp_region_enter(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Megatron f: identity forward; the backward sums the shard-partial
    input cotangent over the tp axis."""
    if axis_size(mesh, axis) == 1:
        return x
    return _TpEnter.apply(x, mesh, axis)


def tp_region_exit(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Megatron g: sum forward (combine row-parallel partials); the
    backward passes the replicated output cotangent through."""
    if axis_size(mesh, axis) == 1:
        return x
    return _TpExit.apply(x, mesh, axis)


def all_reduce_now(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x summed over ``axis``'s process group even at size 1 (a group of
    one still runs the collective: the smoke's proof that the backend
    works), outside autograd."""
    y = x.contiguous().clone()
    _call("all_reduce", lambda o, i, g: dist.all_reduce(i, group=g), y, y,
          mesh.get_group(axis))
    return y


def sum_no_grad(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """x summed over ``axes`` outside autograd (gradient and norm reduces)."""
    if not _active(mesh, axes):
        return x
    with torch.no_grad():
        return _sum(x, mesh, axes)


def _all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int):
    """Tiled all-to-all over ``axis`` (``jax.lax.all_to_all(..., tiled=True)``):
    ``split_dim`` cut into n blocks, block j sent to index j, the n blocks
    received concatenated along ``concat_dim`` in index order."""
    global all_to_all_bytes
    n = axis_size(mesh, axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size {x.shape[split_dim]} does not "
                         f"split {n} ways over {axis!r}")
    shape = list(x.shape)
    # [.., n, size/n, ..] at split_dim, the n blocks leading
    xs = x.reshape(shape[:split_dim] + [n, shape[split_dim] // n] + shape[split_dim + 1:])
    xs = xs.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xs)
    _call("all_to_all_single", lambda o, i, g: dist.all_to_all_single(o, i, group=g), out, xs,
          mesh.get_group(axis))
    all_to_all_bytes += xs.numel() * xs.element_size()
    # the received blocks (source index leading) concatenated along concat_dim
    rest = shape[:split_dim] + [shape[split_dim] // n] + shape[split_dim + 1:]
    out = out.movedim(0, concat_dim)
    return out.reshape(rest[:concat_dim] + [n * rest[concat_dim]] + rest[concat_dim + 1:])


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.split, ctx.concat = mesh, axis, split_dim, concat_dim
        return _all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.mesh, ctx.axis, ctx.concat, ctx.split),
                None, None, None, None)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    """Tiled all-to-all over ``axis``; its backward is the reverse
    all-to-all (split ``concat_dim``, concatenate ``split_dim``), as
    ``jax.lax.all_to_all``'s transpose. With split and concat dim 0 on a
    [S, ...] array it is JAX's untiled exchange: row block j goes to
    index j, and row block j of the result came from index j."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def exchange_counts(counts: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The count matrix exchange outside autograd: ``counts`` [S, ...] (row
    j for index j) -> [S, ...] (row j from index j)."""
    if axis_size(mesh, axis) == 1:
        return counts
    with torch.no_grad():
        return _all_to_all(counts.contiguous(), mesh, axis, 0, 0)


def gather_no_grad(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` over ``axes`` (their ranks in the
    order of a batch split over them, the first axis major), outside
    autograd."""
    out = x.unsqueeze(0)
    with torch.no_grad():
        for a in reversed(_active(mesh, axes)):
            out = _gather(out.contiguous(), mesh, a, 0).reshape(-1, *x.shape)
    return out


class _EpEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _block(x, mesh, axis, 0)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.mesh, ctx.axis, 0), None, None


class _EpExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _gather(x, mesh, axis, 0)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axis, 0), None, None


def ep_region_enter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's block of ``x``'s rows (the tokens every ep rank holds
    alike); the backward all-gathers the blocks' cotangents, so each rank
    gets the whole one (never a sum: ep holds one copy of the loss)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _EpEnter.apply(x, mesh, axis)


def ep_region_exit(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The blocks of rows all-gathered; the backward keeps this rank's
    block of the (replicated) cotangent."""
    if axis_size(mesh, axis) == 1:
        return x
    return _EpExit.apply(x, mesh, axis)
