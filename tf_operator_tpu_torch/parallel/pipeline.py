"""Pipeline parallelism: microbatch schedules over the ``pp`` axis.

Port of ``tf_operator_tpu/parallel/pipeline.py``. Each rank of the ``pp``
axis holds one stage (or, interleaved, ``n_chunks`` virtual stages) of
the model; activations move stage to stage by a ring shift over ``pp``.
The schedules, their tick arithmetic and their checks are the JAX
package's:

- ``"gpipe"``: the fill-drain loop. With S stages and M microbatches,
  T = M + S - 1 ticks a phase; bubble (S-1)/(M+S-1). The backward keeps
  what autodiff keeps: each valid tick's graph from the forward.
- ``"1f1b"``: the forward saves only each (chunk, microbatch) stage input;
  the backward is the reverse pipeline, which recomputes each tick's
  forward from its saved input and differentiates it (the 1F1B recompute
  recipe), with the same 2(M·v + S - 1)-tick timeline.
- ``"1f1b"`` with ``n_chunks = v > 1``: the interleaved schedule. Rank d
  holds virtual stages d, d + S, ..., a microbatch laps the ring v times,
  and the bubble shrinks to (S-1)/(M·v + S-1) (``_fwd_coords``).

Each schedule is one ``torch.autograd.Function`` whose ``backward`` is an
explicit reverse tick loop: cotangents enter at the last virtual stage
and shift backwards one neighbour a tick (``_bwd_coords``, the forward's
mirror), each valid tick differentiates its stage body (``torch.autograd
.grad`` on the kept graph under GPipe, on a recompute under 1F1B), the
parameter gradients sum in f32, and the input cotangent of microbatch m
is stage 0's at its chunk 0. On every rank every tick makes one shift
outside autograd, in the same order: autograd never discovers a
collective, so no rank's graph can lack a shift its neighbour waits on.
Invalid fill and drain ticks skip their compute (JAX computes and masks
them), never their shift. The output ``y`` is broadcast from the last
stage and the input cotangent from stage 0, so every pp rank returns the
same values; pp is therefore no loss axis (each pp rank holds the same
copy of the loss). Under tp a stage body uses Megatron's pair
(``tp_region_enter``/``exit``) under both schedules: the port's stage
backward is always autograd on the stage body, where JAX needs a second
convention for shard_map's own autodiff under GPipe.

Under a mesh ``x`` is this rank's rows (its block over ``batch_axes``)
and ``stage_params`` its chunks, leaves with a leading [n_chunks] dim in
chunk order. The microbatch split is the JAX package's strided one,
microbatch i taking rows i, i + M, ... of the global batch, which on a
data shard is rows i, i + M, ... of its own block; the exit inverts it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from tf_operator_tpu_torch.parallel import collectives as coll


def bubble_fraction(n_stages: int, n_micro: int, n_chunks: int = 1) -> float:
    """Idle fraction of the fill-drain timeline: (S-1)/(M·v + S-1)."""
    return (n_stages - 1) / (n_micro * n_chunks + n_stages - 1)


def n_ticks(n_stages: int, n_micro: int, n_chunks: int = 1) -> int:
    """Ticks of one phase (the forward, or the backward): M·v + S - 1."""
    return n_micro * n_chunks + n_stages - 1


def _clip(i: int, hi: int) -> int:
    return min(max(i, 0), hi)


def _fwd_coords(t: int, stage: int, n_stages: int, n_micro: int, n_chunks: int):
    """(valid, chunk i, microbatch m) the rank at ``stage`` runs at forward
    tick t: round r's m-th member runs virtual stage j = stage + i·S at
    tick r·S·v + m + j, so with u = t - stage, u = (r·v + i)·S + m."""
    u = t - stage
    q, m = divmod(u, n_stages)
    r, i = divmod(q, n_chunks)
    valid = 0 <= u < n_micro * n_chunks
    return valid, _clip(i, n_chunks - 1), _clip(r * n_stages + m, n_micro - 1)


def _bwd_coords(t: int, stage: int, n_stages: int, n_micro: int, n_chunks: int):
    """The backward's (valid, chunk, microbatch): the forward's mirror
    (stage -> S-1-stage, chunk -> v-1-chunk, round -> R-1-round, member ->
    S-1-member); for v = 1 the plain mirror over microbatches, any M."""
    ub = t - (n_stages - 1 - stage)
    valid = 0 <= ub < n_micro * n_chunks
    if n_chunks == 1:
        return valid, 0, _clip(n_micro - 1 - ub, n_micro - 1)
    qb, mb = divmod(ub, n_stages)
    rb, ib = divmod(qb, n_chunks)
    n_rounds = n_micro // n_stages
    m = (n_rounds - 1 - rb) * n_stages + (n_stages - 1 - mb)
    return valid, _clip(n_chunks - 1 - ib, n_chunks - 1), _clip(m, n_micro - 1)


def _saved_slot(i: int, m: int, n_micro: int) -> int:
    """Where the 1F1B forward saves chunk i's input of microbatch m (the
    JAX package's x_saved[i·M + m])."""
    return i * n_micro + m


def _bwd_slot(t: int, stage: int, n_stages: int, n_micro: int, n_chunks: int) -> int:
    """The saved input backward tick t recomputes from: that of its own
    (chunk, microbatch), the mirrored coordinates (``_bwd_coords``)."""
    _, i, m = _bwd_coords(t, stage, n_stages, n_micro, n_chunks)
    return _saved_slot(i, m, n_micro)


def _data_axes(mesh, batch_axes) -> tuple:
    return tuple(a for a in batch_axes if coll.axis_size(mesh, a) > 1)


def _split_micro(x: torch.Tensor, mesh, n_microbatches: int, batch_axes) -> torch.Tensor:
    """The JAX package's checks on the global batch, then this rank's rows
    as [M, mb_local, ...], microbatch i its rows i, i + M, ... (strided)."""
    n_data = 1
    for a in _data_axes(mesh, batch_axes):
        n_data *= coll.axis_size(mesh, a)
    batch = x.shape[0] * n_data
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by {n_microbatches} microbatches")
    mb = batch // n_microbatches
    if mb % n_data:
        raise ValueError(
            f"microbatch size {mb} (batch {batch} / {n_microbatches} "
            f"microbatches) not divisible by data shards {n_data}"
        )
    return x.reshape((mb // n_data, n_microbatches) + tuple(x.shape[1:])).transpose(0, 1)


class _Run:
    """What the schedule's Function carries besides tensors."""

    def __init__(self, fn, spec, mesh, axis, schedule, n_chunks, aux_size):
        self.fn, self.spec, self.mesh, self.axis = fn, spec, mesh, axis
        self.schedule, self.v, self.aux_size = schedule, n_chunks, aux_size
        self.n_stages = coll.axis_size(mesh, axis)
        self.stage = coll.axis_index(mesh, axis)

    def chunk(self, leaves, i: int):
        """Chunk i's params as the stage body takes them."""
        return pytree.tree_unflatten([a[i] for a in leaves], self.spec)

    def body(self, leaves, i: int, x):
        """(out, aux or None) of chunk i on x."""
        res = self.fn(self.chunk(leaves, i), x)
        return res if self.aux_size else (res, None)


class _Schedule(torch.autograd.Function):
    """One pipeline pass: forward ticks in ``forward``, the reverse pipeline
    in ``backward``; returns (y [M, mb, ...], aux [k] f32, this rank's sum
    over its valid ticks)."""

    @staticmethod
    def forward(ctx, run: _Run, x_micro, *leaves):
        S, stage, v = run.n_stages, run.stage, run.v
        M = x_micro.shape[0]
        gpipe = run.schedule == "gpipe"
        # GPipe keeps each valid tick's graph: the params enter it as leaves
        params = [a.detach().requires_grad_(a.requires_grad) for a in leaves] if gpipe else \
            list(leaves)
        y = torch.zeros_like(x_micro)
        aux = torch.zeros(max(run.aux_size, 1), dtype=torch.float32, device=x_micro.device)
        kept = {}
        prev = None
        for t in range(n_ticks(S, M, v)):
            # every rank shifts at every tick but the first (nothing to send)
            recv = None if t == 0 else coll.ring_shift_no_grad(prev, run.mesh, run.axis, 1)
            valid, i, m = _fwd_coords(t, stage, S, M, v)
            if not valid:
                prev = torch.zeros_like(x_micro[0])
                continue
            x_in = x_micro[m] if stage == 0 and i == 0 else recv
            if gpipe:
                x_in = x_in.detach().requires_grad_(True)
                with torch.enable_grad():
                    out, a = run.body(params, i, x_in)
                kept[(i, m)] = (x_in, out, a)
            else:
                kept[_saved_slot(i, m, M)] = x_in
                out, a = run.body(params, i, x_in)
            if a is not None:
                aux += a.detach().float()
            if stage == S - 1 and i == v - 1:
                y[m] = out.detach()
            prev = out.detach()
        ctx.run, ctx.kept, ctx.params, ctx.shape = run, kept, params, x_micro.shape
        return coll.broadcast_no_grad(y, run.mesh, run.axis, S - 1), aux

    @staticmethod
    def backward(ctx, gy, g_aux):
        run, kept, params = ctx.run, ctx.kept, ctx.params
        S, stage, v = run.n_stages, run.stage, run.v
        M = ctx.shape[0]
        gpipe = run.schedule == "gpipe"
        if not gpipe:
            params = [a.detach().requires_grad_(a.requires_grad) for a in params]
        grads = [torch.zeros(a.shape, dtype=torch.float32, device=a.device) for a in params]
        wanted = [j for j, a in enumerate(params) if a.requires_grad]
        dx = torch.zeros(ctx.shape, dtype=gy.dtype, device=gy.device)
        prev = None
        for t in range(n_ticks(S, M, v)):
            recv = None if t == 0 else coll.ring_shift_no_grad(prev, run.mesh, run.axis, -1)
            valid, i, m = _bwd_coords(t, stage, S, M, v)
            if not valid:
                prev = torch.zeros_like(dx[0])
                continue
            g_in = gy[m] if stage == S - 1 and i == v - 1 else recv
            if gpipe:
                x_in, out, a = kept.pop((i, m))
            else:
                x_in = kept[_bwd_slot(t, stage, S, M, v)].detach().requires_grad_(True)
                with torch.enable_grad():  # the 1F1B recompute
                    out, a = run.body(params, i, x_in)
            outs, cots = [out], [g_in]
            if a is not None:
                outs.append(a)
                cots.append(g_aux.to(a.dtype))
            got = torch.autograd.grad(outs, [x_in] + [params[j] for j in wanted], cots,
                                      allow_unused=True)
            for j, g in zip(wanted, got[1:]):
                if g is not None:
                    grads[j] += g.float()
            gx = torch.zeros_like(x_in) if got[0] is None else got[0]
            if stage == 0 and i == 0:
                dx[m] = gx
            prev = gx
        ctx.kept = None
        dx = coll.broadcast_no_grad(dx, run.mesh, run.axis, 0)
        return (None, dx, *[g.to(a.dtype) for g, a in zip(grads, params)])


def pipeline_apply(stage_params, x: torch.Tensor, fn: Callable, mesh, n_microbatches: int,
                   axis_name: str = "pp", batch_axes: tuple = ("dp", "fsdp"),
                   schedule: str = "gpipe", aux_size: int = 0, n_chunks: int = 1):
    """Run ``fn(chunk_params, x_mb)`` as a pipeline over ``axis_name``.

    stage_params: this rank's virtual stages, a pytree of tensors with a
    leading [n_chunks] dim (chunk i is virtual stage rank + i·S). x: this
    rank's rows [b, ...]. fn maps a microbatch through one virtual stage,
    preserving its shape, and takes every tensor it differentiates through
    ``chunk_params``; with ``aux_size`` > 0 it returns (x_mb_out, aux
    [aux_size] f32), summable side losses (the MoE router's lb and z), and
    pipeline_apply returns (y, aux_total), every (stage, microbatch)
    contribution summed over pp and averaged over the data axes
    (``batch_axes`` of size > 1), as the JAX package reduces its rows;
    the caller normalises by layers x microbatches. Returns y [b, ...],
    the same on every pp rank.

    ``schedule``: "gpipe" or "1f1b"; ``n_chunks`` > 1 (interleaved)
    requires "1f1b" and n_microbatches % pp == 0."""
    n_stages = coll.axis_size(mesh, axis_name)
    if n_chunks > 1:
        if schedule != "1f1b":
            raise ValueError("n_chunks > 1 (interleaved) requires schedule='1f1b'")
        if n_microbatches % n_stages:
            raise ValueError(
                f"interleaved schedule needs n_microbatches "
                f"({n_microbatches}) divisible by {axis_name}="
                f"{n_stages} (round structure)"
            )
    x_micro = _split_micro(x, mesh, n_microbatches, batch_axes)
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    leaves, spec = pytree.tree_flatten(stage_params)
    run = _Run(fn, spec, mesh, axis_name, schedule, n_chunks, aux_size)
    y, aux = _Schedule.apply(run, x_micro.contiguous(), *leaves)
    # invert the strided split: out[j·M + i] = y[i, j]
    out = y.transpose(0, 1).reshape(x.shape)
    if not aux_size:
        return out
    data_axes = _data_axes(mesh, batch_axes)
    n_data = 1
    for a in data_axes:
        n_data *= coll.axis_size(mesh, a)
    # summed over pp (each stage holds other layers) and averaged over the
    # data shards (each routes its own rows); pp ranks hold one copy of
    # the loss, so the backward sums the cotangent over the data axes only
    return out, coll.all_reduce_sum(aux, mesh, (axis_name,) + data_axes,
                                    replicated=(axis_name,)) / n_data


class _Interleave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, leaf, mesh, axis, n_chunks):
        ctx.args = (mesh, axis, n_chunks)
        return _exchange_chunks(leaf, mesh, axis, n_chunks, back=False)

    @staticmethod
    def backward(ctx, g):
        return _exchange_chunks(g, *ctx.args, back=True), None, None, None


def _chunk_moves(n_stages: int, n_chunks: int, me: int):
    """(send, recv): the global chunk indices this rank sends to each rank
    and receives from each, in chunk order. Rank d's contiguous block holds
    chunks d·v .. d·v + v - 1; it runs chunks d, d + S, ...."""
    v = n_chunks
    send = [[j for j in range(me * v, me * v + v) if j % n_stages == r]
            for r in range(n_stages)]
    recv = [[j for j in range(me, n_stages * v, n_stages) if j // v == r]
            for r in range(n_stages)]
    return send, recv


def _exchange_chunks(x, mesh, axis, n_chunks, back: bool):
    """The all-to-all over ``axis`` between a rank's contiguous block of a
    stacked leaf [v·per, ...] and its interleaved chunks (chunk i = virtual
    stage rank + i·S); ``back`` the transpose. Either way the result holds
    its chunks in ascending global order."""
    n_stages, me = coll.axis_size(mesh, axis), coll.axis_index(mesh, axis)
    send, recv = _chunk_moves(n_stages, n_chunks, me)
    local = range(me, n_stages * n_chunks, n_stages) if back else \
        range(me * n_chunks, me * n_chunks + n_chunks)
    if back:
        send, recv = recv, send
    per = x.shape[0] // n_chunks
    blocks = dict(zip(local, x.split(per)))
    inp = torch.cat([blocks[j] for r in range(n_stages) for j in send[r]]).contiguous()
    out = torch.empty_like(inp)
    coll.all_to_all_uneven(out, inp, [len(s) * per for s in recv], [len(s) * per for s in send],
                           mesh, axis)
    got = dict(zip([j for r in range(n_stages) for j in recv[r]], out.split(per)))
    return torch.cat([got[j] for j in sorted(got)])


def interleave_chunks(leaf: torch.Tensor, mesh, axis: str, n_chunks: int) -> torch.Tensor:
    """A stacked leaf's contiguous pp block [v·per, ...] (the checkpoint's
    layout) -> the chunks this rank runs, chunk i = virtual stage rank +
    i·S, concatenated [v·per, ...]; the backward sends each chunk's
    gradient back to its block. The identity for v = 1."""
    if n_chunks == 1 or coll.axis_size(mesh, axis) == 1:
        return leaf
    return _Interleave.apply(leaf, mesh, axis, n_chunks)
