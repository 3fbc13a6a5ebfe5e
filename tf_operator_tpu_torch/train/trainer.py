"""Trainer: init and step on one card, or on one rank of a mesh.

Port of ``tf_operator_tpu/train/trainer.py`` without the compile-overlap
machinery, which PyTorch's eager mode does not need, and without
``multi_step`` (the step loop runs K steps as a Python loop). Usage shape:

    trainer = Trainer(loss_fn=..., init_fn=..., config=TrainerConfig(...),
                      mesh=None, logical_axes=None)
    state = trainer.init(seed)
    state, metrics = trainer.step(state, batch)

Under a mesh (a DeviceMesh; ``logical_axes`` and ``rules`` place each
leaf, a leaf without logical axes is replicated) each rank inits the
whole params from the one seed and keeps its blocks, so the values equal
the single-device init; optimizer moments live on the blocks; ``batch``
is this rank's block (its rows, and under cp its block of the sequence).
The loss returns the global value, and each collective in it sums its
cotangent back over the loss axes (the data axes and cp: JAX's
transposes), so a rank's gradient is the loss-rank count times its
share: the fsdp gather's backward reduce-scatters it, the step sums it
over the loss axes a leaf is not split on (one flat all-reduce per
bucket) and divides by the count. ep and tp ranks hold one copy of the
loss, and a leaf not split on them has the same gradient on each. The
global-norm clip sums the squares of each leaf's block over exactly the
axes the leaf is split on (an expert leaf's over ep, and fsdp on embed).

``loss_fn(params, batch, extra) -> loss`` or ``(loss, new_extra)``;
``init_fn(generator) -> params`` or ``(params, extra)``, where the
generator is a ``torch.Generator`` on the trainer's device.

The optimizer is written out rather than taken from ``torch.optim``, so
that it is optax's ``chain(clip_by_global_norm(grad_clip), adamw(...))``
or ``sgd(..., momentum)`` update for update: optax's clip scales by
``max_norm / norm`` only when ``norm >= max_norm``
(``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
1e-6)`` whenever the ratio is below 1), and the schedule sees optax's
count (0 at the first update) while AdamW's bias correction uses count +
1. optax's SGD with momentum is ``trace = g + momentum * trace`` from
zeros, then ``p -= lr * trace``: no dampening, no Nesterov, no weight
decay. Params, moments and grads are f32 and are updated in place, where
the JAX trainer donates them to its jitted step. The model state
(``extra``, e.g. BN running stats) is whatever the loss returns; losses
return it detached, so no step's graph outlives its backward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.compat import tree_map
from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.parallel import collectives as coll
from tf_operator_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    MeshPlan,
    ShardingRules,
    block_counts,
    block_owner,
    recut,
    shard_tensor,
    split_axes,
)

# Elements of one flat gradient all-reduce (f32: 256 MB).
GRAD_BUCKET_ELEMS = 1 << 26


@dataclass
class TrainerConfig:
    """The JAX TrainerConfig's fields and defaults. ``fast_init_rng`` is
    accepted and ignored: it picks a JAX PRNG implementation."""

    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 0
    lr_schedule: str = "constant"  # "constant" | "cosine"
    total_steps: int = 10000
    # >1 splits each step's batch into grad_accum equal microbatches and
    # applies one update with the mean of the microbatch-mean gradients
    grad_accum: int = 1
    fast_init_rng: bool = False


class OptState(dict):
    """The optimizer state, ``{"count", "mu", "nu"}`` (AdamW) or
    ``{"count", "trace"}`` (SGD), and ``chain``: the layout of optax's
    state for the same config, which checkpoints are written in
    (``train/checkpoint.py``). ``chain`` nests tuples of "empty" (a
    stateless transform), "adam" (count, mu, nu), "trace" (trace) and
    "sched" (a schedule's count)."""

    def __init__(self, *args, chain: tuple = (), **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.chain = chain


def optax_chain(cfg: "TrainerConfig") -> tuple:
    """The layout of the JAX _make_tx's state: ``adamw`` is optax's
    chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate),
    ``sgd`` chain(trace, scale_by_learning_rate); the learning rate's
    transform holds a count only under a schedule; a grad clip chains a
    stateless clip_by_global_norm in front."""
    sched = "sched" if cfg.lr_schedule == "cosine" or cfg.warmup_steps else "empty"
    inner = ("adam", "empty", sched) if cfg.optimizer == "adamw" else ("trace", sched)
    return ("empty", inner) if cfg.grad_clip else inner


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int
    extra: Any = None


def _leaves(tree) -> list:
    """The leaves of nested dicts (in sorted key order), lists and tuples
    (in their order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _leaves_of_placements(tree) -> list:
    """The placements of a placements tree in _leaves order (a placement
    is a tuple, so only dicts and lists are walked)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of_placements(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves_of_placements(v)]
    return [tree]


def _f32(x) -> float:
    return float(np.float32(x))


def check_schedule(cfg: TrainerConfig) -> None:
    """Raise ValueError on a schedule the JAX _make_tx refuses: a cosine
    config with total_steps <= max(warmup_steps, 1), where
    optax.warmup_cosine_decay_schedule leaves no step for the decay."""
    if cfg.lr_schedule == "cosine" and cfg.total_steps <= max(cfg.warmup_steps, 1):
        raise ValueError(
            f"cosine schedule needs total_steps > max(warmup_steps, 1), got "
            f"total_steps={cfg.total_steps}, warmup_steps={cfg.warmup_steps}")


def learning_rate_at(cfg: TrainerConfig, count: int) -> float:
    """The schedule of the JAX _make_tx at optax's update count (0 first):
    constant; linear warmup from 0; or warmup then cosine decay to 0.
    Raises ValueError where check_schedule does."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        check_schedule(cfg)
        warm = max(cfg.warmup_steps, 1)
        if count < warm:
            return _f32(lr * count / warm)
        decay = cfg.total_steps - warm
        c = min(count - warm, decay)
        return _f32(lr * 0.5 * (1.0 + math.cos(math.pi * c / decay)))
    if cfg.warmup_steps:
        return _f32(lr * min(count, cfg.warmup_steps) / cfg.warmup_steps)
    return lr


class Trainer:
    """init/step over a params tree of f32 tensors on one device, or this
    rank's blocks of it on a mesh."""

    def __init__(self, loss_fn: Callable, init_fn: Callable,
                 config: Optional[TrainerConfig] = None, device: DeviceLike = None,
                 mesh=None, logical_axes: Any = None, rules: ShardingRules = DEFAULT_RULES):
        self.config = config if config is not None else TrainerConfig()
        if self.config.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {self.config.optimizer!r}")
        check_schedule(self.config)
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.device = resolve_device(device)
        self.mesh = mesh
        self.plan = None if mesh is None else MeshPlan(mesh, logical_axes, rules)
        self._template: Optional[TrainState] = None

    def _placements(self, params) -> list:
        """Each leaf's placement in _leaves order (replicated without
        logical axes)."""
        if self.plan.placements is None:
            return [(None,) * p.dim() for p in _leaves(params)]
        return _leaves_of_placements(self.plan.placements)

    def shard(self, params):
        """This rank's blocks of a whole params tree (copies)."""
        if self.plan is None:
            return params
        leaves = iter(self._placements(params))
        order = {id(p): next(leaves) for p in _leaves(params)}
        return tree_map(lambda p: shard_tensor(p, self.mesh, order[id(p)], self.plan.rank)
                        .contiguous().clone(), params)

    # ---- init -----------------------------------------------------------

    def init_opt_state(self, params) -> Dict[str, Any]:
        """Optimizer state as optax keeps it: the update count and AdamW's
        two moments, or SGD's momentum trace."""
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        chain = optax_chain(self.config)
        if self.config.optimizer == "sgd":
            return OptState(chain=chain, count=0, trace=tree_map(zeros, params))
        return OptState(chain=chain, count=0, mu=tree_map(zeros, params),
                        nu=tree_map(zeros, params))

    def init(self, seed: int = 0) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        out = self.init_fn(gen)
        params, extra = out if isinstance(out, tuple) else (out, None)
        return self.state_from_params(self.shard(params), extra)

    def state_from_params(self, params, extra=None) -> TrainState:
        """A fresh TrainState (zero moments, step 0) around given params
        (this rank's blocks, under a mesh)."""
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        return TrainState(params, self.init_opt_state(params), 0, extra)

    def state_template(self) -> TrainState:
        """The TrainState's shapes and dtypes as meta tensors (no storage),
        the restore target of ``CheckpointManager.restore``. Found by one
        init on the trainer's device, whose tensors are freed at once."""
        def meta(t):
            return torch.empty_like(t, device="meta") if isinstance(t, torch.Tensor) else t

        if self._template is None:
            with torch.no_grad():
                state = self.init(0)
            opt = state.opt_state
            self._template = TrainState(
                tree_map(meta, state.params),
                OptState({k: tree_map(meta, v) for k, v in opt.items()}, chain=opt.chain),
                0, tree_map(meta, state.extra))
        return self._template

    def bind_checkpoints(self, manager) -> None:
        """Hand ``manager`` this trainer's mesh and each param leaf's
        placement, in ``_leaves`` order (the optimizer's moments share
        them; the step count and ``extra`` are replicated), so a gang saves
        and restores each rank's blocks. Nothing without a mesh."""
        if self.plan is not None:
            params = self.state_template().params
            manager.set_layout(self.mesh, params, self._placements(params))

    def reshard_state(self, state: TrainState, source: MeshPlan) -> TrainState:
        """Re-lay ``state``, this rank's blocks under ``source`` (the plan
        of another mesh over the same ranks and process group), onto this
        trainer's placements: the elastic resize seam. Every rank all-gathers
        its blocks of a leaf at once and cuts its new block from them by the
        checkpoint's block algebra (``recut``: the source blocks the new
        block overlaps, each read from its ``block_owner``), so a resize and
        a re-cut restore lay blocks out by one rule. The optimizer's moments
        follow their params' placements; the step count and ``extra`` are
        replicated and kept. Values move unchanged, bit for bit."""
        if self.plan is None:
            raise ValueError("reshard_state needs a trainer on a mesh")
        # source ranks in the order gather_no_grad stacks their blocks
        order = [int(r) for r in source.mesh.mesh.flatten().tolist()]
        if sorted(order) != sorted(int(r) for r in self.mesh.mesh.flatten().tolist()):
            raise ValueError(f"source mesh ranks {sorted(order)} are not this trainer's")
        old_places = ([(None,) * p.dim() for p in _leaves(state.params)]
                      if source.placements is None
                      else _leaves_of_placements(source.placements))
        new_places = self._placements(state.params)
        axes = tuple(source.mesh.mesh_dim_names or ())

        @torch.no_grad()
        def relay(leaf: torch.Tensor, src, dst) -> torch.Tensor:
            counts = block_counts(source.sizes, src)
            whole = tuple(s * n for s, n in zip(leaf.shape, counts))
            blocks = coll.gather_no_grad(leaf.contiguous(), source.mesh, axes)
            out = torch.empty(tuple(s // n for s, n in zip(
                whole, block_counts(self.plan.sizes, dst))), dtype=leaf.dtype,
                device=leaf.device)
            for index, src_sl, dst_sl in recut(whole, source.sizes, src, self.mesh, dst,
                                               self.plan.rank):
                owner = block_owner(source.mesh, src, index)
                out[dst_sl] = blocks[order.index(owner)][src_sl]
            return out

        def relay_tree(tree):
            leaves = iter(zip(old_places, new_places))
            moved = {id(p): relay(p.detach(), *next(leaves)) for p in _leaves(tree)}
            return tree_map(lambda p: moved[id(p)], tree)

        params = tree_map(lambda p: p.requires_grad_(True), relay_tree(state.params))
        opt = state.opt_state
        slots = {k: v if k == "count" else relay_tree(v) for k, v in opt.items()}
        return TrainState(params, OptState(slots, chain=opt.chain), state.step, state.extra)

    def restore_or_init(self, seed: int = 0, manager=None) -> TrainState:
        """Resume from ``manager``'s latest checkpoint if one exists (under
        a gang the step its chief reads, on every rank), else init fresh:
        the restart-based recovery contract. A restore lands on the
        trainer's device, params requiring grad as ``init`` sets them."""
        if manager is not None:
            self.bind_checkpoints(manager)
            step = manager.restore_step()
            if step is not None:
                state = manager.restore(self.state_template(), step=step, device=self.device)
                state.params = tree_map(lambda p: p.requires_grad_(True), state.params)
                return state
        return self.init(seed)

    # ---- step -----------------------------------------------------------

    def _loss(self, params, batch, extra):
        out = self.loss_fn(params, batch, extra)
        return out if isinstance(out, tuple) else (out, extra)

    def _grads(self, state: TrainState, batch):
        """(loss, new_extra): grads land in each param's .grad (f32)."""
        params = _leaves(state.params)
        for p in params:
            p.grad = None
        accum = self.config.grad_accum
        if accum <= 1:
            loss, extra = self._loss(state.params, batch, state.extra)
            loss.backward()
            return loss.detach(), extra

        def split(x):
            if x.shape[0] % accum:
                raise ValueError(f"batch dim {x.shape[0]} not divisible by grad_accum={accum}")
            return x.reshape(accum, x.shape[0] // accum, *x.shape[1:])

        micro = tree_map(split, batch)
        extra, loss_sum = state.extra, torch.zeros((), device=self.device)
        for i in range(accum):
            loss, extra = self._loss(state.params, tree_map(lambda m: m[i], micro), extra)
            loss.backward()  # .grad sums the microbatch grads in f32
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / accum
        for p in params:
            p.grad.mul_(inv)
        return loss_sum * inv, extra

    @torch.no_grad()
    def _reduce_grads(self, params: list) -> None:
        """Sum each leaf's gradient over the loss axes (data axes and cp) it
        is not split on (bucketed flat all-reduces), then divide by the
        loss-rank count."""
        plan = self.plan
        if not plan.loss_axes:
            return
        buckets: Dict[tuple, list] = {}
        for p, placement in zip(params, self._placements_cache):
            split = {a for part in placement for a in split_axes(part)}
            axes = tuple(a for a in plan.loss_axes if a not in split)
            if axes:
                buckets.setdefault(axes, []).append(p.grad)
        for axes, grads in buckets.items():
            start = 0
            while start < len(grads):
                group, n = [], 0
                while start < len(grads) and (not group or n + grads[start].numel()
                                              <= GRAD_BUCKET_ELEMS):
                    group.append(grads[start])
                    n += grads[start].numel()
                    start += 1
                flat = coll.sum_no_grad(torch.cat([g.reshape(-1) for g in group]),
                                        self.mesh, axes)
                for g, part in zip(group, flat.split([g.numel() for g in group])):
                    g.copy_(part.view_as(g))
        for p in params:
            p.grad.mul_(1.0 / plan.loss_size)

    def _global_norm(self, grads: list):
        """The global norm of the gradients: per-leaf norms, those of split
        leaves summed (as squares) over the axes each is split on."""
        norms = [torch.linalg.vector_norm(g) for g in grads]
        if self.plan is not None:
            groups: Dict[tuple, list] = {}
            for i, placement in enumerate(self._placements_cache):
                axes = tuple(a for part in placement for a in split_axes(part)
                             if self.plan.size(a) > 1)
                if axes:
                    groups.setdefault(axes, []).append(i)
            for axes, idx in groups.items():
                sq = coll.sum_no_grad(torch.stack([norms[i] for i in idx]).square(),
                                      self.mesh, axes)
                for i, v in zip(idx, sq.sqrt().unbind(0)):
                    norms[i] = v
        return torch.linalg.vector_norm(torch.stack(norms))

    @torch.no_grad()
    def _apply(self, state: TrainState) -> None:
        cfg = self.config
        params = _leaves(state.params)
        if self.plan is not None:
            self._placements_cache = self._placements(state.params)
            self._reduce_grads(params)
        grads = [p.grad for p in params]
        norm = None
        if cfg.grad_clip:
            # optax clip_by_global_norm: g if norm < max else g / norm * max,
            # decided on the device (no host sync)
            norm = self._global_norm(grads)
            factor = torch.where(norm < cfg.grad_clip, torch.ones_like(norm),
                                 cfg.grad_clip / norm)
            for g in grads:
                g.mul_(factor)
        opt = state.opt_state
        count = opt["count"]
        lr = learning_rate_at(cfg, count)
        if cfg.optimizer == "sgd":
            for p, g, t in zip(params, grads, _leaves(opt["trace"])):
                t.mul_(cfg.momentum).add_(g)
                p.add_(t, alpha=-lr)
        else:
            b1, b2 = cfg.beta1, cfg.beta2
            # optax's bias corrections, in f32 as there
            bc1 = _f32(1.0 - np.float32(b1) ** np.float32(count + 1))
            bc2 = _f32(1.0 - np.float32(b2) ** np.float32(count + 1))
            for p, g, m, v in zip(params, grads, _leaves(opt["mu"]), _leaves(opt["nu"])):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (m / bc1).div_((v / bc2).sqrt_().add_(1e-8))
                if cfg.weight_decay:
                    upd.add_(p, alpha=cfg.weight_decay)
                p.add_(upd, alpha=-lr)
        opt["count"] = count + 1
        for p in params:
            p.grad = None
        return norm

    def replicated_leaves(self, params) -> list:
        """The leaves no mesh axis of size above 1 splits (every leaf
        without a mesh), in tree order: whole on every rank, and the same
        bytes on every rank of a sound run."""
        if self.plan is None:
            return _leaves(params)
        return [p for p, placement in zip(_leaves(params), self._placements(params))
                if not any(self.plan.size(a) > 1 for part in placement
                           for a in split_axes(part))]

    def gradients(self, state: TrainState, batch):
        """(loss, grads) of one batch without an update: the gradient tree
        the step would clip and apply (this rank's blocks, reduced over the
        data axes, under a mesh)."""
        loss, _ = self._grads(state, batch)
        params = _leaves(state.params)
        if self.plan is not None:
            self._placements_cache = self._placements(state.params)
            self._reduce_grads(params)
        grads = tree_map(lambda p: p.grad.detach().clone(), state.params)
        for p in params:
            p.grad = None
        return loss, grads

    def step(self, state: TrainState, batch):
        """One update: (state, {"loss": f32 scalar tensor}, and the
        gradients' global norm before the clip as ``grad_norm`` when one is
        set), no host sync. Under a mesh ``batch`` is this rank's block and
        the loss the global batch's."""
        loss, extra = self._grads(state, batch)
        norm = self._apply(state)
        metrics = {"loss": loss}
        if norm is not None:
            metrics["grad_norm"] = norm
        return TrainState(state.params, state.opt_state, state.step + 1, extra), metrics
