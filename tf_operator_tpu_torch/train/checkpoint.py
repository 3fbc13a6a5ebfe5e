"""Checkpoint/resume: step-indexed npy checkpoints and the workload step loop.

Port of ``tf_operator_tpu/train/checkpoint.py``'s npy backend and of
``WorkloadCheckpointer``. A gang restart (the controller deletes and
recreates every process after a retryable failure) resumes from the last
saved step instead of step 0.

On disk a one-process step is the JAX package's npy layout, leaf for
leaf: one ``leaf_{i}.npy`` per leaf plus a ``manifest.json`` that lists
each leaf's ``path`` (``jax.tree_util.keystr`` of the JAX package's
tree), index, shape and dtype, and the writing world size. A checkpoint
written by either package restores into the other. The port's
``TrainState`` maps onto the JAX wire tree ``{"extra", "opt_state",
"params", "step"}``: params and extra keep their trees, ``step`` is an
int32 scalar, and the optimizer state takes optax's layout for the same
config, which the state's ``OptState.chain`` describes
(``train/trainer.py``): for the LM trainer's ``chain(clip_by_global_norm,
adamw)`` ``['opt_state'][1][0].count``, ``['opt_state'][1][0].mu[...]``,
``['opt_state'][1][0].nu[...]``; for SGD with momentum
``['opt_state'][0].trace[...]``; a schedule adds its own ``count``.
bfloat16 leaves are raw 2-byte ``.npy`` bodies (descr ``<V2``) with
``"dtype": "bfloat16"`` in the manifest, as the JAX package writes them.

A step directory is written under ``.tmp_step_{step}_{pid}``, its
``manifest.json`` last (fsync'd), then renamed into place in one atomic
rename: the manifest's presence is the commit, so a crash anywhere
before it leaves an orphan that the next manager sweeps, never a torn
resume point. With ``async_save`` the caller pays a device-side clone of
the state, ordered on the current CUDA stream before the next step's
in-place update; a drain thread waits on that clone's event from its own
stream, moves each leaf to the host in ``chunk_bytes`` pieces through one
reused pinned buffer, writes it and frees the leaf's staging copy.

A gang (a process group of more than one rank, the ranks of the
trainer's mesh) saves one step together, into one directory the gang
shares (``checkpoint_dir`` is assumed shared, as orbax assumes it):

- Each rank writes the blocks it owns, one ``leaf_{i}.block_{k}.npy``
  a leaf block (``k`` the block's place in the leaf's block grid, row
  major), fsync'd; a replicated block is written by its owner alone
  (``parallel/sharding.py`` ``block_owner``). The trainer hands the
  manager its mesh and each param leaf's placement (``set_layout``); the
  optimizer's moments share the params' placements, and every other
  leaf (the step count, the update count, ``extra``) is replicated.
- A rank whose blocks are on disk fsyncs its marker ``.rank_{r}.done``.
  The gang's chief (the rank at the mesh's origin, rank 0) waits for
  every rank's marker, up to ``commit_timeout_s``, removes them, writes
  ``manifest.json`` last (each leaf's global shape, dtype, placement and
  block files; the mesh's axes, sizes and ranks; ``world_size``) and
  renames the directory to ``step_{N}``: the names the JAX package's
  ``latest_checkpoint_step`` and ``checkpoint_world_size`` read. The
  other ranks wait for that commit. The drain thread issues no
  collective: the gang coordinates through these files, so a missing
  marker means no commit, and a save that cannot commit raises at the
  next ``save`` or fence on every rank.
- The tmp directory is named by the gang's incarnation
  (``.tmp_step_{step}_g{token}-{n}``, the token drawn by the chief once
  a process group and sent to the gang when a manager is made, ``n`` the
  manager's save count), and only the chief sweeps, when a manager is
  made and before any rank writes: every tmp directory but its own
  incarnation's, so a live drain of the same gang is left alone. Pruning
  and ``on_commit`` run on the chief after its commit.
- ``restore_step`` is the chief's latest committed step, sent to every
  rank on the main thread; a restore reads this rank's blocks, or, onto
  another mesh or world (a gang step restored by one process, a
  one-process step by a gang), re-cuts the saved blocks through
  ``parallel/sharding.py`` ``recut``, reading only the slices it needs
  (``np.load(..., mmap_mode="r")``). A missing block raises.

Declared differences from the JAX package:

- Only the npy backend exists: ``backend="auto"`` means npy, and
  ``"orbax"`` raises. A gang saves in the sharded layout above, not in
  orbax's; the JAX package restores a gang's step only after a re-cut to
  world 1 saved by one process.
- The writing world size defaults to the gang's size (1 without a
  process group).
- ``restore`` takes ``device=``: a template may hold meta tensors (shape
  and dtype only, as ``Trainer.state_template`` returns), and the leaves
  then land on ``device``; otherwise each lands on its template leaf's
  device.
- ``WorkloadCheckpointer.run_loop`` runs a chunk of ``device_loop`` steps
  as a Python loop and warms up with one step (eager PyTorch compiles
  nothing), and a loop left by an exception (fault injection's retryable
  exit included) fences the in-flight save before it propagates, so an
  accepted save commits before the process exits.
- Under a gang the chief alone pulls a peer's step, and only a step of
  its own world unless ``allow_world_resize``.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import math
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tf_operator_tpu_torch.parallel.sharding import (
    block_counts,
    block_owner,
    mesh_sizes,
    recut,
)
from tf_operator_tpu_torch.rendezvous.context import DIST_TIMEOUT_S
from tf_operator_tpu_torch.train.trainer import OptState, TrainState

log = logging.getLogger("tpujob.checkpoint")

_STEP_DIR = re.compile(r"^step_(\d+)$")

# Completeness markers orbax leaves in a finalized step directory: a bare
# numeric directory without one is a save torn mid-crash. The port writes
# no orbax steps, but discovery reads a directory the JAX package may
# share, as the controller does.
_ORBAX_COMMIT_MARKERS = ("_CHECKPOINT_METADATA", "commit_success.txt")


def _orbax_step_complete(step_dir: str) -> bool:
    return any(os.path.exists(os.path.join(step_dir, m)) for m in _ORBAX_COMMIT_MARKERS)


def checkpoint_world_size(directory: str, step: int) -> int:
    """World size recorded in a committed npy step's manifest, 0 when
    untagged or absent."""
    try:
        with open(os.path.join(directory, f"step_{int(step)}", "manifest.json")) as f:
            return int(json.load(f).get("world_size", 0) or 0)
    except (OSError, ValueError, TypeError):
        return 0


def latest_checkpoint_step(directory: str) -> int:
    """Latest complete checkpointed step under ``directory``, 0 when none:
    an npy ``step_N`` counts when its ``manifest.json`` exists, an orbax
    numeric directory when its commit marker does."""
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    best = 0
    for name in names:
        m = _STEP_DIR.match(name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            best = max(best, int(m.group(1)))
        elif (name.isdigit() and os.path.isdir(os.path.join(directory, name))
              and _orbax_step_complete(os.path.join(directory, name))):
            best = max(best, int(name))
    return best


# ---------------------------------------------------------------------------
# the wire tree
# ---------------------------------------------------------------------------


class _Fields:
    """A named-tuple node of the wire tree (an optax state): its leaves
    flatten in field order under ``.name`` paths."""

    def __init__(self, **fields) -> None:
        self.fields = fields


def _opt_to_wire(opt) -> Any:
    """The port's OptState -> optax's state tree for the same config."""
    if not isinstance(opt, OptState):
        return opt
    count = opt["count"]
    if not isinstance(count, torch.Tensor):
        count = np.int32(count)
    nodes = {"empty": lambda: (),
             "adam": lambda: _Fields(count=count, mu=opt["mu"], nu=opt["nu"]),
             "trace": lambda: _Fields(trace=opt["trace"]),
             "sched": lambda: _Fields(count=count)}

    def node(tag):
        return tuple(node(t) for t in tag) if isinstance(tag, tuple) else nodes[tag]()

    return node(opt.chain)


def _opt_from_wire(wire, like) -> Any:
    """optax's state tree -> an OptState shaped like ``like`` (count None
    when the layout holds none: SGD at a constant rate)."""
    if not isinstance(like, OptState):
        return wire
    out = OptState(chain=like.chain, count=None)

    def walk(tag, w):
        if isinstance(tag, tuple):
            for t, x in zip(tag, w):
                walk(t, x)
        elif tag != "empty":
            for name, v in w.fields.items():
                out[name] = int(v) if name == "count" else v

    walk(like.chain, wire)
    return out


def _to_tree(state: Any) -> Any:
    """TrainState -> the JAX package's wire tree (plain pytrees pass)."""
    if isinstance(state, TrainState):
        step = state.step if isinstance(state.step, torch.Tensor) else np.int32(state.step)
        return {"params": state.params, "opt_state": _opt_to_wire(state.opt_state),
                "step": step, "extra": state.extra}
    return state


def _from_tree(tree: Any, like: Any) -> Any:
    """Wire tree -> the type of ``like`` (TrainState, its step and count
    as ints, or the plain pytree)."""
    if isinstance(like, TrainState) and isinstance(tree, dict):
        step = int(tree["step"])
        opt = _opt_from_wire(tree.get("opt_state"), like.opt_state)
        if isinstance(opt, dict) and opt.get("count", 0) is None:
            opt["count"] = step  # the update count is the step
        return TrainState(params=tree.get("params"), opt_state=opt, step=step,
                          extra=tree.get("extra"))
    return tree


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in the JAX package's flatten order: dict
    keys sorted, sequences in order, named-tuple fields in field order,
    None empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, _Fields):
        return [x for k, v in tree.fields.items() for x in _flatten(v, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in flatten order from
    the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, _Fields):
        return _Fields(**{k: _unflatten(v, leaves) for k, v in tree.fields.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _host_array(leaf) -> np.ndarray:
    """A leaf's bytes on the host as a contiguous numpy array: bfloat16 as
    int16 (the manifest carries the real dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().contiguous().numpy()
    return np.asarray(leaf)


def _npy_header(f, dtype_name: str, shape: tuple, host_dtype: np.dtype) -> None:
    """The .npy 1.0 header ``np.save`` writes for this leaf; bfloat16 has
    the descr ``<V2`` that numpy gives ml_dtypes' bfloat16."""
    descr = "<V2" if dtype_name == "bfloat16" else np.lib.format.dtype_to_descr(host_dtype)
    np.lib.format.write_array_header_1_0(
        f, {"descr": descr, "fortran_order": False, "shape": tuple(shape)})


def _write_npy_chunked(path: str, arr: np.ndarray, dtype_name: str, chunk_bytes: int,
                       durable: bool = False, digest=None) -> int:
    """An np.save-compatible .npy of a host array, its body written in
    ``chunk_bytes`` quanta, fsync'd when ``durable`` and fed to ``digest``
    (a hashlib object) when given. Returns the body's bytes."""
    arr = np.asarray(arr)
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        _npy_header(f, dtype_name, arr.shape, arr.dtype)
        mv = memoryview(arr.reshape(-1).view(np.uint8))
        for off in range(0, len(mv), chunk_bytes):
            f.write(mv[off:off + chunk_bytes])
            if digest is not None:
                digest.update(mv[off:off + chunk_bytes])
        if durable:
            f.flush()
            os.fsync(f.fileno())
    return len(mv)


def _load_leaf(path: str, rec: dict, mmap: bool = False) -> np.ndarray:
    """A saved leaf (or block) as numpy, mapped rather than read with
    ``mmap``: bfloat16 (raw V2 bytes) comes back as int16, to be viewed as
    bfloat16 on the torch side."""
    arr = np.load(path, mmap_mode="r" if mmap else None)
    if rec.get("dtype") == "bfloat16":
        return arr.view(np.int16)
    if "dtype" in rec and arr.dtype != np.dtype(rec["dtype"]):
        arr = arr.view(np.dtype(rec["dtype"]))
    return arr


# A wire leaf that is a param's optimizer moment: its params-relative path.
_MOMENT = re.compile(r"\.(?:mu|nu|trace)(\[.*)$")


def _param_path(path: str) -> Optional[str]:
    """The params-relative path of a wire leaf that is a param or one of
    its optimizer moments (which share the param's placement), else None."""
    if path.startswith("['params']"):
        return path[len("['params']"):]
    m = _MOMENT.search(path)
    return m.group(1) if m else None


# ---------------------------------------------------------------------------
# the gang
# ---------------------------------------------------------------------------

# gang ranks -> (the process group, the token its chief drew for it): one
# token per gang incarnation, whichever manager asks first
_GANG_TOKENS: Dict[tuple, tuple] = {}


def gang_size() -> int:
    """The process group's world size, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class _Gang:
    """The ranks that save a step together: a mesh's, its chief at the
    mesh's origin, or without a mesh every rank of the process group, the
    chief rank 0. ``from_chief`` is its one collective, on the main
    thread."""

    def __init__(self, mesh=None) -> None:
        import torch.distributed as dist

        self.mesh = mesh
        self.rank = dist.get_rank()
        self.ranks = (tuple(range(dist.get_world_size())) if mesh is None
                      else tuple(int(r) for r in mesh.mesh.flatten().tolist()))
        self.chief = self.ranks[0]
        nccl = dist.get_backend() == "nccl"
        self.device = torch.device("cuda", torch.cuda.current_device()) if nccl else \
            torch.device("cpu")

    def from_chief(self, values: List[int]) -> List[int]:
        """The chief's ints on every rank: a sum over the gang to which the
        others add 0, along each mesh axis in turn."""
        import torch.distributed as dist

        mine = values if self.rank == self.chief else [0] * len(values)
        t = torch.tensor([int(v) for v in mine], dtype=torch.int64, device=self.device)
        if self.mesh is None:
            dist.all_reduce(t)
        else:
            for axis, size in mesh_sizes(self.mesh).items():
                if size > 1:
                    dist.all_reduce(t, group=self.mesh.get_group(axis))
        return [int(v) for v in t.tolist()]

    def chief_token(self) -> int:
        """The incarnation's token, on the chief: drawn once a process
        group and gang."""
        import torch.distributed as dist

        pg, token = _GANG_TOKENS.get(self.ranks, (None, 0))
        if pg is not dist.group.WORLD:
            token = int.from_bytes(os.urandom(6), "little") | 1
            _GANG_TOKENS[self.ranks] = (dist.group.WORLD, token)
        return token


def _gang_of(mesh) -> Optional[_Gang]:
    """The gang of a manager on ``mesh`` (on the whole process group
    without one), or None for one rank."""
    n = gang_size() if mesh is None else int(mesh.mesh.numel())
    if n <= 1:
        return None
    if gang_size() == 1:
        raise RuntimeError(f"a checkpoint gang of {n} ranks needs a process group: "
                           "join the gang first (rendezvous.context.initialize_distributed)")
    return _Gang(mesh)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Step-indexed npy checkpoints under one directory.

    Args:
        directory: checkpoint root (created if missing).
        keep: retain at most this many checkpoints (oldest pruned).
        backend: "auto" or "npy" (the same here); "orbax" is not ported.
        readonly: refuse saves and skip the orphan sweep (a reader of a
            live writer's directory).
        async_save: stage on the device and drain in the background (see
            the module docstring); at most one drain in flight, fenced by
            ``save(..., wait=True)``, ``wait_until_finished`` and ``close``.
        chunk_bytes: the drain's device-to-host and write quantum.
        on_commit: ``on_commit(step, step_dir)`` after a step commits
            (best-effort: its exceptions are logged); under a gang, on the
            chief.
        world_size: stamped into each manifest (None means the gang's
            size) and expected at restore; a manifest of another world
            refuses to restore unless ``allow_world_resize``.
        mesh: the gang's DeviceMesh (None: the whole process group, or one
            process without one). Every rank of it makes its manager at
            the same point (one collective). See the module docstring.
        block_digests: record each written block's sha256 in ``saves``.
        commit_timeout_s: how long a gang's chief waits for the other
            ranks' blocks, and they for its commit.

    ``last_save_stall_s`` after each accepted save is the wall time the
    caller was blocked; ``saves`` holds, for each accepted save, this
    rank's stall, blocks and bytes written, and (once fenced) the seconds
    from the save's start until its blocks were on disk (``drain_s``) and
    until the step was committed (``commit_s``); ``last_restore`` the last
    restore's step, seconds, blocks and bytes read, and whether it re-cut
    another layout's blocks.
    """

    def __init__(
        self,
        directory: str,
        keep: int = 3,
        backend: str = "auto",
        readonly: bool = False,
        async_save: bool = True,
        chunk_bytes: int = 64 << 20,
        on_commit: Optional[Callable[[int, str], None]] = None,
        world_size: Optional[int] = None,
        allow_world_resize: bool = False,
        mesh=None,
        block_digests: bool = False,
        commit_timeout_s: float = DIST_TIMEOUT_S,
    ) -> None:
        if backend not in ("auto", "npy"):
            raise NotImplementedError(
                f"checkpoint backend {backend!r}: only npy is ported (auto means npy)")
        self.backend = "npy"
        self.directory = os.path.abspath(str(directory))
        self.keep = int(keep)
        self.readonly = bool(readonly)
        self.async_save = bool(async_save)
        self.chunk_bytes = max(1 << 20, int(chunk_bytes))
        self.on_commit = on_commit
        self.world_size = world_size
        self.allow_world_resize = bool(allow_world_resize)
        self.block_digests = bool(block_digests)
        self.commit_timeout_s = float(commit_timeout_s)
        self.last_save_stall_s = 0.0
        self.saves: List[Dict[str, Any]] = []
        self._logged = 0  # saves logged
        self.last_restore: Optional[Dict[str, Any]] = None
        self._drain: Optional[threading.Thread] = None
        self._drain_step: Optional[int] = None
        self._drain_error: Optional[BaseException] = None
        self._pinned: Optional[torch.Tensor] = None  # the drain's host buffer
        # Test seam: called as _fault_hook(phase, step) with phase in
        # {"leaf", "manifest", "commit"} from inside the drain (and a
        # gang's sync save).
        self._fault_hook: Optional[Callable[[str, int], None]] = None
        self._gang = _gang_of(mesh)
        self._layout = None  # (mesh, {params path: placement}) from set_layout
        self._incarnation = ""  # a gang's tmp-name tag
        self._save_count = 0
        os.makedirs(self.directory, exist_ok=True)
        if self.readonly:
            return
        if self._gang is None:
            self._sweep()
            return
        token = self._gang.chief_token() if self.is_chief else 0
        if self.is_chief:
            self._sweep(f"g{token:x}")
        # after the chief's sweep: no rank writes before it is done
        self._incarnation = f"g{self._gang.from_chief([token])[0]:x}"

    def _sweep(self, incarnation: str = "") -> None:
        """Remove partial-save orphans of crashed writers: every tmp step
        directory but this process's (its pid) and its gang
        incarnation's, whose drains may be live."""
        for name in os.listdir(self.directory):
            if not name.startswith(".tmp_step_") or name.endswith(f"_{os.getpid()}"):
                continue
            if incarnation and f"_{incarnation}-" in name:
                continue
            shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    # ---- the gang -------------------------------------------------------

    @property
    def gang_size(self) -> int:
        return 1 if self._gang is None else len(self._gang.ranks)

    @property
    def is_chief(self) -> bool:
        """This rank commits, prunes and sweeps (always, for one process)."""
        return self._gang is None or self._gang.rank == self._gang.chief

    def from_chief(self, values: List[int]) -> List[int]:
        """The chief's ints on every rank of the gang (a collective on the
        main thread; for one process the values themselves)."""
        return list(values) if self._gang is None else self._gang.from_chief(values)

    def set_layout(self, mesh, params: Any, placements: List[Any]) -> None:
        """Bind the trainer's mesh and each param leaf's placement, in the
        params' flatten order (``Trainer._placements``, which walks dict
        keys sorted as ``_flatten`` does): a gang saves and restores each
        rank's blocks by them. A mesh of one rank changes nothing."""
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        if len(ranks) == 1:
            return
        if self._gang is None or sorted(ranks) != sorted(self._gang.ranks) or \
                ranks[0] != self._gang.chief:
            raise ValueError(f"a mesh of ranks {ranks} is not this manager's gang "
                             f"({None if self._gang is None else list(self._gang.ranks)})")
        paths = [p for p, _ in _flatten(params)]
        if len(paths) != len(placements):
            raise ValueError(f"{len(placements)} placements for {len(paths)} param leaves")
        self._layout = (mesh, {p: tuple(x) for p, x in zip(paths, placements)})

    def _placement(self, path: str, ndim: int) -> tuple:
        """A wire leaf's placement under the bound layout: its param's, or
        replicated."""
        return self._layout[1].get(_param_path(path), (None,) * ndim)

    # ---- discovery ------------------------------------------------------

    def all_steps(self) -> List[int]:
        steps = set()
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                steps.add(int(m.group(1)))
        # an accepted async save counts as existing (read-your-own-writes);
        # restore paths fence before reading
        if self._drain_step is not None and self._drain_error is None:
            steps.add(self._drain_step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_step(self) -> Optional[int]:
        """The step every rank restores: the latest committed step as the
        chief reads it, sent to the gang (every rank calls this at the same
        point); None when there is none."""
        step = self.latest_step() if self.is_chief else None
        got = self.from_chief([-1 if step is None else step])[0]
        return None if got < 0 else got

    def reload(self) -> None:
        """Nothing to re-read: npy discovery scans the directory each call."""

    # ---- save -----------------------------------------------------------

    def save(self, step: int, state: Any, wait: bool = False) -> bool:
        """Save ``state`` (TrainState or pytree) at ``step``. True when
        written or accepted, False when the step already exists.
        ``wait=True`` fences even a rejected duplicate, which may be the
        in-flight write itself. Under a gang every rank saves every step,
        and the save needs the layout (``set_layout``)."""
        if self.readonly:
            raise RuntimeError("CheckpointManager is readonly; refusing to save")
        step = int(step)
        tree = _to_tree(state)
        t0 = time.perf_counter()
        n = len(self.saves)
        try:
            if self.async_save:
                accepted = self._npy_save_async(step, tree, t0)
                if wait:
                    self.wait_until_finished()
                return accepted
            return self._npy_save(step, tree, t0)
        finally:
            self.last_save_stall_s = time.perf_counter() - t0
            if len(self.saves) > n:
                self.saves[-1]["stall_s"] = self.last_save_stall_s
            self._log_saves()

    def wait_until_finished(self) -> None:
        """Block until the in-flight async save has committed; re-raises a
        drain failure once."""
        drain = self._drain
        if drain is not None:
            drain.join()
            self._drain = None
            self._drain_step = None
        err, self._drain_error = self._drain_error, None
        if err is not None:
            self._logged = len(self.saves)  # never committed: no line
            raise RuntimeError(
                f"async checkpoint drain failed (step never committed): {err}") from err
        self._log_saves()

    def _log_saves(self) -> None:
        """One line a committed save and rank, in order, once its stall and
        commit are known: its figures but the digests."""
        while self._logged < len(self.saves):
            stats = self.saves[self._logged]
            if stats["stall_s"] is None or stats["commit_s"] is None:
                return
            self._logged += 1
            line = {k: v for k, v in stats.items() if k != "digests"}
            line["rank"] = 0 if self._gang is None else self._gang.rank
            log.info("checkpoint save: %s", json.dumps(line))

    def _writer_world_size(self) -> int:
        return int(self.world_size) if self.world_size else self.gang_size

    def _check_restore_world(self, manifest: Dict[str, Any], step: int) -> None:
        saved = int(manifest.get("world_size", 0) or 0)
        expect = int(self.world_size or 0)
        if saved and expect and saved != expect and not self.allow_world_resize:
            raise ValueError(
                f"checkpoint at step {step} was written by a world of "
                f"{saved} but this restore targets a world of {expect}; "
                "a mixed-world resume must be an explicit resize "
                "(allow_world_resize=True), never silent")

    def _record(self, path: str, i: int, leaf) -> Dict[str, Any]:
        return {"path": path, "index": i, "shape": list(_shape(leaf)),
                "dtype": _dtype_name(leaf)}

    def _plan(self, step: int, tree: Any):
        """What this rank writes, (file, leaf, dtype, shape) each, the
        manifest, the tmp directory and this save's stats entry. One
        process writes every leaf whole; a gang rank the blocks it owns."""
        leaves = _flatten(tree)
        if self._gang is None:
            records = [self._record(path, i, leaf) for i, (path, leaf) in enumerate(leaves)]
            writes = [(f"leaf_{r['index']}.npy", leaf, r["dtype"], tuple(r["shape"]))
                      for (_, leaf), r in zip(leaves, records)]
            manifest = {"step": step, "world_size": self._writer_world_size(),
                        "leaves": records}
            tmp = os.path.join(self.directory, f".tmp_step_{step}_{os.getpid()}")
        else:
            if self._layout is None:
                raise RuntimeError("a gang's save needs the trainer's mesh and placements "
                                   "(set_layout; Trainer.restore_or_init binds them)")
            writes, manifest = self._plan_blocks(step, leaves)
            self._save_count += 1
            tmp = os.path.join(self.directory,
                               f".tmp_step_{step}_{self._incarnation}-{self._save_count}")
        stats = {"step": step, "stall_s": None, "blocks": len(writes), "bytes": 0,
                 "drain_s": None, "commit_s": None}
        if self.block_digests:
            stats["digests"] = {}
        self.saves.append(stats)
        return writes, manifest, tmp, stats

    def _plan_blocks(self, step: int, leaves: list):
        mesh = self._layout[0]
        sizes = mesh_sizes(mesh)
        rank = self._gang.rank
        writes, records = [], []
        for i, (path, leaf) in enumerate(leaves):
            local, dtype = _shape(leaf), _dtype_name(leaf)
            placement = self._placement(path, len(local))
            counts = block_counts(sizes, placement)
            blocks = []
            for k, index in enumerate(itertools.product(*(range(n) for n in counts))):
                name, owner = f"leaf_{i}.block_{k}.npy", block_owner(mesh, placement, index)
                blocks.append({"file": name, "index": list(index), "rank": owner})
                if owner == rank:  # the owner's own block is this index
                    writes.append((name, leaf, dtype, local))
            records.append({"path": path, "index": i,
                            "shape": [s * n for s, n in zip(local, counts)], "dtype": dtype,
                            "placement": list(placement), "blocks": blocks})
        manifest = {"step": step, "world_size": self._writer_world_size(), "layout": "blocks",
                    "mesh": {"axes": list(sizes), "shape": list(sizes.values()),
                             "ranks": [int(r) for r in mesh.mesh.flatten().tolist()]},
                    "leaves": records}
        return writes, manifest

    def _commit(self, tmp: str, step: int, manifest: Dict[str, Any], drain: bool) -> bool:
        """Write the manifest (the commit marker) last, rename tmp into
        place, prune and fire on_commit. False when another writer won.
        The async drain and a gang fsync the manifest before the rename,
        and call the fault hook between the two."""
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            if drain:
                f.flush()
                os.fsync(f.fileno())
        if drain and self._fault_hook is not None:
            self._fault_hook("commit", step)
        final = os.path.join(self.directory, f"step_{step}")
        try:
            os.rename(tmp, final)  # the commit
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            return False  # lost a same-step race; theirs is complete
        self._npy_prune()
        self._fire_on_commit(step, final)
        return True

    def _write_host(self, path: str, leaf, dtype: str, stats: dict) -> None:
        digest = hashlib.sha256() if self.block_digests else None
        stats["bytes"] += _write_npy_chunked(path, _host_array(leaf), dtype, self.chunk_bytes,
                                             durable=self._gang is not None, digest=digest)
        if digest is not None:
            stats["digests"][os.path.basename(path)] = digest.hexdigest()

    def _npy_save(self, step: int, tree: Any, t0: float) -> bool:
        final = os.path.join(self.directory, f"step_{step}")
        if os.path.exists(final):
            return False
        writes, manifest, tmp, stats = self._plan(step, tree)
        if self._gang is not None:
            os.makedirs(tmp, exist_ok=True)
            try:
                for name, leaf, dtype, _ in writes:
                    if self._fault_hook is not None:
                        self._fault_hook("leaf", step)
                    self._write_host(os.path.join(tmp, name), leaf, dtype, stats)
                if self._fault_hook is not None:
                    self._fault_hook("manifest", step)
                self._gang_commit(step, tmp, manifest, stats, [w[0] for w in writes], t0)
            except BaseException:
                _abort(tmp)
                raise
            return True
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, leaf, dtype, _ in writes:
            self._write_host(os.path.join(tmp, name), leaf, dtype, stats)
        stats["drain_s"] = time.perf_counter() - t0
        committed = self._commit(tmp, step, manifest, drain=False)
        stats["commit_s"] = time.perf_counter() - t0
        return committed

    def _gang_commit(self, step: int, tmp: str, manifest: Dict[str, Any], stats: dict,
                     files: List[str], t0: float) -> None:
        """This rank's blocks are on disk: its marker, then the chief waits
        for every rank's and commits, the others wait for the commit. A
        failure anywhere leaves no step."""
        rank, deadline = self._gang.rank, time.monotonic() + self.commit_timeout_s
        marker = os.path.join(tmp, f".rank_{rank}.done")
        with open(marker + ".tmp", "w") as f:
            json.dump({"rank": rank, "files": sorted(files)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(marker + ".tmp", marker)
        stats["drain_s"] = time.perf_counter() - t0

        def waited(what: str) -> None:
            if os.path.exists(os.path.join(tmp, ".abort")):
                raise RuntimeError(f"step {step}: a rank of the gang failed its save")
            if time.monotonic() > deadline:
                raise TimeoutError(f"step {step}: {what} within {self.commit_timeout_s} s")
            time.sleep(0.02)

        if self.is_chief:
            pending, written = list(self._gang.ranks), set()
            while pending:
                for r in list(pending):
                    path = os.path.join(tmp, f".rank_{r}.done")
                    if os.path.exists(path):
                        with open(path) as f:
                            written.update(json.load(f)["files"])
                        pending.remove(r)
                if pending:
                    waited(f"no blocks from rank(s) {pending}")
            want = {b["file"] for rec in manifest["leaves"] for b in rec["blocks"]}
            if written != want:
                raise RuntimeError(f"step {step}: the gang wrote {len(written)} blocks, not "
                                   f"the manifest's {len(want)}: missing "
                                   f"{sorted(want - written)[:4]}")
            for r in self._gang.ranks:
                os.remove(os.path.join(tmp, f".rank_{r}.done"))
            self._commit(tmp, step, manifest, drain=True)
        else:
            final = os.path.join(self.directory, f"step_{step}", "manifest.json")
            while not os.path.exists(final):
                waited("no commit from the chief")
        stats["commit_s"] = time.perf_counter() - t0

    # -- the async pipeline -----------------------------------------------

    def _npy_save_async(self, step: int, tree: Any, t0: float) -> bool:
        """Stage, then hand the copies to a drain thread. A duplicate step
        returns before fencing the previous drain."""
        if step in self.all_steps():
            return False
        self.wait_until_finished()  # at most one drain in flight
        if step in self.all_steps():
            return False
        writes, manifest, tmp, stats = self._plan(step, tree)
        staged, event = _stage_leaves([leaf for _, leaf, _, _ in writes])
        files = [(name, dtype, shape) for name, _, dtype, shape in writes]
        self._drain_step = step
        self._drain = threading.Thread(
            target=self._npy_drain, args=(step, tmp, files, staged, manifest, event, stats, t0),
            daemon=True, name=f"ckpt-drain-{step}")
        self._drain.start()
        return True

    def _npy_drain(self, step: int, tmp: str, files: list, staged: list,
                   manifest: Dict[str, Any], event, stats: dict, t0: float) -> None:
        """The background half of the async save: nothing before the final
        rename is discoverable, so a failure anywhere leaves an orphan, and
        each staging copy is released once its leaf is on the host. It
        issues no collective (a gang coordinates through its files)."""
        try:
            if self._gang is None:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
            else:
                os.makedirs(tmp, exist_ok=True)
            stream = None
            if event is not None:
                event, device = event
                stream = torch.cuda.Stream(device)
                stream.wait_event(event)
            for i, (name, dtype, shape) in enumerate(files):
                if self._fault_hook is not None:
                    self._fault_hook("leaf", step)
                leaf, staged[i] = staged[i], None
                path = os.path.join(tmp, name)
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    self._drain_cuda_leaf(path, leaf, dtype, shape, stream, stats)
                else:
                    self._write_host(path, leaf, dtype, stats)
                del leaf  # release the staging copy
            if self._fault_hook is not None:
                self._fault_hook("manifest", step)
            if self._gang is None:
                stats["drain_s"] = time.perf_counter() - t0
                self._commit(tmp, step, manifest, drain=True)
                stats["commit_s"] = time.perf_counter() - t0
            else:
                self._gang_commit(step, tmp, manifest, stats, [f[0] for f in files], t0)
        except BaseException as exc:  # noqa: BLE001 — surfaced at the next fence
            if self._gang is None:
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                _abort(tmp)  # other ranks may still write into it: the next chief sweeps
            self._drain_error = exc
            log.warning("async checkpoint drain for step %d failed: %s", step, exc)

    def _drain_cuda_leaf(self, path: str, leaf: torch.Tensor, dtype: str, shape: tuple,
                         stream, stats: dict) -> None:
        """One staged card leaf to disk: ``chunk_bytes`` pieces copied on
        the drain's stream into the reused pinned buffer, each written
        once the copy lands."""
        if self._pinned is None:
            self._pinned = torch.empty(self.chunk_bytes, dtype=torch.uint8, pin_memory=True)
        buf = self._pinned
        host = buf.numpy()
        flat = leaf.reshape(-1).view(torch.uint8)
        host_dtype = np.dtype(np.int16) if dtype == "bfloat16" else np.dtype(dtype)
        digest = hashlib.sha256() if self.block_digests else None
        with open(path, "wb") as f:
            _npy_header(f, dtype, tuple(shape), host_dtype)
            for off in range(0, flat.numel(), self.chunk_bytes):
                n = min(self.chunk_bytes, flat.numel() - off)
                with torch.cuda.stream(stream):
                    buf[:n].copy_(flat[off:off + n], non_blocking=True)
                stream.synchronize()
                f.write(memoryview(host[:n]))
                if digest is not None:
                    digest.update(memoryview(host[:n]))
            if self._gang is not None:
                f.flush()
                os.fsync(f.fileno())
        stats["bytes"] += flat.numel()
        if digest is not None:
            stats["digests"][os.path.basename(path)] = digest.hexdigest()

    def _fire_on_commit(self, step: int, step_dir: str) -> None:
        if self.on_commit is None:
            return
        try:
            self.on_commit(step, step_dir)
        except Exception:  # noqa: BLE001 — peer publish is best-effort
            log.exception("on_commit hook failed for step %d", step)

    def _npy_prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    # ---- restore --------------------------------------------------------

    def restore(self, template: Any, step: Optional[int] = None,
                device: Optional[torch.device] = None) -> Any:
        """Restore the checkpoint at ``step`` (default: ``restore_step``)
        onto the shapes and dtypes of ``template`` (a TrainState or pytree;
        under a bound layout this rank's blocks). Raises FileNotFoundError
        if there is none."""
        self.wait_until_finished()  # read-your-own-writes under async save
        if step is None:
            step = self.restore_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        tree = self._npy_restore(int(step), _to_tree(template), device=device)
        return _from_tree(tree, template)

    def restore_params(self, template_params: Any, step: Optional[int] = None,
                       device: Optional[torch.device] = None) -> Any:
        """Restore only the params subtree of a TrainState checkpoint."""
        return self.restore_subtrees({"params": template_params}, step=step,
                                     device=device)["params"]

    def restore_subtrees(self, templates: Dict[str, Any], step: Optional[int] = None,
                         device: Optional[torch.device] = None) -> Dict[str, Any]:
        """Restore the named top-level items of a TrainState checkpoint
        ({"params": ...}, or with "extra" for BN state), skipping the rest."""
        self.wait_until_finished()
        if step is None:
            step = self.restore_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        out = self._npy_restore(int(step), dict(templates), subtrees=tuple(templates),
                                device=device)
        return {k: out[k] for k in templates}

    def _npy_restore(self, step: int, tmpl_tree: Any, subtrees: Optional[tuple] = None,
                     device: Optional[torch.device] = None) -> Any:
        t0 = time.perf_counter()
        d = os.path.join(self.directory, f"step_{step}")
        manifest_path = os.path.join(d, "manifest.json")
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(f"no checkpoint at step {step} under {self.directory}")
        with open(manifest_path) as f:
            manifest = json.load(f)
        self._check_restore_world(manifest, step)
        records = manifest["leaves"]
        if subtrees is not None:
            prefixes = tuple(f"['{k}']" for k in subtrees)
            records = [r for r in records if r["path"].startswith(prefixes)]
        leaves = _flatten(tmpl_tree)
        saved_paths = [r["path"] for r in records]
        tmpl_paths = [p for p, _ in leaves]
        if saved_paths != tmpl_paths:
            # leaf files pair with template leaves by flatten order: a
            # structure drift would load weights into the wrong slots
            missing = set(saved_paths) ^ set(tmpl_paths)
            raise ValueError(
                f"checkpoint tree at step {step} does not match restore "
                f"template (differing leaves: {sorted(missing)[:6] or 'order'})")
        saved_mesh = manifest.get("mesh") or {}
        saved_sizes = dict(zip(saved_mesh.get("axes", []), saved_mesh.get("shape", [])))
        mesh = None if self._layout is None else self._layout[0]
        rank = 0 if self._gang is None else self._gang.rank
        out, recut_any, n_read, n_bytes = [], False, 0, 0
        for (path, tmpl_leaf), rec in zip(leaves, records):
            local, tmpl_dtype = _shape(tmpl_leaf), _dtype_name(tmpl_leaf)
            placement = None if mesh is None else self._placement(path, len(local))
            counts = (1,) * len(local) if mesh is None else block_counts(mesh_sizes(mesh),
                                                                          placement)
            whole = tuple(s * n for s, n in zip(local, counts))
            if tuple(rec["shape"]) != whole or rec["dtype"] != tmpl_dtype:
                raise ValueError(
                    f"checkpoint leaf {rec['path']} at step {step} is "
                    f"{rec['dtype']}{tuple(rec['shape'])} but the restore "
                    f"template expects {tmpl_dtype}{whole} — model/"
                    "optimizer config changed between save and restore")
            saved_placement = rec.get("placement") or [None] * len(local)
            files = ({tuple(b["index"]): b["file"] for b in rec["blocks"]} if "blocks" in rec
                     else {(0,) * len(local): f"leaf_{rec['index']}.npy"})
            saved_block = tuple(s // n for s, n in zip(whole, block_counts(saved_sizes,
                                                                             saved_placement)))
            pieces = recut(whole, saved_sizes, saved_placement, mesh, placement, rank)

            def block_path(index):
                p = os.path.join(d, files[index])
                if not os.path.exists(p):
                    raise FileNotFoundError(
                        f"checkpoint at step {step}: block {files[index]} of leaf "
                        f"{rec['path']} is missing under {d}")
                return p

            if len(pieces) == 1 and saved_block == local:
                arr = _load_leaf(block_path(pieces[0][0]), rec)  # this rank's own block
                n_bytes += arr.nbytes
            else:
                recut_any = True
                arr = None
                for index, src, dst in pieces:
                    block = _load_leaf(block_path(index), rec, mmap=True)
                    if arr is None:
                        arr = np.empty(local, dtype=block.dtype)
                    arr[dst] = block[src]
                    n_bytes += arr[dst].nbytes
            n_read += len(pieces)
            if isinstance(tmpl_leaf, torch.Tensor):
                dev = device if device is not None else tmpl_leaf.device
                if torch.device(dev).type == "meta":
                    raise ValueError("restore: the template holds meta tensors; pass device=")
                t = torch.from_numpy(arr)
                if rec["dtype"] == "bfloat16":
                    t = t.view(torch.bfloat16)
                out.append(t.to(dev))
            else:
                out.append(arr)
        self.last_restore = {"step": step, "s": time.perf_counter() - t0, "recut": recut_any,
                             "blocks_read": n_read, "bytes_read": n_bytes}
        return _unflatten(tmpl_tree, iter(out))

    def close(self) -> None:
        self.wait_until_finished()  # fence the drain before exit


def _abort(tmp: str) -> None:
    """Tell the gang this rank's save failed (an ``.abort`` file in the
    shared tmp directory, if it is still there)."""
    try:
        with open(os.path.join(tmp, ".abort"), "w"):
            pass
    except OSError:
        pass


def _stage_leaves(leaves: list):
    """Donation-safe snapshot of the leaves: a device-side clone of every
    tensor, enqueued on the current stream so it reads each leaf before
    the next step updates it in place, and copies of host values.
    Returns (staged, event): ``event`` is (a CUDA event marking the card
    clones' completion, their device), or None when no leaf lives on the
    card."""
    staged, cuda_dev = [], None
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            staged.append(leaf.detach().clone(memory_format=torch.contiguous_format))
            if leaf.is_cuda:
                cuda_dev = leaf.device
        else:
            staged.append(np.array(leaf, copy=True))
    event = None
    if cuda_dev is not None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(cuda_dev))
        event = (done, cuda_dev)
    return staged, event


# ---------------------------------------------------------------------------
# WorkloadCheckpointer
# ---------------------------------------------------------------------------


class WorkloadCheckpointer:
    """The checkpoint wiring shared by operator-launchable workloads.

    Workload keys: ``checkpoint_dir``, ``checkpoint_every`` (steps between
    saves, 0 = final only), ``checkpoint_keep``, ``checkpoint_async``
    (default on), ``checkpoint_backend`` (auto|npy). Tracks the step count
    on the host so the loop never syncs for it. Disabled (every save a
    no-op) without ``checkpoint_dir``.

    With a job context as ``ctx`` it also speaks the peer warm-restore
    protocol (``rendezvous/statechannel.py``): each committed step goes to
    the host's shard depot (``ctx.peer_depot``), a restore consults the
    peer depots (``ctx.restore_peers``) before disk, and save stalls and
    restores are recorded (``ctx.record_save_stall``,
    ``ctx.record_restore``). Every context attribute is read with getattr,
    so a stub context without them works. ``step_losses`` keeps every
    step's loss tensor and ``step_grad_norms`` its gradients' global norm
    where the trainer reports one (device scalars, read after the loop).

    Under a gang (``mesh``, the job's DeviceMesh, made by every rank at the
    same point) each rank saves its blocks and reports its own save stalls;
    the step to resume from, and ``is_complete``, are the chief's reading
    sent to every rank; the chief alone pulls a peer's step (of its own
    world), commits, prunes and pushes the whole step directory to its
    depot. The port's own workload key ``checkpoint_digests`` records each
    written block's sha256 (``CheckpointManager.saves``)."""

    def __init__(self, workload: Dict[str, Any], ctx=None, mesh=None) -> None:
        self.ctx = ctx
        self.manager: Optional[CheckpointManager] = None
        if workload.get("checkpoint_dir"):
            self.manager = CheckpointManager(
                workload["checkpoint_dir"],
                keep=int(workload.get("checkpoint_keep", 3)),
                backend=str(workload.get("checkpoint_backend", "auto")),
                async_save=bool(workload.get("checkpoint_async", True)),
                on_commit=self._push_to_depot,
                world_size=getattr(ctx, "num_processes", None),
                allow_world_resize=bool(workload.get("elastic")),
                mesh=mesh,
                block_digests=bool(workload.get("checkpoint_digests")),
            )
        self.every = int(workload.get("checkpoint_every", 0))
        self._step = 0
        self.start_step = 0
        self._cadence_epoch = 0
        self._cadence_poll_s = float(workload.get("cadence_poll_s", 2.0))
        self._cadence_last_poll = 0.0
        self.save_stalls: List[float] = []  # each accepted save's caller stall (s)
        self.restore_source = ""  # "peer" | "disk" after a warm restore
        self.step_losses: List[Any] = []
        self.step_grad_norms: List[Any] = []

    # -- peer warm-restore protocol ----------------------------------------

    def _push_to_depot(self, step: int, step_dir: str) -> None:
        """on_commit hook: publish a committed step to this host's depot."""
        depot = getattr(self.ctx, "peer_depot", "")
        if not depot:
            return
        from tf_operator_tpu_torch.rendezvous.statechannel import DepotClient

        DepotClient().push_step(depot, self.ctx.namespace, self.ctx.job_name, step, step_dir)

    def prefetch_from_peers(self) -> str:
        """If a live peer depot holds a committed step at least as new as
        the newest on disk, materialize it under the checkpoint directory
        (a tie goes to the peer); a failed peer is dropped and the choice
        re-run over the rest before disk. Returns "peer" or "disk". Under a
        gang the chief alone fetches, a step of its own world unless the
        job may resize, and every rank returns its choice."""
        if self.manager is None:
            return "disk"
        source = self._prefetch() if self.manager.is_chief else "disk"
        if self.manager.gang_size > 1:
            source = ("disk", "peer")[self.manager.from_chief([source == "peer"])[0]]
        return source

    def _prefetch(self) -> str:
        gang = self.manager.gang_size > 1 and not self.manager.allow_world_resize
        world = self.manager._writer_world_size() if gang else None
        peers = list(getattr(self.ctx, "restore_peers", None) or [])
        if not peers:
            return "disk"
        from tf_operator_tpu_torch.rendezvous.statechannel import (
            DepotClient,
            choose_restore_source,
        )

        disk_step = self.manager.latest_step() or 0
        client = DepotClient()
        remaining = list(peers)
        while remaining:
            source, url, step = choose_restore_source(
                remaining, self.ctx.namespace, self.ctx.job_name, disk_step, client=client,
                expect_world_size=world)
            if source != "peer":
                return "disk"
            if client.fetch_step(url, self.ctx.namespace, self.ctx.job_name, step,
                                 self.manager.directory, expect_world_size=world) is not None:
                log.info("warm restore: pulled step %d from peer %s", step, url)
                return "peer"
            remaining = [u for u in remaining if u != url]
            log.warning("peer restore of step %d from %s failed; %d peer(s) left "
                        "before disk fallback (step %d)", step, url, len(remaining), disk_step)
        return "disk"

    def restore_or_init(self, trainer, seed: int = 0):
        """Resume from the best warm source (peer depot, then the latest
        disk checkpoint) or init fresh; primes the host-side step mirror."""
        t0 = time.time()
        self.restore_source = self.prefetch_from_peers()
        state = trainer.restore_or_init(seed, self.manager)
        self._step = self.start_step = int(state.step)
        if self.start_step:
            log.info("resumed from checkpoint at step %d (source=%s)",
                     self.start_step, self.restore_source)
            record = getattr(self.ctx, "record_restore", None)
            if record is not None:
                record(self.restore_source, self.start_step, t0, time.time())
        return state

    def resume_step(self) -> int:
        """Latest checkpointed step (0 if none), without restoring; under a
        gang the chief's reading (every rank calls it)."""
        if self.manager is not None:
            return self.manager.restore_step() or 0
        return 0

    def is_complete(self, steps: int) -> bool:
        """True when a previous run already trained past the budget (the +1
        is the warmup step, which also trains). Reads the directory only
        (under a gang the chief's reading): call it before
        restore_or_init."""
        if self.manager is not None:
            latest = self.manager.restore_step()
            if latest is not None:
                return latest >= steps + 1
        return self.start_step >= steps + 1

    def timed_steps(self, steps: int) -> int:
        return max(0, steps - self.start_step)

    def advance(self, state, loss=None, n: int = 1) -> None:
        """Once per step (or per ``n``-step chunk); saves when a periodic
        save is due, and refuses to save a state whose loss is not finite
        (the loss is fetched to the host on saving steps only)."""
        self._step += n
        if self.manager is not None and self.every and self._step % self.every == 0:
            if loss is not None and not math.isfinite(float(loss)):
                raise AssertionError(
                    f"non-finite loss {float(loss)} at step {self._step}; "
                    "refusing to checkpoint a diverged state")
            self.save(self._step, state)

    def save(self, step: int, state, wait: bool = False) -> bool:
        """One save through the manager, its stall recorded when accepted."""
        accepted = self.manager.save(step, state, wait=wait)
        if accepted:
            self._note_save_stall(step)
        return accepted

    def _note_save_stall(self, step: int) -> None:
        stall = self.manager.last_save_stall_s
        self.save_stalls.append(stall)
        record = getattr(self.ctx, "record_save_stall", None)
        if record is not None:
            now = time.time()
            record(step, now - stall, now)

    def poll_cadence_directive(self, step: Optional[int] = None) -> bool:
        """Apply a pending checkpoint-cadence directive ({"epoch",
        "checkpoint_every"} from ``ctx.poll_checkpoint_cadence_directive``)
        at a step boundary, each epoch once, and ack it
        (``ctx.ack_checkpoint_cadence``). The chief (process 0, or a gang's
        chief) alone polls, at most once per ``cadence_poll_s``. Under a
        gang every rank calls this at the same boundaries (``run_loop``
        does, after each chunk's save decision) and the chief's (epoch,
        every) reaches all of them through one small collective on the
        main thread (``CheckpointManager.from_chief``), so the new cadence
        takes effect on every rank at the same step and their saves stay
        one save. True when an epoch was applied."""
        poll = getattr(self.ctx, "poll_checkpoint_cadence_directive", None)
        if poll is None:
            return False
        gang = self.manager is not None and self.manager.gang_size > 1
        chief = self.manager.is_chief if gang else getattr(self.ctx, "process_id", 0) == 0
        if not (chief or gang):
            return False
        epoch, every = 0, 0
        now = time.time()
        if chief and now - self._cadence_last_poll >= self._cadence_poll_s:
            self._cadence_last_poll = now
            directive = poll() or {}
            epoch = int(directive.get("epoch", 0))
            every = int(directive.get("checkpoint_every", 0))
        if gang:
            epoch, every = self.manager.from_chief([epoch, every])
        if epoch <= self._cadence_epoch:
            return False
        self._cadence_epoch = epoch
        if every > 0 and every != self.every:
            log.info("checkpoint cadence directive epoch %d: every %d -> %d steps",
                     epoch, self.every, every)
            self.every = every
        ack = getattr(self.ctx, "ack_checkpoint_cadence", None)
        if chief and ack is not None:
            ack(epoch, self._step if step is None else int(step))
        return True

    def final(self, state) -> None:
        """The final save, fenced: the process may exit right after."""
        if self.manager is not None:
            self.save(self._step, state, wait=True)

    def report(self) -> Optional[Dict[str, Any]]:
        """This rank's checkpoint figures: each accepted save's stall,
        blocks and bytes written, drain and commit seconds (and block
        digests), and the restore's step, seconds, blocks and bytes read
        and whether it re-cut; None without checkpoints."""
        if self.manager is None:
            return None
        return {"saves": self.manager.saves, "restore": self.manager.last_restore,
                "restore_source": self.restore_source}

    def _fence_quietly(self) -> None:
        """Fence the in-flight save on the way out of a failed loop; the
        loop's own error is the one raised."""
        if self.manager is None:
            return
        try:
            self.manager.wait_until_finished()
        except Exception as exc:  # noqa: BLE001
            log.warning("checkpoint fence on exit failed: %s", exc)

    def _record(self, metrics: dict) -> None:
        self.step_losses.append(metrics["loss"])
        if "grad_norm" in metrics:
            self.step_grad_norms.append(metrics["grad_norm"])

    def run_loop(self, trainer, seed, batch, steps: int, on_step=None,
                 device_loop: int = 1):
        """restore-or-init, one warmup step, then ``steps - start_step``
        timed steps with periodic NaN-gated saves, the finiteness guard and
        the final save. Returns ``(state, loss, timed, step_s)``; ``step_s``
        is None when no timed steps remained. Callers check
        :meth:`is_complete` first. ``on_step(global_step)`` fires after
        every advance.

        ``batch`` is one fixed batch or an iterator pulled once per step.
        ``device_loop=K`` runs up to K steps per chunk, chunks clipped to
        the next save boundary so no periodic save is skipped, and fires
        ``on_step`` once per chunk with the post-chunk step."""
        is_iter = hasattr(batch, "__next__")
        pull = (lambda: next(batch)) if is_iter else (lambda: batch)
        device_loop = max(1, int(device_loop))

        def chunk_size(remaining: int) -> int:
            k = min(device_loop, remaining)
            if self.manager is not None and self.every:
                k = min(k, self.every - (self._step % self.every))
            return max(1, k)

        def run_chunk(state, remaining: int):
            k = chunk_size(remaining)
            for _ in range(k):
                state, m = trainer.step(state, pull())
                self._record(m)
            self.advance(state, loss=m["loss"], n=k)
            self.poll_cadence_directive()
            if on_step is not None:
                on_step(self._step)
            return state, m, k

        state = self.restore_or_init(trainer, seed)
        try:
            remaining = self.timed_steps(steps)
            state, m = trainer.step(state, pull())  # warmup: first launches, builds
            self._record(m)
            self.advance(state, loss=m["loss"])
            if on_step is not None:
                on_step(self._step)
            float(m["loss"])  # host fetch: the device has finished the warmup
            timed = remaining
            t0 = time.perf_counter()
            while remaining > 0:
                state, m, k = run_chunk(state, remaining)
                remaining -= k
            loss = float(m["loss"])  # waits for the last step
            step_s = (time.perf_counter() - t0) / timed if timed else None
            if not math.isfinite(loss):
                # not checkpointed: a diverged state would poison every resume
                raise AssertionError(f"non-finite loss {loss}")
        except BaseException:
            self._fence_quietly()
            raise
        self.final(state)
        return state, loss, timed, step_s
