"""Checkpoint/resume: step-indexed npy checkpoints and the workload step loop.

Port of ``tf_operator_tpu/train/checkpoint.py``'s npy backend and of
``WorkloadCheckpointer``. A gang restart (the controller deletes and
recreates every process after a retryable failure) resumes from the last
saved step instead of step 0.

On disk a step is the JAX package's npy layout, leaf for leaf: one
``leaf_{i}.npy`` per leaf plus a ``manifest.json`` that lists each leaf's
``path`` (``jax.tree_util.keystr`` of the JAX package's tree), index,
shape and dtype, and the writing world size. A checkpoint written by
either package restores into the other. The port's ``TrainState`` maps
onto the JAX wire tree ``{"extra", "opt_state", "params", "step"}``:
params and extra keep their trees, ``step`` is an int32 scalar, and the
optimizer state takes optax's layout for the same config, which the
state's ``OptState.chain`` describes (``train/trainer.py``): for the LM
trainer's ``chain(clip_by_global_norm, adamw)``
``['opt_state'][1][0].count``, ``['opt_state'][1][0].mu[...]``,
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

Declared differences from the JAX package:

- Only the npy backend exists: ``backend="auto"`` means npy, and
  ``"orbax"`` raises.
- The writing world size defaults to 1. With more than one process the
  npy backend refuses to save, as JAX's does, and ``WorkloadCheckpointer``
  refuses a ``checkpoint_dir`` (multi-process checkpoints are ROADMAP
  Queue 1 item 5).
- ``restore`` takes ``device=``: a template may hold meta tensors (shape
  and dtype only, as ``Trainer.state_template`` returns), and the leaves
  then land on ``device``; otherwise each lands on its template leaf's
  device.
- ``WorkloadCheckpointer.run_loop`` runs a chunk of ``device_loop`` steps
  as a Python loop and warms up with one step (eager PyTorch compiles
  nothing), and a loop left by an exception (fault injection's retryable
  exit included) fences the in-flight save before it propagates, so an
  accepted save commits before the process exits.
"""

from __future__ import annotations

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


def _write_npy_chunked(path: str, arr: np.ndarray, dtype_name: str, chunk_bytes: int) -> None:
    """An np.save-compatible .npy of a host array, its body written in
    ``chunk_bytes`` quanta."""
    arr = np.asarray(arr)
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        _npy_header(f, dtype_name, arr.shape, arr.dtype)
        mv = memoryview(arr.reshape(-1).view(np.uint8))
        for off in range(0, len(mv), chunk_bytes):
            f.write(mv[off:off + chunk_bytes])


def _load_leaf(path: str, rec: dict) -> np.ndarray:
    """A saved leaf as numpy: bfloat16 (raw V2 bytes) comes back as int16,
    to be viewed as bfloat16 on the torch side."""
    arr = np.load(path)
    if rec.get("dtype") == "bfloat16":
        return arr.view(np.int16)
    if "dtype" in rec and arr.dtype != np.dtype(rec["dtype"]):
        arr = arr.view(np.dtype(rec["dtype"]))
    return arr


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
            (best-effort: its exceptions are logged).
        world_size: stamped into each manifest (None means 1) and expected
            at restore; a manifest of another world refuses to restore
            unless ``allow_world_resize``.

    ``last_save_stall_s`` after each accepted save is the wall time the
    caller was blocked.
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
        self.last_save_stall_s = 0.0
        self._drain: Optional[threading.Thread] = None
        self._drain_step: Optional[int] = None
        self._drain_error: Optional[BaseException] = None
        self._pinned: Optional[torch.Tensor] = None  # the drain's host buffer
        # Test seam: called as _fault_hook(phase, step) with phase in
        # {"leaf", "manifest", "commit"} from inside the drain.
        self._fault_hook: Optional[Callable[[str, int], None]] = None
        os.makedirs(self.directory, exist_ok=True)
        if not self.readonly:
            # Sweep partial-save orphans of crashed writers (their pid is
            # gone); skip our own pid, whose drain may be live in one.
            for name in os.listdir(self.directory):
                if name.startswith(".tmp_step_") and not name.endswith(f"_{os.getpid()}"):
                    shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

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

    def reload(self) -> None:
        """Nothing to re-read: npy discovery scans the directory each call."""

    # ---- save -----------------------------------------------------------

    def save(self, step: int, state: Any, wait: bool = False) -> bool:
        """Save ``state`` (TrainState or pytree) at ``step``. True when
        written or accepted, False when the step already exists.
        ``wait=True`` fences even a rejected duplicate, which may be the
        in-flight write itself."""
        if self.readonly:
            raise RuntimeError("CheckpointManager is readonly; refusing to save")
        step = int(step)
        processes = gang_size()
        if processes > 1:
            # as the JAX package's _npy_save: N processes racing on one tmp
            # dir would corrupt the rename; multi-process saves are ROADMAP
            # Queue 1 item 5 (the orbax backend is not ported)
            raise RuntimeError("npy checkpoint backend is single-process only "
                               f"(process_count={processes})")
        tree = _to_tree(state)
        t0 = time.perf_counter()
        try:
            if self.async_save:
                accepted = self._npy_save_async(step, tree)
                if wait:
                    self.wait_until_finished()
                return accepted
            return self._npy_save(step, tree)
        finally:
            self.last_save_stall_s = time.perf_counter() - t0

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
            raise RuntimeError(
                f"async checkpoint drain failed (step never committed): {err}") from err

    def _writer_world_size(self) -> int:
        return int(self.world_size) if self.world_size else 1

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

    def _commit(self, tmp: str, step: int, manifest: Dict[str, Any], drain: bool) -> bool:
        """Write the manifest (the commit marker) last, rename tmp into
        place, prune and fire on_commit. False when another writer won.
        The async drain fsyncs the manifest before the rename, and calls
        the fault hook between the two."""
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

    def _npy_save(self, step: int, tree: Any) -> bool:
        final = os.path.join(self.directory, f"step_{step}")
        if os.path.exists(final):
            return False
        tmp = os.path.join(self.directory, f".tmp_step_{step}_{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "world_size": self._writer_world_size(),
                                    "leaves": []}
        for i, (path, leaf) in enumerate(_flatten(tree)):
            _write_npy_chunked(os.path.join(tmp, f"leaf_{i}.npy"), _host_array(leaf),
                               _dtype_name(leaf), self.chunk_bytes)
            manifest["leaves"].append(self._record(path, i, leaf))
        return self._commit(tmp, step, manifest, drain=False)

    # -- the async pipeline -----------------------------------------------

    def _npy_save_async(self, step: int, tree: Any) -> bool:
        """Stage, then hand the copies to a drain thread. A duplicate step
        returns before fencing the previous drain."""
        if step in self.all_steps():
            return False
        self.wait_until_finished()  # at most one drain in flight
        if step in self.all_steps():
            return False
        leaves = _flatten(tree)
        staged, event = _stage_leaves([leaf for _, leaf in leaves])
        records = [self._record(path, i, leaf) for i, (path, leaf) in enumerate(leaves)]
        self._drain_step = step
        self._drain = threading.Thread(
            target=self._npy_drain, args=(step, staged, records, event), daemon=True,
            name=f"ckpt-drain-{step}")
        self._drain.start()
        return True

    def _npy_drain(self, step: int, staged: list, records: list, event) -> None:
        """The background half of the async save: nothing before the final
        rename is discoverable, so a failure anywhere leaves an orphan, and
        each staging copy is released once its leaf is on the host."""
        tmp = os.path.join(self.directory, f".tmp_step_{step}_{os.getpid()}")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            stream = None
            if event is not None:
                event, device = event
                stream = torch.cuda.Stream(device)
                stream.wait_event(event)
            for i, rec in enumerate(records):
                if self._fault_hook is not None:
                    self._fault_hook("leaf", step)
                leaf, staged[i] = staged[i], None
                path = os.path.join(tmp, f"leaf_{rec['index']}.npy")
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    self._drain_cuda_leaf(path, leaf, rec, stream)
                else:
                    _write_npy_chunked(path, _host_array(leaf), rec["dtype"], self.chunk_bytes)
                del leaf  # release the staging copy
            if self._fault_hook is not None:
                self._fault_hook("manifest", step)
            manifest = {"step": step, "world_size": self._writer_world_size(),
                        "leaves": records}
            self._commit(tmp, step, manifest, drain=True)
        except BaseException as exc:  # noqa: BLE001 — surfaced at the next fence
            shutil.rmtree(tmp, ignore_errors=True)
            self._drain_error = exc
            log.warning("async checkpoint drain for step %d failed: %s", step, exc)

    def _drain_cuda_leaf(self, path: str, leaf: torch.Tensor, rec: dict, stream) -> None:
        """One staged card leaf to disk: ``chunk_bytes`` pieces copied on
        the drain's stream into the reused pinned buffer, each written
        once the copy lands."""
        if self._pinned is None:
            self._pinned = torch.empty(self.chunk_bytes, dtype=torch.uint8, pin_memory=True)
        buf = self._pinned
        host = buf.numpy()
        flat = leaf.reshape(-1).view(torch.uint8)
        host_dtype = np.dtype(np.int16) if rec["dtype"] == "bfloat16" else \
            np.dtype(rec["dtype"])
        with open(path, "wb") as f:
            _npy_header(f, rec["dtype"], tuple(rec["shape"]), host_dtype)
            for off in range(0, flat.numel(), self.chunk_bytes):
                n = min(self.chunk_bytes, flat.numel() - off)
                with torch.cuda.stream(stream):
                    buf[:n].copy_(flat[off:off + n], non_blocking=True)
                stream.synchronize()
                f.write(memoryview(host[:n]))

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
        """Restore the checkpoint at ``step`` (default: latest) onto the
        shapes and dtypes of ``template`` (a TrainState or pytree). Raises
        FileNotFoundError if there is none."""
        self.wait_until_finished()  # read-your-own-writes under async save
        if step is None:
            step = self.latest_step()
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
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        out = self._npy_restore(int(step), dict(templates), subtrees=tuple(templates),
                                device=device)
        return {k: out[k] for k in templates}

    def _npy_restore(self, step: int, tmpl_tree: Any, subtrees: Optional[tuple] = None,
                     device: Optional[torch.device] = None) -> Any:
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
        out = []
        for (path, tmpl_leaf), rec in zip(leaves, records):
            tmpl_shape, tmpl_dtype = _shape(tmpl_leaf), _dtype_name(tmpl_leaf)
            if tuple(rec["shape"]) != tmpl_shape or rec["dtype"] != tmpl_dtype:
                raise ValueError(
                    f"checkpoint leaf {rec['path']} at step {step} is "
                    f"{rec['dtype']}{tuple(rec['shape'])} but the restore "
                    f"template expects {tmpl_dtype}{tmpl_shape} — model/"
                    "optimizer config changed between save and restore")
            arr = _load_leaf(os.path.join(d, f"leaf_{rec['index']}.npy"), rec)
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
        return _unflatten(tmpl_tree, iter(out))

    def close(self) -> None:
        self.wait_until_finished()  # fence the drain before exit


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


def gang_size() -> int:
    """The process group's world size, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


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
    where the trainer reports one (device scalars, read after the loop)."""

    def __init__(self, workload: Dict[str, Any], ctx=None) -> None:
        self.ctx = ctx
        self.manager: Optional[CheckpointManager] = None
        processes = max(gang_size(), int(getattr(ctx, "num_processes", 1) or 1))
        if workload.get("checkpoint_dir") and processes > 1:
            raise NotImplementedError(
                f"checkpoints of a {processes}-process job are not ported yet (ROADMAP Queue 1 "
                "item 5); a multi-process job trains without checkpoint_dir")
        if workload.get("checkpoint_dir"):
            self.manager = CheckpointManager(
                workload["checkpoint_dir"],
                keep=int(workload.get("checkpoint_keep", 3)),
                backend=str(workload.get("checkpoint_backend", "auto")),
                async_save=bool(workload.get("checkpoint_async", True)),
                on_commit=self._push_to_depot,
                world_size=getattr(ctx, "num_processes", None),
                allow_world_resize=bool(workload.get("elastic")),
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
        re-run over the rest before disk. Returns "peer" or "disk"."""
        if self.manager is None:
            return "disk"
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
                remaining, self.ctx.namespace, self.ctx.job_name, disk_step, client=client)
            if source != "peer":
                return "disk"
            if client.fetch_step(url, self.ctx.namespace, self.ctx.job_name, step,
                                 self.manager.directory) is not None:
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
        """Latest checkpointed step (0 if none), without restoring."""
        if self.manager is not None:
            return self.manager.latest_step() or 0
        return 0

    def is_complete(self, steps: int) -> bool:
        """True when a previous run already trained past the budget (the +1
        is the warmup step, which also trains). Reads the directory only:
        call it before restore_or_init."""
        if self.manager is not None:
            latest = self.manager.latest_step()
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
            if self.manager.save(self._step, state):
                self._note_save_stall(self._step)

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
        (``ctx.ack_checkpoint_cadence``). The chief (process 0) alone
        polls, at most once per ``cadence_poll_s``. True when an epoch was
        applied."""
        if self.ctx is None or getattr(self.ctx, "process_id", 0) != 0:
            return False
        poll = getattr(self.ctx, "poll_checkpoint_cadence_directive", None)
        if poll is None:
            return False
        now = time.time()
        if now - self._cadence_last_poll < self._cadence_poll_s:
            return False
        self._cadence_last_poll = now
        directive = poll() or {}
        epoch = int(directive.get("epoch", 0))
        if epoch <= self._cadence_epoch:
            return False
        self._cadence_epoch = epoch
        every = int(directive.get("checkpoint_every", 0))
        if every > 0 and every != self.every:
            log.info("checkpoint cadence directive epoch %d: every %d -> %d steps",
                     epoch, self.every, every)
            self.every = every
        ack = getattr(self.ctx, "ack_checkpoint_cadence", None)
        if ack is not None:
            ack(epoch, self._step if step is None else int(step))
        return True

    def final(self, state) -> None:
        """The final save, fenced: the process may exit right after."""
        if self.manager is not None and self.manager.save(self._step, state, wait=True):
            self._note_save_stall(self._step)

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
