"""ResNet training workload on the port (operator-launchable).

Port of ``tf_operator_tpu/workloads/resnet.py``: trains a ResNet variant
with the Trainer (SGD, momentum 0.9, no clip), on one card or on each
rank of the job's mesh (the batch split over dp and fsdp, the params
replicated, batch norm synced: ``models/resnet.py``), and logs the JAX
workload's line: loss, step ms, images/s (the global batch's) and MFU
(``resnet_train_flops``, 3x the forward). The operator launches
``tf_operator_tpu_torch.workloads.resnet:main`` like any entrypoint;
``main`` uses the context only through its attributes (``workload``,
``num_processes``, ``process_id``, ``coordinator_address``,
``mesh_axes``, ``dcn_mesh_axes``, ``chips``, ``report_eval_metrics`` and
the checkpointer's optional ones); a lost peer exits 138. Under a mesh
only rank 0 logs the ``resnet done`` line, with the mesh, and every rank
an ``resnet rank`` line (losses, K8 launches, a digest of its BN state,
peak memory, collective seconds, staged bytes, checkpoint figures). Checkpoints hold the BN running
statistics as ``extra``; a job whose checkpoints already cover its budget
returns at once, a restarted one resumes from its latest checkpoint.

Data modes (workload key ``data``), as in the JAX workload:

- ``"idx"`` + ``data_dir``: real images from idx files (``train_real``):
  prepared to 3 channels and upsampled to ``image_size``, augmented
  (random crop of ``crop_padding``, ``flip``) on the loader's thread,
  trained by ``epochs`` (steps per epoch from the example count before
  sharding), checkpointed every ``checkpoint_every`` steps (a non-finite
  state is refused and the in-flight save fenced), then scored: eval-mode
  test accuracy, batches padded to ``eval_batch_size`` with the tail
  masked, reported through ``ctx.report_eval_metrics`` when the context
  has it and gated by ``target_accuracy``.
- ``"stream"``: synthetic host batches through the DeviceLoader.
- ``"fixed"`` (default): one resident synthetic batch.

Workload keys: the JAX workload's (steps, epochs, batch_size, image_size,
num_classes, lr, variant, data, data_dir, augment, crop_padding, flip,
target_accuracy, eval_batch_size, device_loop, profile_dir,
checkpoint_dir, checkpoint_every, checkpoint_keep, checkpoint_async,
checkpoint_backend) plus ``device`` (default ``cuda``). As in the JAX
package's workload, ``ResNetConfig.fused_1x1`` is set in code:
``run_resnet`` and ``train_real`` take a config that overrides the one
built from ``wl``, as ``bench.py`` sets it; the port also reads a
``fused_1x1`` workload key, so a job launched by the operator can ask for
it. Declared differences from the JAX
workload:

- ``data: fixed`` draws its images with
  ``np.random.RandomState(1).standard_normal`` and its labels with
  ``np.random.RandomState(2).randint``, where JAX uses ``PRNGKey(1)`` and
  ``PRNGKey(2)``; init draws from a ``torch.Generator`` seeded 0. The
  loaders' batches are the JAX package's byte for byte; labels arrive as
  int32 and are widened on the device.
- ``main`` hands its job context to the checkpointer (depot push, peer
  prefetch, save and restore spans), as the LM workload does; the JAX
  ResNet workload hands it none.
- ``train_real`` times its steps after the first on the host clock and
  logs each cadence line's loss one step late (no sync a step).
- Under a mesh the fixed batch is drawn whole and each rank keeps its
  data rank's rows; the loaders read as data rank of the data-rank count.
- ``train_real`` saves through the job's ``WorkloadCheckpointer`` (its
  keep, async, world tag and depot hook, and under a gang each rank's
  blocks), where the JAX workload builds a bare manager.
- Not ported yet, and raising: ``checkpoint_backend: orbax`` (``auto``
  means npy).
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import time
from dataclasses import dataclass, replace
from typing import Any, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.models.resnet import (
    ResNetConfig,
    init_resnet,
    resnet_forward,
)
from tf_operator_tpu_torch.ops import fused_linear_stats as fls
from tf_operator_tpu_torch.parallel import collectives as coll
from tf_operator_tpu_torch.parallel.mesh import mesh_shape
from tf_operator_tpu_torch.parallel.sharding import MeshPlan
from tf_operator_tpu_torch.rendezvous import context as rdv
from tf_operator_tpu_torch.train.checkpoint import WorkloadCheckpointer
from tf_operator_tpu_torch.train.data import (
    AugmentedImages,
    DeviceLoader,
    MnistIdxDataset,
    SyntheticImages,
    local_loader,
    prepare_classification_images,
)
from tf_operator_tpu_torch.train.metrics import mfu, resnet_train_flops
from tf_operator_tpu_torch.train.profile import profile_ctx
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState

log = logging.getLogger("tpujob.resnet")


def resnet_config_from_workload(wl: dict) -> ResNetConfig:
    """ResNetConfig from the workload dict: ``variant`` (resnet50, resnet18
    or tiny) with ``num_classes``, and the port's own key ``fused_1x1``
    (default off; the JAX package sets it only in code)."""
    classes = int(wl.get("num_classes", 1000))
    variant = wl.get("variant", "resnet50")
    cfg = {
        "resnet50": ResNetConfig.resnet50,
        "resnet18": ResNetConfig.resnet18,
        "tiny": ResNetConfig.tiny,
    }[variant](classes)
    return replace(cfg, fused_1x1=True) if wl.get("fused_1x1") else cfg


def fixed_batch(batch: int, image_size: int, classes: int, device):
    """The ``data: fixed`` batch (a declared difference: numpy, not
    jax.random): f32 images [b, s, s, 3] and int64 labels [b]."""
    images = np.random.RandomState(1).standard_normal(
        (batch, image_size, image_size, 3)).astype(np.float32)
    labels = np.random.RandomState(2).randint(0, classes, (batch,))
    return torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)


def resnet_loss(params, batch, state, cfg: ResNetConfig, mesh=None):
    """Mean cross-entropy of a train-mode forward, and the new BN state;
    under a mesh the global batch's mean (equal rows a rank)."""
    images, labels = batch
    logits, new_state = resnet_forward(params, state, images, cfg, train=True, mesh=mesh)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    if mesh is not None:
        plan = MeshPlan(mesh)
        loss = coll.all_reduce_mean(loss, mesh, plan.data_axes)
    return loss, new_state


@dataclass
class ResNetRun:
    """What one run of the workload gives back."""

    cfg: ResNetConfig
    trainer: Trainer
    state: TrainState
    batch: Optional[tuple]  # the fixed batch (None for real images)
    loss: float
    losses: List[float]  # every step's loss, warmup included
    timed: int
    step_s: Optional[float]
    images_per_step: int
    device: torch.device
    flops: float  # model FLOPs a step (resnet_train_flops)
    data: Optional[dict] = None  # DeviceLoader.stats() of a stream or real run
    accuracy: Optional[float] = None  # test accuracy of a real run
    eval_s: Optional[float] = None  # host s of that scoring
    mesh: Any = None  # the DeviceMesh of a sharded run

    @property
    def images_per_s(self) -> Optional[float]:
        """Images of the global batch a second."""
        return self.images_per_step / self.step_s if self.step_s else None

    @property
    def n_devices(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.mesh.numel())

    def mfu(self) -> Optional[float]:
        """MFU against the peak of the mesh's cards; None off CUDA or
        untimed."""
        if self.step_s is None or self.device.type != "cuda":
            return None
        return mfu(self.flops, self.step_s, self.n_devices, self.device)


def resnet_trainer(wl: dict, cfg: ResNetConfig, device: torch.device, mesh=None) -> Trainer:
    """The workload's Trainer: SGD (momentum 0.9) at ``lr``, no clip. Under
    a mesh it gets no logical axes, as the JAX workload's gets none, so
    every leaf is replicated (``resnet_logical_axes``' table)."""
    return Trainer(
        loss_fn=lambda params, data, state: resnet_loss(params, data, state, cfg, mesh),
        init_fn=lambda gen: init_resnet(cfg, gen, device),
        config=TrainerConfig(optimizer="sgd", learning_rate=float(wl.get("lr", 0.1)),
                             grad_clip=None),
        device=device, mesh=mesh,
    )


def bn_digest(state) -> str:
    """sha256 of the BN state's bytes, leaf by leaf in tree order: ranks
    whose running statistics agree bitwise give the same digest."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())

    walk(state)
    return h.hexdigest()


def run_resnet(wl: dict, device: DeviceLike = None,
               cfg: Optional[ResNetConfig] = None,
               ckpt: Optional[WorkloadCheckpointer] = None, mesh=None,
               on_step=None) -> ResNetRun:
    """Build the model from ``wl`` (or take ``cfg``), train ``steps`` timed
    steps after one warmup step (from the latest checkpoint, when
    ``checkpoint_dir`` holds one) on ``data: fixed`` or ``stream``, and
    return a ResNetRun. ``device`` overrides the workload's ``device`` key
    (default ``cuda``); ``ckpt`` is the checkpointer to use (by default one
    built from ``wl`` and ``mesh``); ``mesh`` splits the batch over its
    data axes; ``on_step(global_step)`` fires after every step."""
    dev = resolve_device(device if device is not None else wl.get("device", "cuda"))
    steps = max(2, int(wl.get("steps", 20)))
    batch = int(wl.get("batch_size", 128))
    image_size = int(wl.get("image_size", 224))
    classes = int(wl.get("num_classes", 1000))
    cfg = cfg if cfg is not None else resnet_config_from_workload(wl)
    data_mode = wl.get("data", "fixed")
    if data_mode not in ("fixed", "stream"):
        raise ValueError(f"run_resnet takes data: fixed or stream, not {data_mode!r} "
                         "(idx trains through train_real)")
    ckpt = ckpt if ckpt is not None else WorkloadCheckpointer(wl, mesh=mesh)
    trainer = resnet_trainer(wl, cfg, dev, mesh)
    plan = None if mesh is None else MeshPlan(mesh)
    fixed = fixed_batch(batch, image_size, classes, dev)
    if plan is not None:
        fixed = tuple(plan.data_rows(x) for x in fixed)
    loader = None
    if data_mode == "stream":
        # batch_size is global; local_loader splits it across the data
        # ranks with rank-distinct data; skip= keeps a resumed incarnation
        # from replaying the batches its checkpoint's steps consumed
        rank, world = (0, 1) if plan is None else (plan.data_index, plan.data_size)
        loader = local_loader(SyntheticImages, batch, dev, min_examples=64,
                              image_size=image_size, num_classes=classes,
                              skip=ckpt.resume_step(), rank=rank, world_size=world)
        data = ((b["image"], b["label"].long()) for b in loader)
    else:
        data = fixed
    try:
        with profile_ctx(wl.get("profile_dir")):
            state, loss, timed, step_s = ckpt.run_loop(
                trainer, 0, data, steps, on_step=on_step,
                device_loop=int(wl.get("device_loop", 1)))
    finally:
        if loader is not None:
            loader.close()
    return ResNetRun(
        cfg=cfg, trainer=trainer, state=state, batch=fixed, loss=loss,
        losses=[float(x) for x in ckpt.step_losses], timed=timed, step_s=step_s,
        images_per_step=batch, device=dev,
        flops=resnet_train_flops(cfg.flops_per_image(image_size), batch),
        data=None if loader is None else loader.stats(), mesh=mesh,
    )


# ---------------------------------------------------------------------------
# real images: idx files -> prepare -> augment -> DeviceLoader -> train -> score
# ---------------------------------------------------------------------------


def make_test_accuracy(cfg: ResNetConfig):
    """A reusable eval-mode (running BN statistics) top-1 accuracy scorer:
    ``score(params, bn_state, images, labels, eval_b=64)``. Each batch of
    numpy images is padded with zeros to ``eval_b`` (one static shape) and
    the padded rows' predictions are masked out; batches go to the
    params' device."""

    @torch.no_grad()
    def score(params, bn_state, images: np.ndarray, labels: np.ndarray,
              eval_b: int = 64) -> float:
        dev = params["head"]["w"].device
        correct = 0
        for i in range(0, len(labels), eval_b):
            x = images[i : i + eval_b]
            y = labels[i : i + eval_b]
            if x.shape[0] < eval_b:  # pad to the static shape, mask the tail
                padding = eval_b - x.shape[0]
                x = np.concatenate([x, np.zeros((padding,) + x.shape[1:], x.dtype)])
            logits, _ = resnet_forward(params, bn_state, torch.from_numpy(x).to(dev), cfg,
                                       train=False)
            pred = logits.argmax(dim=-1).cpu().numpy()[: len(y)]
            correct += int((pred == y).sum())
        return correct / len(labels)

    return score


def test_accuracy(params, bn_state, cfg: ResNetConfig, images, labels,
                  eval_b: int = 64) -> float:
    """Eval-mode top-1 accuracy, one-shot (repeat callers hold
    make_test_accuracy's scorer)."""
    return make_test_accuracy(cfg)(params, bn_state, images, labels, eval_b)


def test_split(data_dir: str, image_size: int) -> tuple:
    """The idx test split prepared for scoring: (images [n, s, s, 3] f32,
    labels [n] int32)."""
    test = MnistIdxDataset(data_dir, batch_size=1, split="test", shuffle=False,
                           process_shard=False)
    return (prepare_classification_images(test.arrays["image"], image_size),
            test.arrays["label"])


def train_real(wl: dict, device: DeviceLike = None, cfg: Optional[ResNetConfig] = None,
               ctx: Any = None, mesh=None,
               ckpt: Optional[WorkloadCheckpointer] = None) -> ResNetRun:
    """The real-image path: idx files -> prepare (3 channels, upsample) ->
    augment -> DeviceLoader -> Trainer -> periodic checkpoints -> eval-mode
    test accuracy -> ``ctx.report_eval_metrics`` (when the context has it)
    and the ``target_accuracy`` gate. Under a mesh each rank reads as its
    data rank of the data-rank count. The checkpoints go through ``ckpt``
    (by default one built from ``wl``, ``ctx`` and ``mesh``: the
    workload's keep, async and world tag, the depot hook, a gang's
    blocks)."""
    dev = resolve_device(device if device is not None else wl.get("device", "cuda"))
    cfg = cfg if cfg is not None else resnet_config_from_workload(wl)
    trainer = resnet_trainer(wl, cfg, dev, mesh)
    global_batch = int(wl.get("batch_size", 128))
    image_size = int(wl.get("image_size", 32))
    epochs = max(1, int(wl.get("epochs", 5)))
    target = float(wl.get("target_accuracy", 0.0))
    plan = None if mesh is None else MeshPlan(mesh)
    rank, n_proc = (0, 1) if plan is None else (plan.data_index, plan.data_size)
    if global_batch % n_proc:
        raise ValueError(f"batch_size {global_batch} % {n_proc} processes != 0")
    ds = MnistIdxDataset(wl["data_dir"], global_batch // n_proc, split="train", seed=rank)
    ds.arrays["image"] = prepare_classification_images(ds.arrays["image"], image_size)
    source = ds
    if wl.get("augment", True):
        source = AugmentedImages(
            ds, pad=int(wl.get("crop_padding", 4)),
            # digits and text are orientation-sensitive; natural-image
            # recipes opt in with flip: true
            flip=bool(wl.get("flip", False)), seed=rank,
        )
    state = trainer.init(0)
    loader = DeviceLoader(source, dev)
    # periodic checkpoints, params and BN statistics: the Evaluator role
    # scores them as they land (workloads/eval.py, model "resnet")
    ckpt = ckpt if ckpt is not None else WorkloadCheckpointer(wl, ctx=ctx, mesh=mesh)
    every = int(wl.get("checkpoint_every", 0))
    mgr = ckpt.manager
    if mgr is not None:
        trainer.bind_checkpoints(mgr)
    # the example count before sharding: the same step count on every rank
    steps_per_epoch = max(1, ds.global_n // global_batch)
    total = epochs * steps_per_epoch
    log_every = max(1, total // 10)

    def checkpoint(step, state, m, wait=False):
        # a diverged state would hand the Evaluator a poisoned latest
        # checkpoint: refuse it, and fence the in-flight save before the
        # caller raises and exits
        cur = float(m["loss"])
        if not math.isfinite(cur):
            log.warning("skipping checkpoint at step %d: loss %r", step, cur)
            mgr.wait_until_finished()
            return
        ckpt.save(step, state, wait=wait)

    losses: list = []
    t0 = None
    try:
        for step in range(total):
            batch = next(loader)
            state, m = trainer.step(state, (batch["image"], batch["label"].long()))
            losses.append(m["loss"])
            if step == 0:
                float(m["loss"])  # the first step (kernel builds, autotuning) is untimed
                t0 = time.perf_counter()
            if mgr and every and (step + 1) % every == 0:
                checkpoint(step + 1, state, m)
            if step and (step - 1) % log_every == 0:  # the step before, now done
                log.info("step %d/%d loss %.4f", step - 1, total, float(losses[step - 1]))
        loss = float(m["loss"])
        step_s = (time.perf_counter() - t0) / (total - 1) if total > 1 else None
        if (total - 1) % log_every == 0:
            log.info("step %d/%d loss %.4f", total - 1, total, loss)
        if mgr:
            checkpoint(total, state, m, wait=True)
    finally:
        loader.close()
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite training loss {loss}")
    t1 = time.perf_counter()
    images, labels = test_split(wl["data_dir"], image_size)
    acc = test_accuracy(state.params, state.extra, cfg, images, labels,
                        eval_b=int(wl.get("eval_batch_size", 64)))
    eval_s = time.perf_counter() - t1
    log.info("resnet done (real data): test accuracy %.4f over %d examples "
             "(%d epochs, final loss %.4f)", acc, len(labels), epochs, loss)
    report = getattr(ctx, "report_eval_metrics", None)
    if report is not None and int(getattr(ctx, "process_id", 0) or 0) == 0:
        report(total, {"accuracy": acc})
    if target and acc < target:
        raise AssertionError(
            f"test accuracy {acc:.4f} below target {target} — real-image "
            "training regressed")
    return ResNetRun(
        cfg=cfg, trainer=trainer, state=state, batch=None, loss=loss,
        losses=[float(x) for x in losses], timed=total - 1, step_s=step_s,
        images_per_step=global_batch, device=dev,
        flops=resnet_train_flops(cfg.flops_per_image(image_size), global_batch),
        data=loader.stats(), accuracy=acc, eval_s=eval_s, mesh=mesh,
    )


def rank_line(run: ResNetRun, rank: int, ckpt: Optional[WorkloadCheckpointer] = None) -> dict:
    """What one rank of a run reports: its losses, its K8 launches (warmup
    included), a digest of its BN state, peak memory, host seconds in
    collectives, the bytes it staged through the host, and with ``ckpt``
    its checkpoint figures."""
    on_card = run.device.type == "cuda"
    return {"rank": rank, "losses": run.losses,
            "step_ms": None if run.step_s is None else run.step_s * 1e3,
            "fused_linear_stats_launches": fls.fused_linear_stats_launches,
            "bn_state_sha256": bn_digest(run.state.extra),
            "peak_gb": torch.cuda.max_memory_allocated(run.device) / 1e9 if on_card else None,
            "collective_s": coll.collective_s, "collective_calls": coll.collective_calls,
            "staged_bytes": coll.staged_bytes,
            "checkpoint": None if ckpt is None else ckpt.report()}


@rdv.retry_on_peer_loss
def main(ctx) -> None:
    wl = ctx.workload
    dev = rdv.local_device(ctx, wl.get("device", "cuda"))
    mesh = rdv.build_mesh(ctx, dev) if rdv.initialize_distributed(ctx, dev) else None
    rank = rdv.process_id(ctx)
    # under a gang every rank reads the chief's latest step
    ckpt = WorkloadCheckpointer(wl, ctx=ctx, mesh=mesh)
    steps = max(2, int(wl.get("steps", 20)))
    if ckpt.is_complete(steps):
        log.info("already complete (budget %d); nothing to do", steps)
        rdv.leave_gang()
        return
    if wl.get("data") == "idx":
        run = train_real(wl, device=dev, ctx=ctx, mesh=mesh, ckpt=ckpt)
    else:
        run = run_resnet(wl, device=dev, ckpt=ckpt, mesh=mesh)
    if mesh is not None:
        log.info("resnet rank: %s", json.dumps(rank_line(run, rank, ckpt)))
        rdv.leave_gang()
        if rank != 0:
            return
    if run.step_s is None:
        log.info("resnet done: loss=%.4f (no timed steps remained)", run.loss)
        return
    m = run.mfu()
    log.info(
        "resnet done: loss=%.4f step=%.2fms imgs/s=%.0f mfu=%s (%d chip%s, %s)%s",
        run.loss, run.step_s * 1e3, run.images_per_s,
        "n/a" if m is None else f"{m:.3f}", run.n_devices, "" if run.n_devices == 1 else "s",
        torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
        "" if run.mesh is None else f" mesh={mesh_shape(run.mesh)}",
    )
