"""ResNet training workload on the port (operator-launchable).

Port of ``tf_operator_tpu/workloads/resnet.py``: trains a ResNet variant
with the single-device Trainer (SGD, momentum 0.9, no clip) on one fixed
synthetic batch and logs the JAX workload's line: loss, step ms,
images/s and MFU (``resnet_train_flops``, 3x the forward). The operator
launches ``tf_operator_tpu_torch.workloads.resnet:main`` like any
entrypoint; ``main`` uses the context only through its attributes
(``workload``, ``num_processes``, and the checkpointer's optional ones).
Checkpoints hold the BN running statistics as ``extra``; a job whose
checkpoints already cover its budget returns at once, a restarted one
resumes from its latest checkpoint.

Workload keys: the JAX workload's (steps, batch_size, image_size,
num_classes, lr, variant, data, device_loop, profile_dir, checkpoint_dir,
checkpoint_every, checkpoint_keep, checkpoint_async, checkpoint_backend)
plus ``device`` (default ``cuda``). As in the JAX package,
``ResNetConfig.fused_1x1`` is not a workload key: ``run_resnet(wl,
cfg=...)`` takes a config that overrides the one built from ``wl``, as
``bench.py`` sets it. Declared differences from the JAX workload:

- ``data: fixed`` draws its images with
  ``np.random.RandomState(1).standard_normal`` and its labels with
  ``np.random.RandomState(2).randint``, where JAX uses ``PRNGKey(1)`` and
  ``PRNGKey(2)``; init draws from a ``torch.Generator`` seeded 0.
- ``main`` hands its job context to the checkpointer (depot push, peer
  prefetch, save and restore spans), as the LM workload does; the JAX
  ResNet workload hands it none.
- Not ported yet, and raising: ``data: stream`` and ``data: idx`` (ROADMAP
  M5), ``checkpoint_backend: orbax`` (``auto`` means npy), more than one
  process (M8). The eval scorer (``make_test_accuracy``) comes with the
  ``idx`` path and the eval role (M9).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.models.resnet import ResNetConfig, init_resnet, resnet_forward
from tf_operator_tpu_torch.train.checkpoint import WorkloadCheckpointer
from tf_operator_tpu_torch.train.metrics import mfu, resnet_train_flops
from tf_operator_tpu_torch.train.profile import profile_ctx
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState

log = logging.getLogger("tpujob.resnet")


def resnet_config_from_workload(wl: dict) -> ResNetConfig:
    """ResNetConfig from the workload dict: ``variant`` (resnet50, resnet18
    or tiny) with ``num_classes``."""
    classes = int(wl.get("num_classes", 1000))
    variant = wl.get("variant", "resnet50")
    return {
        "resnet50": ResNetConfig.resnet50,
        "resnet18": ResNetConfig.resnet18,
        "tiny": ResNetConfig.tiny,
    }[variant](classes)


def fixed_batch(batch: int, image_size: int, classes: int, device):
    """The ``data: fixed`` batch (a declared difference: numpy, not
    jax.random): f32 images [b, s, s, 3] and int64 labels [b]."""
    images = np.random.RandomState(1).standard_normal(
        (batch, image_size, image_size, 3)).astype(np.float32)
    labels = np.random.RandomState(2).randint(0, classes, (batch,))
    return torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)


def resnet_loss(params, batch, state, cfg: ResNetConfig):
    """Mean cross-entropy of a train-mode forward, and the new BN state."""
    images, labels = batch
    logits, new_state = resnet_forward(params, state, images, cfg, train=True)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean(), new_state


@dataclass
class ResNetRun:
    """What one run of the workload gives back."""

    cfg: ResNetConfig
    trainer: Trainer
    state: TrainState
    batch: tuple
    loss: float
    losses: List[float]  # every step's loss, warmup included
    timed: int
    step_s: Optional[float]
    images_per_step: int
    device: torch.device
    flops: float  # model FLOPs a step (resnet_train_flops)

    @property
    def images_per_s(self) -> Optional[float]:
        return self.images_per_step / self.step_s if self.step_s else None

    def mfu(self) -> Optional[float]:
        """MFU against the card's peak; None off CUDA or untimed."""
        if self.step_s is None or self.device.type != "cuda":
            return None
        return mfu(self.flops, self.step_s, 1, self.device)


def run_resnet(wl: dict, device: DeviceLike = None,
               cfg: Optional[ResNetConfig] = None,
               ckpt: Optional[WorkloadCheckpointer] = None) -> ResNetRun:
    """Build the model from ``wl`` (or take ``cfg``), train ``steps`` timed
    steps after one warmup step (from the latest checkpoint, when
    ``checkpoint_dir`` holds one), and return a ResNetRun. ``device``
    overrides the workload's ``device`` key (default ``cuda``); ``ckpt``
    is the checkpointer to use (by default one built from ``wl``)."""
    dev = resolve_device(device if device is not None else wl.get("device", "cuda"))
    steps = max(2, int(wl.get("steps", 20)))
    batch = int(wl.get("batch_size", 128))
    image_size = int(wl.get("image_size", 224))
    classes = int(wl.get("num_classes", 1000))
    cfg = cfg if cfg is not None else resnet_config_from_workload(wl)
    data_mode = wl.get("data", "fixed")
    if data_mode in ("stream", "idx"):
        raise NotImplementedError(f"data: {data_mode!r} is not ported yet (ROADMAP M5)")
    ckpt = ckpt if ckpt is not None else WorkloadCheckpointer(wl)
    trainer = Trainer(
        loss_fn=lambda params, data, state: resnet_loss(params, data, state, cfg),
        init_fn=lambda gen: init_resnet(cfg, gen, dev),
        config=TrainerConfig(optimizer="sgd", learning_rate=float(wl.get("lr", 0.1)),
                             grad_clip=None),
        device=dev,
    )
    data = fixed_batch(batch, image_size, classes, dev)
    with profile_ctx(wl.get("profile_dir")):
        state, loss, timed, step_s = ckpt.run_loop(
            trainer, 0, data, steps, device_loop=int(wl.get("device_loop", 1)))
    return ResNetRun(
        cfg=cfg, trainer=trainer, state=state, batch=data, loss=loss,
        losses=[float(x) for x in ckpt.step_losses], timed=timed, step_s=step_s,
        images_per_step=batch, device=dev,
        flops=resnet_train_flops(cfg.flops_per_image(image_size), batch),
    )


def main(ctx) -> None:
    wl = ctx.workload
    if int(getattr(ctx, "num_processes", 1) or 1) > 1:
        raise NotImplementedError("multi-process training is not ported yet (ROADMAP M8)")
    ckpt = WorkloadCheckpointer(wl, ctx=ctx)
    steps = max(2, int(wl.get("steps", 20)))
    if ckpt.is_complete(steps):
        log.info("already complete (budget %d); nothing to do", steps)
        return
    run = run_resnet(wl, ckpt=ckpt)
    if run.step_s is None:
        log.info("resnet done: loss=%.4f (no timed steps remained)", run.loss)
        return
    m = run.mfu()
    log.info(
        "resnet done: loss=%.4f step=%.2fms imgs/s=%.0f mfu=%s (1 chip, %s)",
        run.loss, run.step_s * 1e3, run.images_per_s, "n/a" if m is None else f"{m:.3f}",
        torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
    )
