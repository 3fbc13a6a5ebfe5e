"""Distributed MNIST on the port: the operator's dist_mnist analogue.

Port of ``tf_operator_tpu/workloads/mnist.py``: an MLP ``[in, hidden,
10]`` (ReLU between, He-normal weights, zero biases) trained with
integer-label softmax cross-entropy and SGD with momentum 0.9 through the
port's ``Trainer``, data-parallel over the job's mesh (each rank its rows
of the global batch, the loss the global batch's mean, the gradients
summed over the data axes). The products are plain ``torch.matmul``: no
kernel of the JAX package's sits on this path.

Two data modes, as in the JAX workload:

- ``data_dir`` set: MNIST idx files (``.gz`` accepted) through
  ``MnistIdxDataset`` and the ``DeviceLoader``, each rank reading its
  stride of the examples; ``epochs`` over the global example count, then
  test-split accuracy on the host (``_np_accuracy``), reported through
  ``ctx.report_eval_metrics`` by rank 0, and the ``target_accuracy`` gate.
- no ``data_dir``: synthetic Gaussian class blobs, ``steps`` steps; the
  loss must fall.

Workload keys: data_dir, steps (synthetic) / epochs (idx), batch_size
(global), lr, hidden, target_accuracy, and the port's ``device`` (default
``cuda``). The context is reached by its attributes (``workload``,
``num_processes``, ``process_id``, ``coordinator_address``,
``mesh_axes``, ``report_eval_metrics``); a lost peer exits 138.

Declared differences: the synthetic blobs come from numpy
(``np.random.default_rng(42)`` for the centroids, ``default_rng([42,
step])`` for a step's labels and noise; JAX draws them from
``PRNGKey(42)``), and the init from a CPU ``torch.Generator`` seeded 0
(JAX: ``PRNGKey(0)``), the same values on the card and the CPU;
``params_from_jax`` carries JAX's ``init_params`` into the port for the
parity tests.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.parallel import collectives as coll
from tf_operator_tpu_torch.parallel.sharding import MeshPlan
from tf_operator_tpu_torch.rendezvous import context as rdv
from tf_operator_tpu_torch.train.data import DeviceLoader, MnistIdxDataset
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig

log = logging.getLogger("tpujob.mnist")

SYNTHETIC_DIM = 784
CLASSES = 10


def init_params(gen: torch.Generator, sizes: Sequence[int]) -> list:
    """[(w, b)] a layer on the generator's device: w He-normal
    ``N(0, 2 / n_in)``, b zeros. The weights are drawn on the CPU from a
    generator with ``gen``'s seed, so a run on the card starts from the
    same values as one on the CPU."""
    host = torch.Generator().manual_seed(gen.initial_seed())
    params = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((n_in, n_out), generator=host, dtype=torch.float32) * (2.0 / n_in) ** 0.5
        params.append((w.to(gen.device),
                       torch.zeros((n_out,), dtype=torch.float32, device=gen.device)))
    return params


def params_from_jax(pairs, device: DeviceLike = None) -> list:
    """JAX's ``init_params`` list of (w, b) (numpy or jax arrays) as the
    port's params on ``device``, bit for bit."""
    dev = resolve_device(device)
    return [tuple(torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev)
                  for a in pair) for pair in pairs]


def forward(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in params[:-1]:
        h = torch.relu(torch.matmul(h, w) + b)
    w, b = params[-1]
    return torch.matmul(h, w) + b


def loss_fn(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    logp = torch.log_softmax(forward(params, x), dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def _np_accuracy(params, images, labels) -> float:
    """Host-side accuracy: a numpy forward of the (replicated) params."""
    h = images.reshape(images.shape[0], -1)
    mats = [(np.asarray(w), np.asarray(b)) for w, b in params]
    for w, b in mats[:-1]:
        h = np.maximum(h @ w + b, 0.0)
    w, b = mats[-1]
    pred = np.argmax(h @ w + b, axis=-1)
    return float((pred == labels).mean())


def synthetic_centroids() -> np.ndarray:
    return (np.random.default_rng(42).standard_normal((CLASSES, SYNTHETIC_DIM)) * 2.0
            ).astype(np.float32)


def synthetic_batch(centroids: np.ndarray, step: int, batch: int) -> tuple:
    """Step ``step``'s global batch of class blobs: (x [b, 784] f32, y [b]
    int64)."""
    rng = np.random.default_rng([42, int(step)])
    y = rng.integers(0, CLASSES, batch)
    x = centroids[y] + 0.1 * rng.standard_normal((batch, SYNTHETIC_DIM)).astype(np.float32)
    return x.astype(np.float32), y


def mnist_trainer(wl: dict, sizes: Sequence[int], device: torch.device, mesh=None) -> Trainer:
    """SGD with momentum 0.9 at ``lr``, no clip; under a mesh the params are
    replicated and the loss is the global batch's mean."""
    def loss(params, batch, extra):
        out = loss_fn(params, *batch)
        if mesh is not None:
            out = coll.all_reduce_mean(out, mesh, MeshPlan(mesh).data_axes)
        return out

    return Trainer(loss_fn=loss, init_fn=lambda gen: init_params(gen, sizes),
                   config=TrainerConfig(optimizer="sgd", learning_rate=float(wl.get("lr", 0.1)),
                                        momentum=0.9, grad_clip=None),
                   device=device, mesh=mesh)


@dataclass
class MnistRun:
    """What one run gives back: every step's loss, the params, and for the
    idx mode the test accuracy."""

    losses: List[float]
    params: Any
    steps: int
    accuracy: Optional[float] = None
    test_n: int = 0


def run_mnist(wl: dict, device: DeviceLike = None, mesh=None, ctx=None) -> MnistRun:
    """Train as the workload does (``data_dir`` picks the idx mode) and
    apply its gates; ``device`` overrides the workload's ``device`` key."""
    dev = resolve_device(device if device is not None else wl.get("device", "cuda"))
    global_batch = int(wl.get("batch_size", 256))
    hidden = int(wl.get("hidden", 128))
    plan = None if mesh is None else MeshPlan(mesh)
    rank, n_data = (0, 1) if plan is None else (plan.data_index, plan.data_size)
    if global_batch % n_data:
        raise ValueError(f"batch_size {global_batch} % {n_data} processes != 0")
    if wl.get("data_dir"):
        return _train_real(wl, dev, mesh, ctx, global_batch, hidden, rank, n_data)

    log.info("no data_dir: training on SYNTHETIC gaussian class blobs")
    steps = max(2, int(wl.get("steps", 30)))
    trainer = mnist_trainer(wl, [SYNTHETIC_DIM, hidden, CLASSES], dev, mesh)
    state = trainer.init(0)
    centroids = synthetic_centroids()
    losses = []
    for step in range(steps):
        x, y = synthetic_batch(centroids, step, global_batch)
        if plan is not None:
            x, y = plan.data_rows(x), plan.data_rows(y)
        state, m = trainer.step(state, (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)))
        losses.append(m["loss"])
        if step % 10 == 0:
            log.info("step %d loss %.4f", step, float(m["loss"]))
    losses = [float(x) for x in losses]
    first, last = losses[0], losses[-1]
    log.info("mnist done (synthetic): loss %.4f -> %.4f over %d steps", first, last, steps)
    if not last < first:
        raise AssertionError(f"loss did not decrease: {first} -> {last}")
    return MnistRun(losses=losses, params=state.params, steps=steps)


def _train_real(wl: dict, dev: torch.device, mesh, ctx, global_batch: int, hidden: int,
                rank: int, n_data: int) -> MnistRun:
    """idx files -> DeviceLoader -> data-parallel SGD -> host test accuracy
    -> ``report_eval_metrics`` (rank 0) and the target gate."""
    data_dir = wl["data_dir"]
    epochs = max(1, int(wl.get("epochs", 10)))
    target = float(wl.get("target_accuracy", 0.0))
    ds = MnistIdxDataset(data_dir, global_batch // n_data, split="train", seed=rank,
                         rank=rank, world_size=n_data)
    in_dim = int(np.prod(ds.arrays["image"].shape[1:]))
    trainer = mnist_trainer(wl, [in_dim, hidden, CLASSES], dev, mesh)
    state = trainer.init(0)
    # from the global example count: every rank runs the same step count
    steps_per_epoch = max(1, ds.global_n // global_batch)
    total = epochs * steps_per_epoch
    log_every = max(1, total // 10)
    losses = []
    loader = DeviceLoader(ds, dev)
    try:
        for step in range(total):
            batch = next(loader)
            x = batch["image"].reshape(batch["image"].shape[0], -1)
            state, m = trainer.step(state, (x, batch["label"]))
            losses.append(m["loss"])
            if step % log_every == 0:
                log.info("step %d/%d loss %.4f", step, total, float(m["loss"]))
    finally:
        loader.close()
    losses = [float(x) for x in losses]
    test = MnistIdxDataset(data_dir, batch_size=1, split="test", shuffle=False,
                           process_shard=False)
    host_params = [tuple(t.detach().cpu().numpy() for t in pair) for pair in state.params]
    acc = _np_accuracy(host_params, test.arrays["image"], test.arrays["label"].astype(np.int64))
    log.info("mnist done (real data): test accuracy %.4f over %d examples "
             "(%d epochs, final loss %.4f)", acc, test.n, epochs, losses[-1])
    report = getattr(ctx, "report_eval_metrics", None)
    if report is not None and rdv.process_id(ctx) == 0:
        report(total, {"accuracy": acc})
    if target and acc < target:
        raise AssertionError(f"test accuracy {acc:.4f} below target {target} — real-data "
                             "training regressed")
    return MnistRun(losses=losses, params=state.params, steps=total, accuracy=acc,
                    test_n=test.n)


@rdv.retry_on_peer_loss
def main(ctx) -> None:
    wl = ctx.workload
    dev = rdv.local_device(ctx, wl.get("device", "cuda"))
    mesh = rdv.build_mesh(ctx, dev) if rdv.initialize_distributed(ctx, dev) else None
    try:
        run_mnist(wl, dev, mesh=mesh, ctx=ctx)
    finally:
        rdv.leave_gang()
