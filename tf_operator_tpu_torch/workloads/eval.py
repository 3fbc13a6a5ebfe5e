"""Evaluator workload on the port: score checkpoints as training produces them.

Port of ``tf_operator_tpu/workloads/eval.py``. Run as the Evaluator
replica of a training job (or as a job of its own) pointed at the
trainer's ``checkpoint_dir``: it polls the directory through a readonly
``CheckpointManager``, restores the params (and, for ResNet, the BN
running statistics) of every checkpoint it has not scored, oldest first,
scores them and writes the scores to ``eval_report`` (a JSON object from
step to score, replaced atomically). The evaluator is outside the
training gang: the checkpoint directory is its only coupling to the
trainers.

Workload keys, as in the JAX workload: model ("lm" default | "resnet"),
preset and TransformerConfig overrides (LM), variant / num_classes /
image_size / data_dir (ResNet: test-split accuracy from idx files),
checkpoint_dir (required), eval_batch_size, eval_seq_len, eval_batches,
poll_interval_s, train_steps (stop once a checkpoint at or past it is
scored; 0 scores the latest checkpoint and exits), max_wait_s (give up
when nothing new appears for that long), eval_report; plus ``device``
(default ``cuda``). The LM score is the mean cross-entropy (``ce_loss``,
not the training objective, which adds MoE router losses; for a
``causal: false`` model the masked-LM CE with the loss's fixed mask, as
the JAX Evaluator scores with its fixed key) over
``eval_batches`` batches: with ``data: memmap`` the corpus's held-out tail
(``holdout_windows`` windows of the trainer's ``seq_len``, each cut into
``eval_seq_len`` pieces), else synthetic batches. On the card each scored
checkpoint logs its restore and score seconds and the flash kernels'
launches.

Declared differences from the JAX workload: the synthetic batches are
``np.random.RandomState(10_000 + i).randint(0, vocab, (batch, seq))``,
where JAX uses ``jax.random.randint(PRNGKey(10_000 + i), ...)``, and the
masked LM's fixed mask is numpy's draw, not ``PRNGKey(0)``'s; one
device (no dp mesh); the context is read through ``getattr``, so a
context without ``report_eval_metrics`` works.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from tf_operator_tpu_torch.compat import tree_map
from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
from tf_operator_tpu_torch.train.data import TokenMemmapDataset

log = logging.getLogger("tpujob.eval")

Scorer = Tuple[Dict[str, Any], Callable[[Dict[str, Any]], Tuple[float, dict]], Callable]


def _meta(tree):
    """Shapes and dtypes only: the restore template."""
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def lm_eval_batches(wl: dict, cfg, device: torch.device) -> List[torch.Tensor]:
    """The LM scorer's batches for the model ``cfg``: ``eval_batches`` of
    [eval_batch_size, eval_seq_len] tokens (int64) on ``device``, from the
    memmap holdout or the synthetic stream. Raises where the JAX scorer
    refuses."""
    batch = int(wl.get("eval_batch_size", 8))
    seq = int(wl.get("eval_seq_len", min(cfg.max_seq, 512)))
    n_batches = max(1, int(wl.get("eval_batches", 4)))
    if wl.get("data") == "memmap" and wl.get("corpus"):
        holdout = int(wl.get("holdout_windows", 0))
        if not holdout:
            # a holdout fabricated here would read windows the trainer also
            # trained on: the disjointness contract lives in this one key
            raise ValueError(
                'eval over data="memmap" requires workload.holdout_windows '
                "(the same key the trainer uses to reserve the corpus tail "
                "— without it the trainer holds out nothing and eval would "
                "score trained-on windows)"
            )
        # the tail is carved in the trainer's window geometry; eval windows
        # longer than the trainer's would reach into trained-on tokens
        train_seq = int(wl.get("seq_len", 512))
        if seq > train_seq:
            raise ValueError(
                f"eval_seq_len={seq} > trainer seq_len={train_seq}: eval "
                "windows would extend past the reserved holdout tail into "
                "trained-on tokens; use eval_seq_len <= seq_len"
            )
        ds = TokenMemmapDataset(wl["corpus"], 1, train_seq, split="holdout",
                                holdout=holdout, shuffle=False, process_shard=False)
        per_window = train_seq // seq
        need_windows = -(-n_batches * batch // per_window)  # ceil
        if len(ds) < need_windows:
            raise ValueError(
                f"holdout_windows={holdout} yields {len(ds)} reserved "
                f"trainer windows = {len(ds) * per_window} eval windows of "
                f"{seq}; eval_batches={n_batches} x batch={batch} needs "
                f"{n_batches * batch}"
            )
        it = ds.epoch(0)
        flat: list = []
        while len(flat) < n_batches * batch:
            w = next(it)["tokens"][0]  # one trainer-sized holdout window
            flat.extend(w[i * seq:(i + 1) * seq] for i in range(per_window))
        host = [np.stack(flat[i * batch:(i + 1) * batch]) for i in range(n_batches)]
    else:
        # synthetic: a seed stream disjoint from the trainers' (they seed
        # data by rank; 10_000 and up is the evaluator's)
        host = [np.random.RandomState(10_000 + i).randint(0, cfg.vocab, (batch, seq))
                for i in range(n_batches)]
    return [torch.from_numpy(np.asarray(h)).long().to(device) for h in host]


def lm_scorer(wl: dict, device: torch.device) -> Scorer:
    """(templates, score, best): the params template, a function scoring
    restored params by the mean CE over the eval batches, and ``min``."""
    from tf_operator_tpu_torch.models.transformer import (
        init_transformer,
        lm_loss_and_metrics,
        preset_from_workload,
    )

    cfg = preset_from_workload(wl)
    eval_batches = lm_eval_batches(wl, cfg, device)
    with torch.no_grad():
        params = init_transformer(cfg, torch.Generator(device=device).manual_seed(0), device)
    templates = {"params": _meta(params)}
    del params

    @torch.no_grad()
    def score(restored):
        # cross-entropy, not the training objective: for MoE configs the
        # objective adds the router losses, which would skew comparisons
        losses = [lm_loss_and_metrics(restored["params"], tok, cfg)[1]["ce_loss"]
                  for tok in eval_batches]
        v = sum(float(x) for x in losses) / len(losses)
        return v, {"loss": v}

    return templates, score, min


def resnet_scorer(wl: dict, device: torch.device) -> Scorer:
    """(templates, score, best): params and BN-state templates, test-split
    top-1 accuracy in eval mode (which needs the running statistics), and
    ``max``."""
    from tf_operator_tpu_torch.models.resnet import init_resnet
    from tf_operator_tpu_torch.workloads.resnet import (
        make_test_accuracy,
        resnet_config_from_workload,
        test_split,
    )

    if not wl.get("data_dir"):
        raise ValueError('eval workload with model="resnet" requires '
                         "workload.data_dir (idx test split to score)")
    cfg = resnet_config_from_workload(wl)
    image_size = int(wl.get("image_size", 32))
    eval_b = int(wl.get("eval_batch_size", 64))
    images, labels = test_split(wl["data_dir"], image_size)
    with torch.no_grad():
        params, extra = init_resnet(cfg, torch.Generator(device=device).manual_seed(0), device)
    templates = {"params": _meta(params), "extra": _meta(extra)}
    del params, extra
    accuracy = make_test_accuracy(cfg)

    def score(restored):
        acc = accuracy(restored["params"], restored["extra"], images, labels, eval_b)
        return acc, {"accuracy": acc}

    return templates, score, max


def main(ctx, device: DeviceLike = None) -> None:
    """Poll, restore and score until done (see the module docstring)."""
    wl = ctx.workload
    ckpt_dir = wl.get("checkpoint_dir")
    if not ckpt_dir:
        raise ValueError("eval workload requires workload.checkpoint_dir")
    dev = resolve_device(device if device is not None else wl.get("device", "cuda"))
    model = wl.get("model", "lm")
    if model == "resnet":
        templates, score_fn, best_fn = resnet_scorer(wl, dev)
    elif model == "lm":
        templates, score_fn, best_fn = lm_scorer(wl, dev)
    else:
        raise ValueError(f'unknown eval model {model!r}; use "lm" or "resnet"')
    poll_s = float(wl.get("poll_interval_s", 2.0))
    train_steps = int(wl.get("train_steps", 0))
    max_wait_s = float(wl.get("max_wait_s", 600.0))

    # readonly: never sweep a live trainer's tmp dirs, never save
    manager = CheckpointManager(ckpt_dir, readonly=True)
    report_path = wl.get("eval_report")

    def write_report(scored):
        if not report_path:
            return
        tmp = report_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in sorted(scored.items())}, f)
        os.replace(tmp, report_path)  # atomic: readers never see a partial file

    scored: dict = {}
    pruned: set = set()  # steps that vanished mid-scan (keep-N retention)
    deadline = time.time() + max_wait_s
    done = False
    while not done:
        manager.reload()
        # every unscored checkpoint, oldest first: scoring only the latest
        # would leave gaps when the trainer saves faster than eval scores;
        # one-shot mode scores the latest and exits
        steps = manager.all_steps()
        if not train_steps:
            steps = steps[-1:]
        for step in steps:
            if step in scored or step in pruned:
                continue
            counts = (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
                      fa.flash_bwd_dkv_launches)
            t0 = time.perf_counter()
            try:
                restored = manager.restore_subtrees(templates, step=step, device=dev)
            except Exception as exc:  # noqa: BLE001
                # keep-N retention can prune a step between the scan and the
                # restore: a vanished checkpoint is a skip, not a death
                log.warning("checkpoint step=%d vanished mid-scan (%s); skipping",
                            step, exc)
                pruned.add(step)
                continue
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            scored[step], metrics = score_fn(restored)
            t2 = time.perf_counter()
            del restored
            log.info("eval: checkpoint step=%d %s", step,
                     " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            if dev.type == "cuda":
                log.info("eval timing: step=%d restore_s=%.3f score_s=%.3f value=%.9g "
                         "flash_fwd_launches=%d flash_bwd_dq_launches=%d "
                         "flash_bwd_dkv_launches=%d", step, t1 - t0, t2 - t1, scored[step],
                         fa.flash_fwd_launches - counts[0], fa.flash_bwd_dq_launches - counts[1],
                         fa.flash_bwd_dkv_launches - counts[2])
            write_report(scored)
            # surface the score where it is queryable (a context without an
            # operator API behind it reports nothing)
            report = getattr(ctx, "report_eval_metrics", None)
            if report is not None:
                report(step, metrics)
            deadline = time.time() + max_wait_s  # progress resets the clock
            if train_steps and step >= train_steps:
                done = True
                break
            if not train_steps:
                done = True  # one-shot mode: score the latest and exit
        if not done and time.time() > deadline:
            raise TimeoutError(
                f"no new checkpoint under {ckpt_dir} within {max_wait_s}s "
                f"(scored: {sorted(scored)})"
            )
        if not done:
            time.sleep(poll_s)

    best = best_fn(scored.values())
    log.info("eval done: %d checkpoints scored, best %.4f", len(scored), best)
