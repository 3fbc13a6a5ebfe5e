"""Transformer language-model training workload on the port (operator-launchable).

Port of ``tf_operator_tpu/workloads/lm.py``: trains a transformer preset
(dense or MoE under any ``moe_dispatch``, causal LM or, for ``causal:
false`` presets such as bert-base, the masked LM with its fixed mask)
with the Trainer, on one card or on each rank of the job's mesh (dp,
fsdp, ep, cp, tp and pp with ``pp_microbatches``, hybrid included: ``main``
joins the gang, builds the mesh and hands it to the trainer and the
model), on one fixed batch, synthetic
batches streamed through the DeviceLoader, or a tokenized corpus memmap,
and logs tokens/s and MFU, counted on the
params a token touches (``n_active_params``, so top-1 MoE counts one
expert). For MoE presets it then logs the router health line of the JAX
workload (expert entropy against uniform, the fraction of token choices
the capacity dispatches dropped, the router losses) on the trained params
and the fixed (or probe) batch. The
operator launches ``tf_operator_tpu_torch.workloads.lm:main`` like any
entrypoint; ``main``
uses the context only through its attributes (``workload``,
``num_processes``, ``process_id``, ``coordinator_address``,
``mesh_axes``, ``dcn_mesh_axes``, ``chips``, ``mark_first_step``, and the
checkpointer's optional ones); a lost peer exits 138
(``rendezvous.context.retry_on_peer_loss``). Under a mesh only rank 0
logs the ``lm done`` line, with the mesh, and tokens/s and MFU count the
global batch's tokens once; every rank logs an ``lm rank`` line (its
losses and gradient norms, the digest of its replicated leaves, kernel
launches (in all and a step), peak memory, host seconds in collectives,
bytes staged through the host and sent through all_to_all, under ep with
gmm the occupied share of its received blocks, under pp the pipeline's
schedule, ticks a step and bubble fraction, and its checkpoint figures: save stalls,
blocks and bytes written, drain, commit and restore seconds). A job
whose checkpoints already cover its budget returns at once; a restarted
one resumes from its latest checkpoint (``resumed from checkpoint at
step N`` in the log; under a gang the step the chief reads, on every
rank). On the card ``main`` logs the flash
kernels' launch counts and the unrounded last loss beside the ``lm done``
line.

Workload keys: the JAX workload's (preset and TransformerConfig overrides
including ``attn`` and ``remat``, steps, batch_size, seq_len, lr,
grad_accum, data, device_loop, profile_dir, fail_at_step, fail_marker,
corpus, holdout_windows, checkpoint_dir, checkpoint_every,
checkpoint_keep, checkpoint_async, checkpoint_backend) plus ``device``
(default ``cuda``) and ``fail_rank`` (only that rank injects the
fault). Declared differences from the JAX workload:

- ``data: fixed`` draws its batch with
  ``np.random.RandomState(1).randint(0, vocab, (batch, seq))``, where JAX
  uses ``jax.random.randint(PRNGKey(1), ...)``; init draws from a
  ``torch.Generator`` seeded 0 where JAX uses ``PRNGKey(0)``. Under
  ``data: stream`` and ``memmap`` the router probe batch is
  ``np.random.RandomState(2).randint(...)``, where JAX uses ``PRNGKey(2)``.
- ``data: stream`` (``SyntheticTokens`` through ``local_loader``) and
  ``data: memmap`` (``corpus``, a ``write_token_corpus`` memmap, its last
  ``holdout_windows`` windows held out for the Evaluator) yield the JAX
  package's batches byte for byte (``train/data.py``); a resumed job skips
  the batches its checkpoint's steps consumed. Tokens arrive on the card
  as int32 and are widened to int64 there. A ``data`` value other than
  fixed, stream and memmap raises, where JAX trains on its fixed batch.
- The masked LM's fixed mask is ``np.random.RandomState(0)``'s draw
  (``models/transformer.py`` ``mlm_mask``), where JAX's is ``PRNGKey(0)``'s.
- Under a mesh ``batch_size`` is the global batch, split over the data
  axes (dp, fsdp): the fixed batch is drawn whole and each rank keeps its
  data rank's rows, and the loaders read as data rank of the data-rank
  count, so ep, cp and tp peers read the same rows (JAX seeds
  ``local_loader`` by process: ROADMAP F3); under cp each rank then keeps
  its block of those rows' sequence.
- A gang's checkpoints are the port's sharded npy layout
  (``train/checkpoint.py``), each rank writing its blocks; the port's own
  key ``checkpoint_digests`` logs each written block's sha256 in the
  ``lm rank`` line's checkpoint figures.
- Under pp with ep, ep is a data axis too: each ep rank reads rows of its
  own (``MeshPlan``). Under pp an MoE model's router line carries the
  scalar losses only, as JAX's does: the per-layer telemetry does not
  ride the pipeline.
- Not ported yet, and raising: ``checkpoint_backend: orbax`` (``auto``
  means npy), MoE under a cp axis, pp with cp, a pp axis without
  ``pp_microbatches``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.models.transformer import (
    TransformerConfig,
    check_supported,
    init_transformer,
    lm_loss,
    lm_loss_and_metrics,
    preset_from_workload,
    transformer_logical_axes,
)
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops import grouped_matmul as gm
from tf_operator_tpu_torch.parallel import collectives as coll
from tf_operator_tpu_torch.parallel import moe
from tf_operator_tpu_torch.parallel.mesh import mesh_shape
from tf_operator_tpu_torch.parallel.sharding import MeshPlan
from tf_operator_tpu_torch.rendezvous import context as rdv
from tf_operator_tpu_torch.train.checkpoint import WorkloadCheckpointer
from tf_operator_tpu_torch.train.data import (
    DeviceLoader,
    SyntheticTokens,
    TokenMemmapDataset,
    local_loader,
)
from tf_operator_tpu_torch.train.metrics import (
    mfu,
    transformer_train_flops,
    transformer_train_flops_exact,
)
from tf_operator_tpu_torch.train.profile import profile_ctx
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState

log = logging.getLogger("tpujob.lm")

# The operator's user-retryable exit code (128 + SIGUSR1): the harness
# passes an int SystemExit code through as the process's exit code.
USER_RETRYABLE_CODE = rdv.USER_RETRYABLE_CODE


@dataclass
class LMRun:
    """What one run of the workload gives back."""

    cfg: TransformerConfig
    trainer: Trainer
    state: TrainState
    tokens: torch.Tensor  # the fixed batch, or the router probe batch of a loader run
    loss: float
    losses: List[float]  # every step's loss, warmup included
    grad_norms: List[float]  # every step's gradient norm before the clip
    timed: int
    step_s: Optional[float]
    tokens_per_step: int
    device: torch.device
    flops_6nd: float
    flops_exact: float
    data: Optional[dict] = None  # DeviceLoader.stats() of a stream or memmap run
    mesh: Any = None  # the DeviceMesh of a sharded run

    @property
    def tokens_per_s(self) -> Optional[float]:
        """Tokens of the global batch a second."""
        return self.tokens_per_step / self.step_s if self.step_s else None

    @property
    def n_devices(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.mesh.numel())

    def mfu(self, flops: float) -> Optional[float]:
        """MFU against the peak of the mesh's cards; None off CUDA or
        untimed."""
        if self.step_s is None or self.device.type != "cuda":
            return None
        return mfu(flops, self.step_s, self.n_devices, self.device)


def fixed_tokens(batch: int, seq: int, vocab: int, device, seed: int = 1) -> torch.Tensor:
    """The ``data: fixed`` batch, ``RandomState(seed)`` (a declared
    difference: numpy, not jax.random); seed 2 is the router probe batch."""
    tokens = np.random.RandomState(seed).randint(0, vocab, (batch, seq))
    return torch.from_numpy(tokens).to(device)


def lm_loader(wl: dict, cfg: TransformerConfig, device, skip: int = 0,
              plan: Optional[MeshPlan] = None) -> Optional[DeviceLoader]:
    """The DeviceLoader of ``data: memmap`` or ``stream``, None for
    ``fixed``; ``skip`` batches already consumed. Under a mesh (``plan``)
    it reads this rank's share as data rank of the data-rank count."""
    data_mode = wl.get("data", "fixed")
    batch, seq = int(wl.get("batch_size", 8)), int(wl.get("seq_len", 512))
    rank, world = (0, 1) if plan is None else (plan.data_index, plan.data_size)
    if data_mode == "memmap":
        if batch % world:
            raise ValueError(f"batch_size {batch} % {world} data ranks != 0")
        # the corpus tail (holdout_windows) is reserved for the Evaluator
        # before rank-sharding: the trainer never sees those windows
        ds = TokenMemmapDataset(wl["corpus"], batch // world, seq,
                                holdout=int(wl.get("holdout_windows", 0)),
                                rank=rank, world_size=world)
        return DeviceLoader(ds, device, skip=skip)
    if data_mode == "stream":
        return local_loader(SyntheticTokens, batch, device, seq_len=seq, vocab=cfg.vocab,
                            skip=skip, rank=rank, world_size=world)
    if data_mode != "fixed":
        raise ValueError(f'unknown data mode {data_mode!r}; use "fixed", "stream" or "memmap"')
    return None


def lm_trainer(wl: dict, cfg: TransformerConfig, device: torch.device, mesh=None) -> Trainer:
    """The workload's Trainer: AdamW at ``lr`` behind the default clip,
    ``grad_accum``, the params placed by the transformer's logical axes
    under a mesh."""
    return Trainer(
        loss_fn=lambda params, tokens, extra: lm_loss(params, tokens, cfg, mesh=mesh),
        init_fn=lambda gen: init_transformer(cfg, gen, device),
        config=TrainerConfig(
            optimizer="adamw", learning_rate=float(wl.get("lr", 3e-4)),
            grad_accum=int(wl.get("grad_accum", 1)),
        ),
        device=device, mesh=mesh, logical_axes=transformer_logical_axes(cfg),
    )


def run_lm(wl: dict, device: DeviceLike = None,
           on_step: Optional[Callable[[int], None]] = None,
           ckpt: Optional[WorkloadCheckpointer] = None,
           on_batch: Optional[Callable[[torch.Tensor], None]] = None,
           mesh=None) -> LMRun:
    """Build the model from ``wl``, train ``steps`` timed steps after one
    warmup step (from the latest checkpoint, when ``checkpoint_dir`` holds
    one), and return an LMRun. ``device`` overrides the workload's
    ``device`` key (default ``cuda``); ``ckpt`` is the checkpointer to use
    (by default one built from ``wl`` and ``mesh``, without a job context);
    ``on_batch(tokens)`` sees each loader batch as it arrives on the
    device, before the step that reads it; ``mesh`` (a DeviceMesh this
    process is a rank of) shards the params and the batch."""
    dev = resolve_device(device if device is not None else wl.get("device", "cuda"))
    steps = max(2, int(wl.get("steps", 10)))
    batch = int(wl.get("batch_size", 8))
    seq = int(wl.get("seq_len", 512))
    cfg = preset_from_workload(wl)
    check_supported(cfg, mesh)
    plan = None if mesh is None else MeshPlan(mesh)
    ckpt = ckpt if ckpt is not None else WorkloadCheckpointer(wl, mesh=mesh)
    trainer = lm_trainer(wl, cfg, dev, mesh)
    loader = lm_loader(wl, cfg, dev, skip=ckpt.resume_step(), plan=plan)
    if loader is None:
        tokens = fixed_tokens(batch, seq, cfg.vocab, dev)
        tokens = data = tokens if plan is None else plan.local_batch(tokens)
    else:
        def pull():
            for b in loader:
                if on_batch is not None:
                    on_batch(b["tokens"])
                rows = b["tokens"].long()  # this data rank's rows
                yield rows if plan is None else plan.seq_cols(rows)

        data = pull()
        tokens = fixed_tokens(batch, seq, cfg.vocab, dev, seed=2)
        tokens = tokens if plan is None else plan.local_batch(tokens)
    try:
        with profile_ctx(wl.get("profile_dir")):
            state, loss, timed, step_s = ckpt.run_loop(
                trainer, 0, data, steps, on_step=on_step,
                device_loop=int(wl.get("device_loop", 1)),
            )
    finally:
        if loader is not None:
            loader.close()
    n = cfg.n_active_params()
    return LMRun(
        cfg=cfg, trainer=trainer, state=state, tokens=tokens, loss=loss,
        losses=[float(x) for x in ckpt.step_losses],
        grad_norms=[float(x) for x in ckpt.step_grad_norms], timed=timed, step_s=step_s,
        tokens_per_step=batch * seq, device=dev,
        flops_6nd=transformer_train_flops(n, batch * seq),
        flops_exact=transformer_train_flops_exact(n, batch * seq, cfg.n_layers,
                                                  cfg.d_model, seq),
        data=None if loader is None else loader.stats(), mesh=mesh,
    )


def router_metrics(run: LMRun) -> Optional[dict]:
    """Router health on the trained params and the run's batch (the probe
    batch of a loader run): expert entropy (nats; ``uniform`` = ln E),
    drop fraction (the token choices past an expert's capacity under the
    sort and einsum dispatches; 0 under ragged and gmm) and the unweighted
    router losses, as floats, of the global batch. None for a dense model.
    One forward pass, under a mesh on every rank (it runs collectives).
    Under a pipeline the router losses alone (no per-layer telemetry)."""
    if not run.cfg.n_experts:
        return None
    with torch.no_grad():
        _, m = lm_loss_and_metrics(run.state.params, run.tokens, run.cfg, mesh=run.mesh)
    if "moe_expert_entropy" not in m:
        return {"lb_loss": float(m["moe_lb_loss"]), "z_loss": float(m["moe_z_loss"])}
    return {"expert_entropy": float(m["moe_expert_entropy"]),
            "uniform": math.log(run.cfg.n_experts), "drop_frac": float(m["moe_drop_frac"]),
            "lb_loss": float(m["moe_lb_loss"]), "z_loss": float(m["moe_z_loss"])}


def replicated_digest(run: LMRun) -> str:
    """sha256 of the trained leaves that no mesh axis splits, in tree
    order: ranks whose updates of those leaves agree bitwise give one
    digest."""
    h = hashlib.sha256()
    for p in run.trainer.replicated_leaves(run.state.params):
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_line(run: LMRun, rank: int, ckpt: Optional[WorkloadCheckpointer] = None) -> dict:
    """What one rank of a run reports: its losses and gradient norms, the
    digest of its replicated leaves, its kernel launches (warmup
    included), its peak memory, host seconds in collectives, the bytes
    it staged through the host (gloo on the card), and with ``ckpt`` its
    checkpoint figures (``WorkloadCheckpointer.report``)."""
    on_card = run.device.type == "cuda"
    n_steps = max(1, len(run.losses))
    launches = {"flash_fwd_launches": fa.flash_fwd_launches,
                "flash_bwd_dq_launches": fa.flash_bwd_dq_launches,
                "flash_bwd_dkv_launches": fa.flash_bwd_dkv_launches}
    if run.cfg.n_experts:
        launches.update({k: getattr(gm, k) for k in (
            "gmm_fwd_launches", "gmm_fwd_scaled_launches", "gmm_dw_launches",
            "gmm_dw_scaled_launches")})
    return {"rank": rank, "losses": run.losses, "grad_norms": run.grad_norms,
            "replicated_sha256": replicated_digest(run),
            "step_ms": None if run.step_s is None else run.step_s * 1e3,
            "launches": launches,
            "launches_per_step": {k: v / n_steps for k, v in launches.items()},
            "flash_fwd_heads": fa.flash_fwd_heads, "pipeline": pipeline_figures(run),
            "peak_gb": torch.cuda.max_memory_allocated(run.device) / 1e9 if on_card else None,
            "collective_s": coll.collective_s, "collective_calls": coll.collective_calls,
            "staged_bytes": coll.staged_bytes, "all_to_all_bytes": coll.all_to_all_bytes,
            "received_blocks_occupied": moe.received_blocks_occupied(),
            "checkpoint": None if ckpt is None else ckpt.report()}


def pipeline_figures(run: LMRun) -> Optional[dict]:
    """Under a pipelined mesh: the schedule, microbatches, chunks and
    stages, the ticks a step (forward and backward) and the bubble
    fraction; None otherwise."""
    from tf_operator_tpu_torch.parallel.pipeline import bubble_fraction, n_ticks

    cfg = run.cfg
    stages = coll.axis_size(run.mesh, cfg.pp_axis)
    if stages == 1 or not cfg.pp_microbatches:
        return None
    m, v = cfg.pp_microbatches, cfg.pp_chunks
    return {"schedule": cfg.pp_schedule, "microbatches": m, "chunks": v, "stages": stages,
            "ticks_per_step": 2 * n_ticks(stages, m, v),
            "bubble_fraction": bubble_fraction(stages, m, v)}


@rdv.retry_on_peer_loss
def main(ctx) -> None:
    wl = ctx.workload
    # Fault injection (fail_at_step + fail_marker): die retryably once at
    # the given global step; the marker file makes it once-only. With
    # device_loop=K the check runs per chunk, up to K-1 steps late.
    # ``fail_rank`` (the port's own key) makes only that rank of a gang die,
    # so its peers see the loss (exit 138 through retry_on_peer_loss).
    fail_at = int(wl.get("fail_at_step", 0))
    marker = wl.get("fail_marker")
    fail_rank = wl.get("fail_rank")
    first_step_marked = []

    def on_step(step: int) -> None:
        if not first_step_marked:
            first_step_marked.append(step)
            ctx.mark_first_step(step)
        if fail_rank is not None and int(fail_rank) != rdv.process_id(ctx):
            return
        if fail_at and marker and step >= fail_at and not os.path.exists(marker):
            open(marker, "w").close()
            log.warning("fault injection: requesting retry at step %d", step)
            raise SystemExit(USER_RETRYABLE_CODE)

    dev = rdv.local_device(ctx, wl.get("device", "cuda"))
    mesh = rdv.build_mesh(ctx, dev) if rdv.initialize_distributed(ctx, dev) else None
    rank = rdv.process_id(ctx)
    # under a gang every rank reads the chief's latest step
    ckpt = WorkloadCheckpointer(wl, ctx=ctx, mesh=mesh)
    steps = max(2, int(wl.get("steps", 10)))
    if ckpt.is_complete(steps):
        log.info("already complete (budget %d); nothing to do", steps)
        rdv.leave_gang()
        return
    run = run_lm(wl, device=dev, on_step=on_step, ckpt=ckpt, mesh=mesh)
    if mesh is not None:
        log.info("lm rank: %s", json.dumps(rank_line(run, rank, ckpt)))
    router = router_metrics(run)  # every rank of a gang takes part
    if mesh is not None:
        rdv.leave_gang()
        if rank != 0:
            return
    _log_done(run, wl, router)


def _log_done(run: LMRun, wl: dict, router: Optional[dict]) -> None:
    preset = wl.get("preset", "tiny")
    if router is not None and "expert_entropy" not in router:
        # the pipeline carries the scalar router losses only
        log.info("moe router (pp — scalar losses only): lb_loss=%.3f z_loss=%.4f",
                 router["lb_loss"], router["z_loss"])
    elif router is not None:
        # collapsed routing (entropy far below ln E) is a silent quality bug:
        # surface it where operators look first
        log.info("moe router: expert_entropy=%.3f (uniform=%.3f) drop_frac=%.3f "
                 "lb_loss=%.3f z_loss=%.4f", router["expert_entropy"], router["uniform"],
                 router["drop_frac"], router["lb_loss"], router["z_loss"])
    if run.step_s is None:
        log.info("lm done: preset=%s loss=%.4f (no timed steps remained)", preset, run.loss)
        return
    m_exact, m_6nd = run.mfu(run.flops_exact), run.mfu(run.flops_6nd)
    log.info(
        "lm done: preset=%s loss=%.4f step=%.2fms tok/s=%.0f mfu_attn=%s "
        "mfu_6nd=%s (%d chip%s, %s)%s",
        preset, run.loss, run.step_s * 1e3, run.tokens_per_s,
        "n/a" if m_exact is None else f"{m_exact:.3f}",
        "n/a" if m_6nd is None else f"{m_6nd:.3f}", run.n_devices,
        "" if run.n_devices == 1 else "s",
        torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
        "" if run.mesh is None else f" mesh={mesh_shape(run.mesh)}",
    )
    if run.device.type == "cuda":
        # the kernels this process launched (warmup included), proof that
        # the job ran through K1-K3, and the last loss unrounded
        log.info("lm kernels: flash_fwd_launches=%d flash_bwd_dq_launches=%d "
                 "flash_bwd_dkv_launches=%d final_loss=%.9g", fa.flash_fwd_launches,
                 fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches, run.loss)
