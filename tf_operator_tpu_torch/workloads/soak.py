"""Chaos-soak workload on the port: the chaos soak's light data plane.

Port of ``tf_operator_tpu/workloads/soak.py``. The chaos soak
(``chaos/soak.py`` in the JAX package) exercises crash, preemption, drain
and warm-restart mechanics in the control plane; the data plane only has
to make progress observable and resumable, with no collectives:

- every gang member paces ``steps`` wall-clock steps of ``step_sleep_s``;
- the chief (worker 0 or the coordinator) saves every
  ``checkpoint_every`` steps through the port's ``WorkloadCheckpointer``
  (each committed step pushed to the host's shard depot), and a resumed
  chief pulls warm state from a surviving peer's depot before disk,
  logging "resumed from checkpoint at step N" and the restore span;
- ``disk_restore_delay_s`` models a flagship-scale disk fetch: a resumed
  chief sleeps that long when its restore source is disk;
- ``save_stall_extra_s`` models a flagship-scale blocking write after
  each accepted save;
- the checkpoint cadence directive is polled at every step boundary;
- a member polls the chaos HANG wedge marker (``WEDGE_MARKER`` in the
  checkpoint directory) and, on a cold incarnation, blocks forever in
  ``_fake_collective_all_reduce``;
- the controller's declared ``TPUJOB_RESUME_STEP`` must never exceed
  what is restorable.

Step telemetry goes through the context (``telemetry``,
``close_telemetry``; ``slow_ranks``/``slow_extra_s`` and ``data_wait_s``
model a slow host and input stalls). The context is the harness's job
context, reached by its attributes.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from tf_operator_tpu_torch.train.checkpoint import WorkloadCheckpointer

log = logging.getLogger("tpujob.soakwl")

# The chaos injector's HANG fault marker, a file in the checkpoint
# directory (the JAX package's chaos/faults.py names it so).
WEDGE_MARKER = "chaos-wedge.marker"


def _wedge_marker(ctx, wl: dict) -> str:
    """Path this member polls for the chaos HANG wedge, or "" when the
    wedge cannot apply: warm incarnations (resume_step > 0) never wedge,
    since the marker stays on disk after the fault."""
    if ctx.resume_step or not wl.get("checkpoint_dir"):
        return ""
    return os.path.join(str(wl["checkpoint_dir"]), WEDGE_MARKER)


def _fake_collective_all_reduce(ctx, step: int) -> None:
    """The wedge: block forever, as an all-reduce whose peer never arrives.
    A named frame, which the hang soak finds in every rank's SIGUSR2 stack
    dump; the process keeps handling signals, so heartbeats flow while
    step progress is dead."""
    log.warning("chaos wedge: rank %d entering fake collective at step %d "
                "(will never return)", ctx.process_id, step)
    while True:
        time.sleep(1.0)


def main(ctx) -> None:
    wl = ctx.workload
    steps = int(wl.get("steps", 8))
    sleep_s = float(wl.get("step_sleep_s", 0.25))
    is_chief = ctx.replica_type == "Coordinator" or (
        ctx.replica_type == "Worker" and ctx.replica_index == 0)

    data_wait_s = float(wl.get("data_wait_s", 0.0))
    extra_s = (float(wl.get("slow_extra_s", 0.0))
               if ctx.process_id in [int(r) for r in wl.get("slow_ranks", [])] else 0.0)
    rep = ctx.telemetry(
        flush_every=int(wl.get("telemetry_every", 2)),
        tokens_per_step=float(wl.get("tokens_per_step", 0.0)),
        flops_per_step=float(wl.get("flops_per_step", 0.0)),
    )
    wedge = _wedge_marker(ctx, wl)

    if not (is_chief and wl.get("checkpoint_dir")):
        # non-chief members pace the same wall clock; gang restarts and
        # drains act on them through signals
        for i in range(steps):
            if wedge and os.path.exists(wedge):
                _fake_collective_all_reduce(ctx, i + 1)
            t0 = time.time()
            time.sleep(sleep_s + data_wait_s + extra_s)
            if i == 0:
                ctx.mark_first_step(1)
            if rep:
                rep.step(time.time() - t0, data_wait_s=data_wait_s)
        ctx.close_telemetry(rep)
        return

    ckpt = WorkloadCheckpointer(wl, ctx=ctx)
    mgr = ckpt.manager

    # warm restore: peer depots first (materialising the committed step
    # locally), then disk
    t0 = time.time()
    source = ckpt.prefetch_from_peers()
    start = mgr.latest_step() or 0
    state = {"step": np.asarray(start)}
    if start:
        if source == "disk":
            time.sleep(float(wl.get("disk_restore_delay_s", 0.0)))
        state = mgr.restore(state)
        ckpt.restore_source = source
        log.info("resumed from checkpoint at step %d (source=%s)", start, source)
        ctx.record_restore(source, start, t0, time.time())
    if ctx.resume_step > start:
        raise AssertionError(
            f"controller declared resume step {ctx.resume_step} but disk has only "
            f"{start} — the warm-restart env over-promised")
    for s in range(start + 1, steps + 1):
        if wedge and os.path.exists(wedge):
            _fake_collective_all_reduce(ctx, s)
        # the cadence directive retunes ckpt.every live, before this
        # step's save decision
        ckpt.poll_cadence_directive(step=s - 1)
        every = ckpt.every
        t0 = time.time()
        time.sleep(sleep_s + data_wait_s + extra_s)
        state = {"step": np.asarray(s)}
        if s == start + 1:
            ctx.mark_first_step(s)
        stall = 0.0
        if every and s % every == 0 and mgr.save(s, state):
            extra = float(wl.get("save_stall_extra_s", 0.0))
            if extra:
                time.sleep(extra)
            now = time.time()
            stall = mgr.last_save_stall_s + extra
            ctx.record_save_stall(s, now - stall, now)
        if rep:
            rep.step(time.time() - t0, data_wait_s=data_wait_s, ckpt_stall_s=max(0.0, stall))
    ctx.close_telemetry(rep)
    mgr.save(steps, state, wait=True)  # the final save (a no-op if the step exists)
    mgr.close()
    log.info("soak workload done: steps=%d (resumed from %d)", steps, start)
