"""The workload step loop, without checkpoints yet.

Port of ``WorkloadCheckpointer`` (``tf_operator_tpu/train/checkpoint.py``
:703) as far as ``workloads/lm.py`` needs it with no ``checkpoint_dir``:
the host-side step count, ``is_complete``/``resume_step``/
``restore_or_init``/``advance``/``final``, and ``run_loop``
(``checkpoint.py:943-1073``). Saving, restoring, the peer depots and the
cadence directive come with ROADMAP M6; a workload that sets
``checkpoint_dir`` raises until then.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List


class WorkloadCheckpointer:
    """Tracks the step count on the host so the loop never syncs for it.
    ``step_losses`` keeps every step's loss tensor (device scalars, read
    after the loop), the per-step record callers such as chip_smoke.py
    check for finiteness and descent."""

    def __init__(self, workload: Dict[str, Any]) -> None:
        if workload.get("checkpoint_dir"):
            raise NotImplementedError(
                "checkpoint_dir: checkpoints are not ported yet (ROADMAP M6)")
        self._step = 0
        self.start_step = 0
        self.step_losses: List[Any] = []

    def restore_or_init(self, trainer, seed: int = 0):
        """Fresh init (no checkpoint to resume from yet); primes the
        host-side step mirror."""
        state = trainer.init(seed)
        self._step = self.start_step = int(state.step)
        return state

    def resume_step(self) -> int:
        return 0

    def is_complete(self, steps: int) -> bool:
        """True when a previous run already trained past the budget (the +1
        is the warmup step, which also trains)."""
        return self.start_step >= steps + 1

    def timed_steps(self, steps: int) -> int:
        return max(0, steps - self.start_step)

    def advance(self, state, loss=None, n: int = 1) -> None:
        """Once per step (or per ``n``-step chunk)."""
        self._step += n

    def final(self, state) -> None:
        """The final save: nothing to save without a checkpoint_dir."""

    def run_loop(self, trainer, seed, batch, steps: int, on_step=None,
                 device_loop: int = 1):
        """restore-or-init, one warmup step, then ``steps - start_step`` timed
        steps, the finiteness guard and the final save. Returns ``(state,
        loss, timed, step_s)``; ``step_s`` is None when no timed steps
        remained. ``on_step(global_step)`` fires after every advance.

        ``batch`` is one fixed batch or an iterator pulled once per step.
        ``device_loop=K`` runs K steps per chunk (a Python loop here, the
        JAX trainer's scan) and fires ``on_step`` once per chunk with the
        post-chunk step, as the JAX loop does."""
        is_iter = hasattr(batch, "__next__")
        pull = (lambda: next(batch)) if is_iter else (lambda: batch)
        device_loop = max(1, int(device_loop))

        def run_chunk(state, remaining: int):
            k = min(device_loop, remaining)
            for _ in range(k):
                state, m = trainer.step(state, pull())
                self.step_losses.append(m["loss"])
            self.advance(state, loss=m["loss"], n=k)
            if on_step is not None:
                on_step(self._step)
            return state, m, k

        state = self.restore_or_init(trainer, seed)
        remaining = self.timed_steps(steps)
        state, m = trainer.step(state, pull())  # warmup: first launches, builds
        self.step_losses.append(m["loss"])
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
            raise AssertionError(f"non-finite loss {loss}")
        self.final(state)
        return state, loss, timed, step_s
