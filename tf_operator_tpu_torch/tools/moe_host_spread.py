"""moe-small's training step on one CUDA card, read again and again in one
process: before and after ``chip_smoke.py``'s data and Evaluator phases
(``data_memmap``, ``eval_live``, which write and delete ~9.5 GB of
checkpoints), and after an ``os.sync()``.

Run from the root of a checkout on a CUDA host:

    python -m tf_operator_tpu_torch.tools.moe_host_spread

Each reading is ``chip_smoke.phase_train`` at ``chip_smoke.MOE_WL`` (1
warmup and 8 timed steps on the host clock) and
``chip_smoke.phase_train_breakdown`` (device busy and idle over 2
profiled steps), printed as their JSON lines with the reading's tag in
the phase name. moe-small's step is host-bound, so its host clock spreads
while its device busy does not: the readings with no phase between them
give that spread, against which the reading after the phases is judged.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
import chip_smoke as cs  # noqa: E402


def reading(tag: str, smi: str) -> None:
    torch.cuda.empty_cache()
    run, _ = cs.phase_train(smi, cs.MOE_WL, per_layer=cs.MOE_PER_LAYER,
                            phase=f"moe_train_{tag}")
    cs.phase_train_breakdown(run, smi, phase=f"moe_breakdown_{tag}")
    del run
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_host_spread: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi()
    cs.build_all()
    reading("fresh_1", smi)
    reading("fresh_2", smi)
    wl, corpus = cs.phase_data_memmap(smi, "cuda")
    try:
        cs.phase_eval_live(smi, wl, "cuda")
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
    reading("after_eval", smi)
    t = time.perf_counter()
    os.sync()
    cs.emit({"phase": "sync", "s": time.perf_counter() - t})
    reading("after_sync", smi)
    reading("again", smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
