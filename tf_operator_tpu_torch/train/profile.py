"""Profiler capture: one switch around the hot loop.

Port of ``tf_operator_tpu/train/profile.py``: with ``profile_dir`` set in
the workload dict, the body runs under ``torch.profiler`` (host and, on a
card, CUDA activity) and a Chrome trace is written to
``<dir>/<rank>/trace.json`` (the JAX layout's per-process directory; rank
0 without a process group).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_ctx(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler around the body when ``trace_dir`` is set; a no-op
    otherwise (so call sites need no branching)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    path = os.path.join(str(trace_dir), str(rank))
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
