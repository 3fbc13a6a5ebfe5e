"""Smoke workload on the port: every device of the gang computes and communicates.

Port of ``tf_operator_tpu/workloads/smoke.py``: every process joins the
gang, a ones tensor of shape ``[n_dev, dim, dim]`` is sharded over the
first mesh axis (each rank holds its rows of it), each rank multiplies
its block by itself, and the global sum (an all-reduce over the first
axis; the other axes hold copies) must equal ``n_dev * dim**3`` within a
relative 1e-5. A dead device or a broken link hangs the collective (until
the gang's timeout) or gives a wrong sum.

Workload keys: ``dim`` (default 256), ``sleep_s`` (a fault-injection
hook: the gang stays up that long before the computation, so a test can
kill a process mid-run) and ``device`` (default ``cuda``).
"""

from __future__ import annotations

import logging
import math
import time

import torch

from tf_operator_tpu_torch.parallel import collectives as coll
from tf_operator_tpu_torch.parallel.mesh import mesh_shape
from tf_operator_tpu_torch.parallel.sharding import axis_coords
from tf_operator_tpu_torch.rendezvous import context as rdv

log = logging.getLogger("tpujob.smoke")


def run_smoke(ctx, device=None) -> float:
    """The checked global sum of the batched product (see the module
    docstring); raises AssertionError on a wrong sum."""
    wl = getattr(ctx, "workload", {}) or {}
    dev = rdv.local_device(ctx, device if device is not None else wl.get("device", "cuda"))
    rdv.initialize_distributed(ctx, dev)
    mesh = rdv.build_mesh(ctx, dev)
    axis = mesh.mesh_dim_names[0]
    n_dev = mesh.mesh.numel()
    dim = int(wl.get("dim", 256))
    log.info("mesh=%s devices=%d", mesh_shape(mesh), n_dev)
    n_axis = coll.axis_size(mesh, axis)
    rows = n_dev // n_axis  # the first axis splits dim 0 of [n_dev, dim, dim]
    ones = torch.ones((rows, dim, dim), dtype=torch.float32, device=dev)

    sleep_s = float(wl.get("sleep_s", 0))
    if sleep_s:
        time.sleep(sleep_s)

    local = torch.bmm(ones, ones).sum()
    joined = torch.distributed.is_available() and torch.distributed.is_initialized()
    total = float(coll.all_reduce_now(local, mesh, axis) if joined else local)
    ctx.mark_first_step(0)
    expected = float(n_dev) * dim ** 3
    if not math.isclose(total, expected, rel_tol=1e-5):
        raise AssertionError(f"smoke mismatch: got {total}, expected {expected}")
    coords = axis_coords(mesh, rdv.process_id(ctx))
    log.info("smoke ok: %d devices, checksum %.0f (rank %d at %s, %s)", n_dev, total,
             rdv.process_id(ctx), coords,
             torch.distributed.get_backend() if joined else "no gang")
    return total


@rdv.retry_on_peer_loss
def main(ctx) -> None:
    run_smoke(ctx)
    rdv.leave_gang()
