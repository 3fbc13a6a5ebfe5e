"""Joining the gang: the device-plane helpers of the job context.

Port of ``tf_operator_tpu/rendezvous/context.py:158-193``
(``initialize_distributed`` and ``build_mesh``) as functions that take the
operator's ``JobContext`` by duck typing (``num_processes``,
``process_id``, ``coordinator_address``, ``mesh_axes``,
``dcn_mesh_axes``, ``chips``); the port copies no control plane.

- ``initialize_distributed(ctx, device)`` joins the gang with
  ``torch.distributed.init_process_group`` on
  ``tcp://{ctx.coordinator_address}`` (rank 0 hosts the store there, as
  JAX's coordinator does) and is a no-op for one process. The backend is
  NCCL for the card and gloo for the CPU; ``TPUJOB_DIST_BACKEND=gloo`` in
  the process's environment (the spec template's ``env``, as the JAX
  examples name ``JAX_CPU_COLLECTIVES_IMPLEMENTATION: gloo``) runs gloo on
  the card too, the only way two ranks share one card (and makes a
  one-process job a group of one, so its collectives run). Every collective
  and the rendezvous time out after ``DIST_TIMEOUT_S`` seconds, so a
  lost peer is seen in that time, not after gloo's default 30 minutes.
- ``build_mesh(ctx, device)`` is the job's ``DeviceMesh`` in the spec's
  insertion order (not the canonical one), or with ``dcn_mesh_axes`` the
  hybrid mesh, as the JAX context builds them.
- ``local_device(ctx, device)``: one card a process. The scheduler puts
  rank r on host slot ``r % num_hosts``, so the ranks of a host are r,
  r + num_hosts, ... and this rank's card on its host is ``r //
  num_hosts`` (modulo the host's card count: ranks beyond it share
  cards, which gloo allows and NCCL refuses here, before NCCL would).
  ``chips_per_process`` above 1 raises: one process drives one card.
- ``retry_on_peer_loss``: the JAX harness retries only XLA's runtime
  errors; the port's entry points turn torch's peer-loss, store and
  timeout errors into ``SystemExit(138)``, the retryable exit.
"""

from __future__ import annotations

import functools
import logging
import os
from datetime import timedelta
from typing import Callable, Optional

import torch

from tf_operator_tpu_torch.device import DeviceLike, resolve_device
from tf_operator_tpu_torch.parallel import mesh as mesh_mod

log = logging.getLogger("tpujob.rendezvous")

# The operator's user-retryable exit code (128 + SIGUSR1).
USER_RETRYABLE_CODE = 138
# Seconds a collective or the rendezvous waits for a peer before it fails.
DIST_TIMEOUT_S = 120.0
ENV_DIST_BACKEND = "TPUJOB_DIST_BACKEND"

# gloo's words for a peer that went away (its errors are RuntimeErrors)
_PEER_LOSS_MARKERS = ("Connection closed by peer", "Connection reset by peer",
                      "Timed out waiting")


def num_processes(ctx) -> int:
    return int(getattr(ctx, "num_processes", 1) or 1)


def process_id(ctx) -> int:
    return int(getattr(ctx, "process_id", 0) or 0)


def dist_backend(device: torch.device) -> str:
    """NCCL for the card, gloo for the CPU, or ``TPUJOB_DIST_BACKEND``."""
    forced = os.environ.get(ENV_DIST_BACKEND, "")
    if forced:
        if forced not in ("gloo", "nccl"):
            raise ValueError(f"{ENV_DIST_BACKEND}={forced!r}: use gloo or nccl")
        if forced == "nccl" and device.type != "cuda":
            raise ValueError("the NCCL backend needs a CUDA device")
        return forced
    return "nccl" if device.type == "cuda" else "gloo"


def local_device(ctx, device: DeviceLike = None) -> torch.device:
    """This process's device: the CPU, or its card by the scheduler's slot
    rule (see the module docstring)."""
    dev = resolve_device(device)
    chips = int(getattr(ctx, "chips", 0) or 0)
    if chips > 1:
        raise NotImplementedError(
            f"chips_per_process={chips}: one process drives one card in the port "
            "(a declared difference); run one process a card")
    if dev.type != "cuda":
        return dev
    hosts = max(1, int(getattr(ctx, "num_hosts", 1) or 1))
    index = (process_id(ctx) // hosts) % torch.cuda.device_count()
    return torch.device("cuda", index)


def _ranks_share_a_card(ctx) -> bool:
    hosts = max(1, int(getattr(ctx, "num_hosts", 1) or 1))
    on_host = -(-num_processes(ctx) // hosts)
    return on_host > torch.cuda.device_count()


def initialize_distributed(ctx, device: DeviceLike = None) -> Optional[str]:
    """Join the gang (see the module docstring). Returns the backend, or
    None for a one-process job without ``TPUJOB_DIST_BACKEND`` (with it,
    a one-process job joins a group of one). Binds this process's card
    first."""
    n = num_processes(ctx)
    if n <= 1 and not os.environ.get(ENV_DIST_BACKEND):
        return None
    import torch.distributed as dist

    dev = local_device(ctx, device)
    backend = dist_backend(dev)
    if backend == "nccl" and _ranks_share_a_card(ctx):
        raise RuntimeError(
            f"{n} NCCL ranks on {torch.cuda.device_count()} card(s): NCCL refuses two ranks "
            f"on one device; set {ENV_DIST_BACKEND}=gloo in the template env to share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{ctx.coordinator_address}",
                            rank=process_id(ctx), world_size=n,
                            timeout=timedelta(seconds=DIST_TIMEOUT_S), **kwargs)
    log.info("joined the gang: rank %d of %d, backend %s on %s, timeout %.0f s",
             process_id(ctx), n, backend, dev, DIST_TIMEOUT_S)
    return backend


def build_mesh(ctx, device: DeviceLike = None):
    """The job's DeviceMesh over every rank of the gang (one rank for a
    one-process job, which needs no process group to join)."""
    dev = resolve_device(device)
    n = num_processes(ctx)
    dcn = dict(getattr(ctx, "dcn_mesh_axes", None) or {})
    axes = dict(getattr(ctx, "mesh_axes", None) or {})
    if dcn:
        names, arr = mesh_mod.hybrid_mesh_ranks(axes, dcn, range(n))
    else:
        names, arr = mesh_mod.mesh_ranks(axes or {"dp": n}, range(n), canonical=False)
    return mesh_mod.device_mesh(names, arr, dev.type)


def is_peer_loss(exc: BaseException) -> bool:
    """torch's errors for a lost peer, a lost store or a timeout."""
    import torch.distributed as dist

    kinds = tuple(getattr(dist, k) for k in ("DistBackendError", "DistNetworkError",
                                             "DistStoreError") if hasattr(dist, k))
    if isinstance(exc, kinds):
        return True
    return isinstance(exc, RuntimeError) and any(m in str(exc) for m in _PEER_LOSS_MARKERS)


def retry_on_peer_loss(fn: Callable) -> Callable:
    """Wrap an entry point: a peer-loss, store or timeout error becomes
    ``SystemExit(138)`` (the harness's retryable exit); any other error
    propagates as it is."""

    @functools.wraps(fn)
    def entry(ctx):
        try:
            return fn(ctx)
        except Exception as exc:
            if not is_peer_loss(exc):
                raise
            log.warning("lost a peer of the gang (retryable): %s: %s",
                        type(exc).__name__, str(exc)[:500])
            raise SystemExit(USER_RETRYABLE_CODE) from exc

    return entry


def leave_gang() -> None:
    """Destroy the process group, when one was joined."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
