"""Device-state re-shard for elastic resizes.

Port of ``tf_operator_tpu/train/reshard.py``. When a resize directive
lands, every surviving member rebuilds its device-resident params and
optimizer state for the new world from two sources:

- **Re-laid** rows: rows this member's device copy is authoritative for
  (consumed by it, or refreshed at the last barrier). They move device to
  device: the new tensors take them by an index into the old ones, with
  no host round trip and no disk.
- **Re-fetched** rows: rows another member advanced since this member's
  last refresh, read from the shared row store (one atomically written
  ``.npy`` a row). Rows nobody has consumed yet take the deterministic
  init. Both are assembled on the host and go up in one copy.

The model is the reference's deliberately small one: params are a
``(total, PARAM_DIM)`` float32 matrix and the optimizer state one
momentum scalar a row, each row touched by exactly one consume, so
"bit-identical final params against the uninterrupted run" holds across
any composition of shrinks, re-grows and restarts, and any lost,
duplicated or mis-sourced row changes the digest.

Declared differences from the JAX package: the tensors live on an
explicit ``torch.device`` (the job's, ``rendezvous/context.py``
``local_device``), not on a one-device mesh; ``rebuild_state`` keeps the
kept rows on the device where the reference pulls them to the host and
pushes the matrix back through ``jit``. The row store's file format,
``init_row``, the counts of a plan and its ``authoritative`` set, and
every value are the reference's.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

# Default row width of the soak model's params matrix.
PARAM_DIM = 8
# The row update: row' = decay * row + lr * w, momentum' = lr * w.
ROW_DECAY = 0.5
ROW_LR = 1e-3


# ---- deterministic row model -------------------------------------------


def init_row(seed: int, p: int, dim: int = PARAM_DIM) -> np.ndarray:
    """Deterministic init for row ``p``: every member of every incarnation
    derives the same value (SeedSequence over the (seed, position) pair),
    as the JAX package does."""
    rng = np.random.default_rng([int(seed), int(p)])
    return rng.standard_normal(dim).astype(np.float32)


def row_update(row: torch.Tensor, mom: torch.Tensor,
               w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-touch row update on ``row``'s device, rounded as the JAX
    package's jitted body is: ``ROW_DECAY * row`` and ``ROW_LR * w`` each
    rounded to f32, then their sum. A fused multiply-add (``add(...,
    alpha=)``, ``addcmul``, ``lerp``) rounds once and changes the bits of
    some rows, which the params digest catches."""
    decayed = ROW_DECAY * row
    step = ROW_LR * w
    new_row = decayed + step
    new_mom = step * torch.ones_like(mom)
    return new_row, new_mom


# ---- shared row store --------------------------------------------------


def state_dir(workdir: str) -> str:
    return os.path.join(workdir, "state")


def row_path(sdir: str, p: int) -> str:
    return os.path.join(sdir, f"row-{int(p):06d}.npy")


def write_row(sdir: str, p: int, row: np.ndarray, mom: float) -> None:
    """Durably publish row ``p``: the momentum scalar appended to the row,
    written tmp-then-rename so a member killed mid-write leaves the old
    row or nothing, never a torn one. Written before the consumption
    record, so a durable record implies a durable row."""
    os.makedirs(sdir, exist_ok=True)
    buf = np.concatenate([np.asarray(row, dtype=np.float32).ravel(),
                          np.asarray([mom], dtype=np.float32)])
    tmp = row_path(sdir, p) + f".tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, buf)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, row_path(sdir, p))


def read_row(sdir: str, p: int, dim: int = PARAM_DIM) -> Optional[Tuple[np.ndarray, float]]:
    try:
        buf = np.load(row_path(sdir, p))
    except (OSError, ValueError):
        return None
    if buf.shape != (dim + 1,):
        return None
    return buf[:dim].astype(np.float32), float(buf[dim])


# ---- the re-shard itself -----------------------------------------------


@dataclass
class ReshardPlan:
    """What a rebuild did, row by row: the receipt that the re-shard
    re-laid device state rather than round-tripping it through files."""
    relaid: int = 0      # rows taken from this member's own device copy
    refetched: int = 0   # rows read back from the shared row store
    inited: int = 0      # rows nobody has consumed yet (deterministic init)
    epochs: List[int] = field(default_factory=list)
    # Rows whose rebuilt value is final (relaid or refetched): a consumed
    # row never changes again. Init rows are not authoritative: another
    # member may consume them after this barrier.
    authoritative: Set[int] = field(default_factory=set)

    def merge(self, other: "ReshardPlan") -> None:
        self.relaid += other.relaid
        self.refetched += other.refetched
        self.inited += other.inited
        self.epochs.extend(other.epochs)


def plan_rows(total: int, fresh: Set[int]) -> Tuple[List[int], List[int]]:
    """Split [0, total) into (kept, stale): kept rows re-lay from the
    member's device copy, stale rows re-fetch from the row store."""
    kept = [p for p in range(total) if p in fresh]
    stale = [p for p in range(total) if p not in fresh]
    return kept, stale


def rebuild_state(total: int, dim: int, seed: int, sdir: str,
                  device_params: Optional[torch.Tensor], device_mom: Optional[torch.Tensor],
                  fresh: Set[int], device, epoch: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, ReshardPlan]:
    """The full (total, dim) params and (total,) momentum on ``device`` for
    a new epoch. A row comes from this member's own device copy while it is
    fresh (re-laid, device to device), else from the row store
    (re-fetched), else from the deterministic init. Returns the new
    tensors and the plan."""
    device = torch.device(device)
    plan = ReshardPlan(epochs=[epoch])
    kept, stale = plan_rows(total, fresh)
    new_params = torch.empty((total, dim), dtype=torch.float32, device=device)
    new_mom = torch.zeros((total,), dtype=torch.float32, device=device)
    if kept:
        idx = torch.tensor(kept, dtype=torch.long).to(device)
        new_params[idx] = device_params.to(device).index_select(0, idx)
        new_mom[idx] = device_mom.to(device).index_select(0, idx)
        plan.relaid = len(kept)
        plan.authoritative.update(kept)
    if stale:
        # one host buffer, [rows, dim + 1] (the momentum last), one copy up
        host = np.zeros((len(stale), dim + 1), dtype=np.float32)
        for i, p in enumerate(stale):
            got = read_row(sdir, p, dim)
            if got is not None:
                host[i, :dim], host[i, dim] = got
                plan.refetched += 1
                plan.authoritative.add(p)
            else:
                host[i, :dim] = init_row(seed, p, dim)
                plan.inited += 1
        idx = torch.tensor(stale, dtype=torch.long).to(device)
        up = torch.from_numpy(host).to(device)
        new_params[idx] = up[:, :dim]
        new_mom[idx] = up[:, dim]
    return new_params, new_mom, plan


def assemble_final(total: int, dim: int, seed: int, sdir: str) -> np.ndarray:
    """The chief's final assembly on the host: every row from the row
    store, init where a row is absent. The digest's input."""
    out = np.empty((total, dim), dtype=np.float32)
    for p in range(total):
        got = read_row(sdir, p, dim)
        out[p] = got[0] if got is not None else init_row(seed, p, dim)
    return out


def expected_params(total: int, dim: int, seed: int, order: Sequence[int],
                    device="cpu") -> np.ndarray:
    """The uninterrupted run's final params: the same row update the
    members run, applied once a position (each row is touched once and the
    update is row-local, so the order of consumption cannot matter)."""
    device = torch.device(device)
    out = np.empty((total, dim), dtype=np.float32)
    zero_mom = torch.zeros((), dtype=torch.float32, device=device)
    for p in range(total):
        row, _ = row_update(torch.from_numpy(init_row(seed, p, dim)).to(device), zero_mom,
                            torch.tensor(float(int(order[p])), dtype=torch.float32,
                                         device=device))
        out[p] = row.cpu().numpy()
    return out


def params_digest(params: np.ndarray) -> str:
    """Sha256 over the row-major float32 bytes."""
    return hashlib.sha256(np.ascontiguousarray(params, dtype=np.float32).tobytes()).hexdigest()
