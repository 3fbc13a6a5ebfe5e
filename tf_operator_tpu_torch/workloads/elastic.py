"""Elastic-soak workload on the port: lock-step data consumption that
survives shrink and re-grow without losing or duplicating a window.

Port of ``tf_operator_tpu/workloads/elastic.py``, the data plane of the
operator's elastic gangs (``run_policy.elastic``). The protocol is the
reference's, file for file, so the operator's soaks gate it unchanged:

- The corpus is ``total_windows`` windows consumed in the canonical
  seeded order G (``train.data.elastic_global_order``). Each epoch's
  members own a round-robin deal of the positions nobody has recorded
  yet (``_deal``). A member consumes position p by appending ``{"p",
  "w", "t", "m", "e"}`` to its ``consumed-<member>.jsonl``; a member
  killed before the append never consumed it.
- Members poll the job's resize directive every step
  (``ctx.poll_resize_directive``). On a new epoch the survivors ack
  (``ack-<member>-<epoch>``) and stop; the chief waits for every
  surviving ack, deals the remaining positions to the directive's
  members, writes ``epoch-<E>.json`` atomically and publishes the
  barrier (``ctx.publish_resize_barrier``).
- A re-grown member (``TPUJOB_RESIZE_EPOCH`` > 0) waits for the
  directive to reach its epoch, pulls the latest committed checkpoint
  from a surviving peer's shard depot
  (``WorkloadCheckpointer.prefetch_from_peers``, then disk) and records
  the restore (``ctx.record_restore``) before it joins the deal.
- When every position is recorded the chief checks exactly-once coverage
  and writes the eval digest (``_digest``) to ``eval_digest.txt`` and
  ``done.json``.
- ``device_state: true`` carries the reshard model's params and per-row
  momentum (``train/reshard.py``) on the member's device
  (``rendezvous/context.local_device``, the card unless the workload's
  ``device`` says ``cpu``) through every resize: a consumed position runs
  the row update on the device and publishes the row to the row store
  before its record; every barrier rebuilds the state with
  ``reshard.rebuild_state`` (own rows re-laid device to device, rows
  other members advanced re-fetched); the chief's ``done.json`` carries
  ``params_digest`` and the merged plan's counts.

The context is reached by its attributes only: ``workload``,
``job_name``, ``replica_type``, ``replica_index``, ``num_processes``,
``resize_epoch``, ``poll_resize_directive``, ``publish_resize_barrier``,
``record_resize``, ``record_restore``, ``mark_first_step`` and the
checkpointer's (``peer_depot``, ``restore_peers``). Every member logs an
``elastic member:`` JSON line at its end (positions consumed, its own
plan's counts, the device its rows lived on, its restore source).

Declared differences: the re-grown member restores the checkpoint's
params and momentum onto its device, where the reference restores them
into host arrays (both then rebuild from the row store, so the values
are the reference's); the state lives on a ``torch.device``, not a
one-device mesh. Requires a workers-only gang (chief = worker 0).
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.rendezvous import context as rdv
from tf_operator_tpu_torch.train import reshard as R
from tf_operator_tpu_torch.train.checkpoint import WorkloadCheckpointer
from tf_operator_tpu_torch.train.data import elastic_global_order

log = logging.getLogger("tpujob.elasticwl")

_POLL_S = 0.05


def _member_name(ctx) -> str:
    return f"{ctx.job_name}-{ctx.replica_type.lower()}-{ctx.replica_index}"


def _record_path(workdir: str, member: str) -> str:
    return os.path.join(workdir, f"consumed-{member}.jsonl")


def _read_records(workdir: str) -> List[dict]:
    """All durable consumption records; a torn final line (a member killed
    mid-append) parses as nothing: that position was never consumed."""
    out = []
    for path in sorted(glob.glob(os.path.join(workdir, "consumed-*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return out


def _epoch_path(workdir: str, epoch: int) -> str:
    return os.path.join(workdir, f"epoch-{epoch}.json")


def _latest_epoch_file(workdir: str, at_least: int) -> Optional[dict]:
    """The highest epoch-<E>.json with E >= at_least, if any."""
    best, best_e = None, -1
    for path in glob.glob(os.path.join(workdir, "epoch-*.json")):
        try:
            e = int(os.path.basename(path)[len("epoch-"):-len(".json")])
        except ValueError:
            continue
        if e >= at_least and e > best_e:
            best, best_e = path, e
    if best is None:
        return None
    try:
        with open(best) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_json_atomic(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _deal(remaining: List[int], members: List[str]) -> Dict[str, List[int]]:
    """Round-robin the remaining positions over the members in rank order:
    the rank::n stride applied to whatever is left."""
    n = len(members)
    return {m: remaining[r::n] for r, m in enumerate(members)}


def _digest(records: List[dict], total: int) -> str:
    """Sha256 over the position-ordered consumed stream, duplicates
    included: a drop, a duplicate, or a different window at a position all
    change it."""
    h = hashlib.sha256()
    for rec in sorted(records, key=lambda r: (int(r["p"]), int(r["w"]))):
        h.update(f"{rec['p']}:{rec['w']};".encode())
    h.update(str(total).encode())
    return h.hexdigest()


def _touch(path: str) -> None:
    with open(path, "w"):
        pass


def main(ctx) -> None:
    wl = ctx.workload
    workdir = wl["workdir"]
    total = int(wl.get("total_windows", 48))
    sleep_s = float(wl.get("step_sleep_s", 0.15))
    seed = int(wl.get("data_seed", 0))
    order = elastic_global_order(total, seed=seed)
    me = _member_name(ctx)
    is_chief = ctx.replica_type == "Worker" and ctx.replica_index == 0
    os.makedirs(workdir, exist_ok=True)

    ckpt = WorkloadCheckpointer(wl, ctx=ctx)
    mgr = ckpt.manager

    # -- device-state mode -------------------------------------------------
    device_state = bool(wl.get("device_state"))
    dev = None
    dev_params = dev_mom = None
    fresh: set = set()
    dim = int(wl.get("param_dim", 0)) or R.PARAM_DIM
    sdir = R.state_dir(workdir)
    plan_total = R.ReshardPlan()
    restore_source = ""
    if device_state:
        dev = rdv.local_device(ctx, wl.get("device"))
        zero_mom = torch.zeros((), dtype=torch.float32, device=dev)

    # -- join --------------------------------------------------------------
    my_epoch = 0
    if ctx.resize_epoch > 0:
        # Re-grown member: wait for the directive to reach the epoch the
        # controller stamped at creation before touching the deal.
        my_epoch = ctx.resize_epoch
        while True:
            d = ctx.poll_resize_directive()
            if d and int(d.get("epoch", 0)) >= my_epoch:
                my_epoch = int(d["epoch"])
                break
            time.sleep(_POLL_S)
        # Peer warm restore first, retried briefly (a commit can be
        # mid-push to the depot when this member lands), then disk.
        if mgr is not None:
            t0 = time.time()
            source = ckpt.prefetch_from_peers()
            deadline = time.time() + 3.0
            while source != "peer" and time.time() < deadline:
                time.sleep(0.2)
                source = ckpt.prefetch_from_peers()
            start = mgr.latest_step() or 0
            if start:
                tmpl = {"step": np.asarray(start)}
                if device_state:
                    # the chief's last committed params and momentum,
                    # restored onto this member's device; the row store
                    # overlays anything newer in the rebuild below
                    tmpl["params"] = torch.empty((total, dim), dtype=torch.float32,
                                                 device="meta")
                    tmpl["mom"] = torch.empty((total,), dtype=torch.float32, device="meta")
                restored = mgr.restore(tmpl, device=dev)
                if device_state and restored["params"].device != dev:
                    raise AssertionError(f"restore landed on {restored['params'].device}, "
                                         f"not {dev}")
                ckpt.restore_source = restore_source = source
                ctx.record_restore(source, start, t0, time.time())
                log.info("re-grown member restored step %d (source=%s)", start, source)
    elif is_chief:
        # Epoch 0: the full gang in worker-index order, dealt the whole
        # corpus. A full restart at epoch 0 reuses the existing doc.
        if not os.path.exists(_epoch_path(workdir, 0)):
            members = [f"{ctx.job_name}-worker-{i}" for i in range(ctx.num_processes)]
            _write_json_atomic(_epoch_path(workdir, 0), {
                "epoch": 0, "direction": "start", "members": members,
                "positions": _deal(list(range(total)), members),
            })

    if is_chief and ctx.resize_epoch > 0:
        # Full gang restart mid-resize: the chief lands in the join path
        # too. If the chief before the restart never wrote this epoch's
        # deal, nobody else will: re-carve it here without an ack barrier
        # (no member is still consuming an older deal).
        live = ctx.poll_resize_directive()
        e = max(int(live.get("epoch", 0)) if live else 0, my_epoch)
        if e > 0 and _latest_epoch_file(workdir, e) is None:
            members = list(live.get("members", [])) if live else []
            if me in members:
                seen = {int(r["p"]) for r in _read_records(workdir)}
                remaining = [p for p in range(total) if p not in seen]
                _write_json_atomic(_epoch_path(workdir, e), {
                    "epoch": e, "direction": str(live.get("direction", "")),
                    "members": members, "positions": _deal(remaining, members),
                    "reclaim": bool(live.get("reclaim", False)),
                })
                ctx.publish_resize_barrier(e, {
                    "completed": total - len(remaining),
                    "boundary_remaining": len(remaining),
                })
                log.info("%s re-carved epoch %d after full restart: %d remaining",
                         me, e, len(remaining))

    epoch_doc = None
    acked: set = set()
    while epoch_doc is None:
        epoch_doc = _latest_epoch_file(workdir, my_epoch)
        if epoch_doc is None:
            if ctx.resize_epoch > 0 and not is_chief:
                # A member in the join path is not consuming, so it acks
                # any live barrier it is a member of at once (else a kill
                # landing now deadlocks the chief's barrier on this ack).
                live = ctx.poll_resize_directive()
                e = int(live.get("epoch", 0)) if live else 0
                if e >= ctx.resize_epoch and e not in acked and \
                        me in live.get("members", []):
                    _touch(os.path.join(workdir, f"ack-{me}-{e}"))
                    acked.add(e)
            time.sleep(_POLL_S)
    my_epoch = int(epoch_doc["epoch"])
    assignment = list(epoch_doc["positions"].get(me, []))
    if assignment:
        # a reused deal may hold positions already recorded: never twice
        seen = {int(r["p"]) for r in _read_records(workdir)}
        assignment = [p for p in assignment if p not in seen]
    idx = 0
    consumed = 0
    rec_f = open(_record_path(workdir, me), "a")

    if device_state:
        # Initial rebuild: every published row re-fetched, the rest at the
        # deterministic init; a fetched row is final, so it stays
        # authoritative across every later re-carve.
        dev_params, dev_mom, plan = R.rebuild_state(total, dim, seed, sdir, None, None,
                                                     set(), dev, epoch=my_epoch)
        fresh = set(plan.authoritative)
        plan_total.merge(plan)

    def handle_resize(directive: dict) -> None:
        """Act on a directive whose epoch is ahead of ours."""
        nonlocal my_epoch, assignment, idx, epoch_doc, dev_params, dev_mom, fresh
        t0 = time.time()
        epoch = int(directive["epoch"])
        direction = str(directive.get("direction", ""))
        members = list(directive.get("members", []))
        if me not in members:
            log.warning("%s not in epoch %d members; exiting", me, epoch)
            rec_f.close()
            raise SystemExit(0)
        if is_chief:
            # every surviving member of the current epoch acks first
            need = [m for m in members if m != me and m in epoch_doc.get("members", [])]
            deadline = time.time() + 60.0
            while True:
                live = ctx.poll_resize_directive()
                if live and int(live.get("epoch", 0)) > epoch:
                    handle_resize(live)  # superseded mid-barrier
                    return
                missing = [m for m in need if not os.path.exists(
                    os.path.join(workdir, f"ack-{m}-{epoch}"))]
                if not missing:
                    break
                if time.time() > deadline:
                    raise AssertionError(f"resize barrier {epoch}: no ack from {missing}")
                time.sleep(_POLL_S)
            rec_f.flush()
            seen = {int(r["p"]) for r in _read_records(workdir)}
            remaining = [p for p in range(total) if p not in seen]
            _write_json_atomic(_epoch_path(workdir, epoch), {
                "epoch": epoch, "direction": direction, "members": members,
                "positions": _deal(remaining, members),
                # an over-spec reclaim shrinks back to the spec mesh: the
                # done gate must not wait for a re-grow nobody owes
                "reclaim": bool(directive.get("reclaim", False)),
            })
            ctx.publish_resize_barrier(epoch, {
                "completed": total - len(remaining),
                "boundary_remaining": len(remaining),
            })
        else:
            _touch(os.path.join(workdir, f"ack-{me}-{epoch}"))
            while _latest_epoch_file(workdir, epoch) is None:
                live = ctx.poll_resize_directive()
                if live and int(live.get("epoch", 0)) > epoch:
                    handle_resize(live)
                    return
                time.sleep(_POLL_S)
        epoch_doc = _latest_epoch_file(workdir, epoch)
        my_epoch = int(epoch_doc["epoch"])
        assignment = list(epoch_doc["positions"].get(me, []))
        idx = 0
        if device_state:
            # re-shard for the new world: own rows re-laid on the device,
            # rows another member advanced re-fetched from the store
            dev_params, dev_mom, plan = R.rebuild_state(total, dim, seed, sdir, dev_params,
                                                         dev_mom, fresh, dev, epoch=my_epoch)
            fresh = set(plan.authoritative)
            plan_total.merge(plan)
        ctx.record_resize(direction, my_epoch, t0, time.time())
        log.info("%s re-carved at epoch %d (%s): %d positions",
                 me, my_epoch, direction, len(assignment))

    def state_now() -> dict:
        state = {"step": np.asarray(consumed)}
        if device_state:
            # committed params travel with the step: a re-grown member's
            # warm base (saved from the device)
            state["params"] = dev_params
            state["mom"] = dev_mom
        return state

    # -- consume -----------------------------------------------------------
    done_path = os.path.join(workdir, "done.json")
    while True:
        d = ctx.poll_resize_directive()
        if d and int(d.get("epoch", 0)) > my_epoch:
            handle_resize(d)
            continue
        if idx >= len(assignment):
            if os.path.exists(done_path):
                break
            if is_chief and (epoch_doc.get("direction") != "shrink"
                             or epoch_doc.get("reclaim")):
                # eval runs on the full mesh: while shrunk a re-grow is
                # still owed, so hold the digest until it lands
                records = _read_records(workdir)
                if len({int(r["p"]) for r in records}) >= total:
                    positions = sorted(int(r["p"]) for r in records)
                    if positions != list(range(total)):
                        raise AssertionError(
                            f"elastic coverage broken: {len(positions)} records over "
                            f"{len(set(positions))} distinct positions, want {total} "
                            "exactly once")
                    digest = _digest(records, total)
                    with open(os.path.join(workdir, "eval_digest.txt"), "w") as f:
                        f.write(digest + "\n")
                    done = {"digest": digest, "total": total, "records": len(records)}
                    if device_state:
                        pdigest = R.params_digest(R.assemble_final(total, dim, seed, sdir))
                        with open(os.path.join(workdir, "params_digest.txt"), "w") as f:
                            f.write(pdigest + "\n")
                        done["params_digest"] = pdigest
                        done["reshard"] = {
                            "relaid": plan_total.relaid, "refetched": plan_total.refetched,
                            "inited": plan_total.inited, "epochs": plan_total.epochs,
                        }
                        done["device"] = str(dev_params.device)
                    _write_json_atomic(done_path, done)
                    log.info("elastic run complete: %d windows, digest %s",
                             total, digest[:12])
                    break
            time.sleep(_POLL_S)
            continue
        p = assignment[idx]
        time.sleep(sleep_s)
        if device_state:
            # The update is computed from the deterministic init, not the
            # current row: a member killed between the row write and the
            # record leaves p unrecorded, and its re-consumer recomputes
            # the same bits. The row is durable before the record.
            row, mom = R.row_update(
                torch.from_numpy(R.init_row(seed, p, dim)).to(dev), zero_mom,
                torch.tensor(float(int(order[p])), dtype=torch.float32, device=dev))
            dev_params[p] = row
            dev_mom[p] = mom
            R.write_row(sdir, p, row.cpu().numpy(), float(mom))
            fresh.add(p)
        rec_f.write(json.dumps({
            "p": int(p), "w": int(order[p]), "t": time.time(), "m": me, "e": my_epoch,
        }) + "\n")
        rec_f.flush()
        idx += 1
        consumed += 1
        if consumed == 1:
            ctx.mark_first_step(1)
        if is_chief and mgr is not None and ckpt.every and consumed % ckpt.every == 0:
            mgr.save(consumed, state_now())

    if is_chief and mgr is not None:
        mgr.save(max(consumed, 1), state_now(), wait=True)
        mgr.close()
    rec_f.close()
    log.info("elastic member: %s", json.dumps({
        "member": me, "consumed": consumed, "epoch": my_epoch, "device_state": device_state,
        "device": None if dev_params is None else str(dev_params.device),
        "relaid": plan_total.relaid, "refetched": plan_total.refetched,
        "inited": plan_total.inited, "epochs": plan_total.epochs,
        "restore_source": restore_source}))
    log.info("%s done: consumed %d positions (final epoch %d)", me, consumed, my_epoch)
