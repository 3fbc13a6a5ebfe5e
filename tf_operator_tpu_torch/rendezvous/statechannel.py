"""Warm-restore client of the peer state channel: push committed
checkpoint steps to a host's shard depot, pull warm state from a peer's.

The port's own copy of the client half of
``tf_operator_tpu/rendezvous/statechannel.py`` (``DepotClient``,
``choose_restore_source``, ``COMMIT_MARKER_FILES``), standard library only,
so a port workload speaks the same wire protocol to the same depots:

- ``GET  /depot/v1/steps?ns=&job=``                -> ``{"steps": [int]}``
- ``GET  /depot/v1/files?ns=&job=&step=``          -> ``{"files": {rel: sha256}}``
- ``GET  /depot/v1/shard?ns=&job=&step=&file=``    -> raw bytes, with ``X-Shard-SHA256``
- ``PUT  /depot/v1/shard?ns=&job=&step=&file=``    -> stage one file
- ``POST /depot/v1/commit?ns=&job=&step=``         -> staged -> committed

The depot itself (``ShardDepot``) lives beside the host agent, which is
control plane, and is not ported. A fetched step materializes on the
restorer's disk with its commit-marker file written last, so a fetch torn
by a dying peer never becomes a resume point.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("tpujob.statechannel")

# Files that mark a step directory committed (train/checkpoint.py): written
# last on fetch so a torn download is never discoverable as a resume point.
COMMIT_MARKER_FILES = ("manifest.json", "_CHECKPOINT_METADATA", "commit_success.txt")


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _safe_join(root: str, rel: str) -> str:
    """Join a peer-supplied relative path under ``root``, refusing any form
    that would escape it (absolute paths, ``..`` components, or anything
    whose normalized join lands outside root): the depot protocol is
    unauthenticated, so a peer's listing must never direct writes outside
    the fetch's temp dir."""
    if not rel or os.path.isabs(rel) or "\\" in rel:
        raise ValueError(f"unsafe relpath from peer: {rel!r}")
    root_abs = os.path.abspath(root)
    full = os.path.abspath(os.path.join(root_abs, rel))
    if os.path.commonpath([root_abs, full]) != root_abs:
        raise ValueError(f"unsafe relpath from peer: {rel!r}")
    return full


class DepotClient:
    """Workload-side client: push committed steps up, pull warm state down.

    Every method is best-effort and returns None/False/[] on any transport
    or integrity failure — a peer dying mid-transfer must degrade to the
    next restore source, never crash the restoring workload."""

    def __init__(self, timeout: float = 10.0) -> None:
        self.timeout = timeout

    # -- transport helpers -------------------------------------------------

    def _get(self, base: str, path: str, q: Dict[str, str]):
        url = f"{base}{path}?{urllib.parse.urlencode(q)}"
        return urllib.request.urlopen(url, timeout=self.timeout)  # noqa: S310

    def _json(self, base: str, path: str, q: Dict[str, str]):
        with self._get(base, path, q) as resp:
            return json.loads(resp.read().decode())

    # -- push (serving side feed) -----------------------------------------

    def push_step(self, depot_url: str, ns: str, job: str, step: int,
                  step_dir: str) -> bool:
        """Upload one COMMITTED on-disk step directory to a depot, then
        commit it there. Caller must only push after the local disk commit
        (the on_commit seam in CheckpointManager guarantees that)."""
        try:
            for root, _dirs, names in os.walk(step_dir):
                for name in names:
                    full = os.path.join(root, name)
                    rel = os.path.relpath(full, step_dir)
                    with open(full, "rb") as f:
                        data = f.read()
                    q = {"ns": ns, "job": job, "step": str(step), "file": rel}
                    url = f"{depot_url}/depot/v1/shard?{urllib.parse.urlencode(q)}"
                    req = urllib.request.Request(url, data=data, method="PUT")
                    with urllib.request.urlopen(req, timeout=self.timeout):  # noqa: S310
                        pass
            q = {"ns": ns, "job": job, "step": str(step)}
            url = f"{depot_url}/depot/v1/commit?{urllib.parse.urlencode(q)}"
            req = urllib.request.Request(url, data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:  # noqa: S310
                return resp.status == 200
        except (OSError, urllib.error.URLError, ValueError) as exc:
            log.warning("depot push of step %d to %s failed: %s", step, depot_url, exc)
            return False

    # -- pull (restore side) ----------------------------------------------

    def steps(self, depot_url: str, ns: str, job: str) -> List[int]:
        try:
            return [int(s) for s in
                    self._json(depot_url, "/depot/v1/steps", {"ns": ns, "job": job})["steps"]]
        except (OSError, urllib.error.URLError, ValueError, KeyError):
            return []

    def step_worlds(self, depot_url: str, ns: str, job: str) -> Dict[int, int]:
        """{committed step: writing world size} from a peer's listing;
        {} on any failure or a peer that serves no worlds."""
        try:
            body = self._json(depot_url, "/depot/v1/steps", {"ns": ns, "job": job})
            return {int(s): int(w) for s, w in (body.get("worlds") or {}).items()}
        except (OSError, urllib.error.URLError, ValueError, KeyError, AttributeError):
            return {}

    def best_peer(self, peers: List[str], ns: str, job: str,
                  expect_world_size: Optional[int] = None) -> Tuple[Optional[str], int]:
        """(depot_url, step) of the highest committed step across peers;
        (None, 0) when no peer holds anything. Dead peers are skipped.

        With ``expect_world_size`` set (elastic restore), steps whose
        advertised writing world size is tagged AND differs are skipped —
        a shard set sharded for a different world is not a warm-restore
        source for this one. Untagged steps (0, or a peer that serves no
        worlds) pass; the manifest check in fetch_step and the
        restore-time refusal in CheckpointManager remain the authoritative
        gates."""
        best_url, best_step = None, 0
        for url in peers:
            steps = self.steps(url, ns, job)
            if expect_world_size and steps:
                worlds = self.step_worlds(url, ns, job)
                steps = [
                    s for s in steps
                    if not worlds.get(s) or worlds[s] == int(expect_world_size)
                ]
            if steps and steps[-1] > best_step:
                best_url, best_step = url, steps[-1]
        return best_url, best_step

    def fetch_step(self, depot_url: str, ns: str, job: str, step: int,
                   dest_root: str,
                   expect_world_size: Optional[int] = None) -> Optional[str]:
        """Materialize a peer's committed step as a COMMITTED step
        directory under ``dest_root`` (the restorer's checkpoint dir), so
        the ordinary disk-restore path loads it bit-identically.

        Integrity + commit ordering: every file is verified against the
        peer's sha256 before landing, data files are written to a temp dir
        first, commit-marker files (COMMIT_MARKER_FILES) are written LAST,
        and the temp dir is atomically renamed into place — a peer dying
        mid-transfer leaves an unfinished temp dir, never a resume point.
        Returns the final step path, or None on any failure (caller falls
        back to the next peer, then disk)."""
        step = int(step)
        final = os.path.join(dest_root, f"step_{step}")
        if os.path.exists(os.path.join(final, "manifest.json")):
            return final  # disk already holds this committed step
        q = {"ns": ns, "job": job, "step": str(step)}
        tmp = os.path.join(dest_root, f".peerfetch_step_{step}_{os.getpid()}")
        try:
            listing = self._json(depot_url, "/depot/v1/files", q)["files"]
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            # Validate EVERY peer-supplied relpath before any byte lands:
            # a listing entry like '../../x' must fail the whole fetch
            # (fall back to the next source), not write outside tmp.
            for rel in listing:
                _safe_join(tmp, rel)
            markers = [r for r in listing if os.path.basename(r) in COMMIT_MARKER_FILES]
            data_files = [r for r in listing if r not in markers]
            if not markers:
                log.warning("peer %s step %d has no commit marker; refusing",
                            depot_url, step)
                shutil.rmtree(tmp, ignore_errors=True)
                return None
            for rel in data_files + markers:  # markers strictly last
                with self._get(depot_url, "/depot/v1/shard", {**q, "file": rel}) as resp:
                    data = resp.read()
                    want = resp.headers.get("X-Shard-SHA256", "")
                if want and _sha256(data) != want:
                    raise ValueError(f"sha256 mismatch on {rel}")
                if expect_world_size and os.path.basename(rel) == "manifest.json":
                    # Elastic restore: verify the writing world size
                    # tag before this fetch can become a resume point. A
                    # mismatch degrades to the next source, loudly.
                    saved = int(json.loads(data.decode()).get("world_size", 0) or 0)
                    if saved and saved != int(expect_world_size):
                        raise ValueError(
                            f"step {step} written by world {saved}, "
                            f"expected {int(expect_world_size)}"
                        )
                full = _safe_join(tmp, rel)
                os.makedirs(os.path.dirname(full), exist_ok=True)
                with open(full, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
            os.makedirs(dest_root, exist_ok=True)
            try:
                os.rename(tmp, final)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)  # lost a race; theirs won
            return final
        except (OSError, urllib.error.URLError, ValueError, KeyError) as exc:
            log.warning("peer fetch of step %d from %s failed: %s — falling back",
                        step, depot_url, exc)
            shutil.rmtree(tmp, ignore_errors=True)
            return None


def choose_restore_source(
    peers: List[str], ns: str, job: str, disk_step: int,
    client: Optional[DepotClient] = None,
    expect_world_size: Optional[int] = None,
) -> Tuple[str, Optional[str], int]:
    """The restore-source decision order (docs/design.md §4.9):

    1. **peer** — some live depot holds a committed step >= the newest
       complete step on disk (and > 0): pull from that peer; no disk read.
    2. **disk** — otherwise (no peers, peers behind disk, peers dead).

    Returns ``(source, depot_url, step)`` where source is "peer" or
    "disk"; for disk the url is None and step is ``disk_step``. A peer
    strictly BEHIND disk is never chosen — restoring older state than the
    controller-declared resume step would violate monotonic resume."""
    client = client or DepotClient()
    url, peer_step = client.best_peer(peers, ns, job,
                                      expect_world_size=expect_world_size)
    if url is not None and peer_step > 0 and peer_step >= disk_step:
        return "peer", url, peer_step
    return "disk", None, disk_step
