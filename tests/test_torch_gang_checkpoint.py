"""Checkpoints of a gang on gloo CPU gangs, held to the JAX package's readers.

One gang of four processes (gloo, one thread each, tiny shapes) is
spawned once for the module, at nice 10. It lives through two
incarnations: it joins a process group, runs the first half of every
case, leaves it, drops every object of the first and joins a second
group on another port (a gang restart: a new incarnation, a new tmp
token, nothing carried over but the disk). Two-rank cases run two at a
time on disjoint ranks.

- Same-mesh resume: the LM workload (``run_lm``) under fsdp 2, tp 2,
  ep 2 (gmm, ``tiny-moe``) and cp 2 (ring), and the ResNet workload
  (``run_resnet``) under dp 2 (the BN state replicated), each with an
  async and a sync checkpointer; the LM pipelined under pp 2 x tp 2 on
  all four ranks, async. The first incarnation trains 3 steps,
  saving at step 2, and stops after step 3 without its final save; the
  second runs the same job, which resumes from step 2 and runs step 3.
  Every restored leaf equals the one saved, bitwise, on every rank, and
  step 3's loss and gradient norm equal the first incarnation's.
- Re-cuts: the fsdp 2 step restored under tp 2 (second incarnation) and
  by one process (the test process), whose state, saved as a one-process
  step, the JAX package restores bitwise and an fsdp 2 gang restores
  (``allow_world_resize``); the pp 2 x tp 2 step restored by one process;
  every re-cut leaf equals the gathered state.
- A checkpoint-cadence directive mid-run under fsdp 2: the chief polls
  it, every rank saves at the new cadence from the same step, and every
  save commits.
- Torn and live saves: rank 1's drain stops for good at its second block
  (what a rank killed mid-drain leaves: some blocks, no marker); the
  chief's fence raises, neither package's reader finds the step, and the
  next incarnation's chief sweeps its tmp directory. A manager made by
  the same gang while its drains are live sweeps nothing of theirs.
- The JAX package reads a gang's step (``latest_checkpoint_step``,
  ``checkpoint_world_size``), refuses a mismatched world in the port's
  words, and its depot lists, picks and skips the gang's world-tagged
  step as it does its own; the second incarnation pulls that step from
  the depot into an empty directory and resumes from it.
- The Evaluator scores a gang's step as a plain recompute on the
  gathered params does.

Run as ``python tests/test_torch_gang_checkpoint.py RANK WORLD PORT_A
PORT_B DIR`` the file is one rank of the gang (it imports no jax then).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
JOB = ("ns", "gang-ckpt")  # the depot's namespace and job
LM_WL = {"steps": 2, "batch_size": 4, "seq_len": 16, "remat": "save_mid", "device": "cpu",
         "checkpoint_every": 2}
RESNET_WL = {"variant": "tiny", "num_classes": 10, "steps": 2, "batch_size": 4,
             "image_size": 32, "lr": 0.05, "device": "cpu", "checkpoint_every": 2}
# name -> (mesh axes, workload)
CASES = {
    "fsdp2": ({"fsdp": 2}, {**LM_WL, "preset": "tiny"}),
    "tp2": ({"tp": 2}, {**LM_WL, "preset": "tiny"}),
    "ep2": ({"ep": 2}, {**LM_WL, "preset": "tiny-moe", "moe_dispatch": "gmm"}),
    "cp2": ({"cp": 2}, {**LM_WL, "preset": "tiny", "attn": "ring"}),
    "resnet_dp2": ({"dp": 2}, RESNET_WL),
    "pp2tp2": ({"pp": 2, "tp": 2}, {**LM_WL, "preset": "tiny", "pp_microbatches": 2}),
}
MODES = ("async", "sync")
RUNS = [f"{c}_{m}" for c in CASES for m in MODES if c != "pp2tp2"] + ["pp2tp2_async"]
# each round's runs at once, on ranks 0-1 and 2-3 (a four-rank run alone)
ROUNDS = {
    "a": [[f"{c}_async", f"{c}_sync"] for c in CASES if c != "pp2tp2"] + [
        ["pp2tp2_async"], ["torn", "live"]],
    "b": [[f"{c}_async", f"{c}_sync"] for c in CASES if c != "pp2tp2"] + [
        ["pp2tp2_async"], ["recut_tp2", "sweep"], ["world1_fsdp2", "cadence"]],
}
# the cadence run: every 5 steps until the chief's directive (polled once
# the step reaches 2) sets every 2: saves at 4, 6 and the final 7
CADENCE_WL = {**LM_WL, "preset": "tiny", "steps": 6, "checkpoint_every": 5,
              "cadence_poll_s": 0}
COMMIT_TIMEOUT_S = 1.0  # the torn save's: the chief gives up this soon
TORN_HOLD_S = 6.0  # the torn rank's drain stays stopped this long


# ---------------------------------------------------------------------------
# one rank of the gang
# ---------------------------------------------------------------------------


def _wire(state) -> list:
    """A state's wire leaves as (path, numpy copy) pairs."""
    from tf_operator_tpu_torch.train import checkpoint as ck

    return [(p, x.detach().cpu().clone().numpy() if isinstance(x, torch.Tensor)
             else np.array(x)) for p, x in ck._flatten(ck._to_tree(state))]


def _lm_trainer(mesh, preset: str = "tiny"):
    """The LM workload's trainer (run_lm's optimizer) for restores."""
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = tt.preset(preset)
    return Trainer(loss_fn=None, init_fn=lambda g: tt.init_transformer(cfg, g, "cpu"),
                   config=TrainerConfig(optimizer="adamw", learning_rate=3e-4),
                   device="cpu", mesh=mesh,
                   logical_axes=None if mesh is None else tt.transformer_logical_axes(cfg))


class _Stop(Exception):
    """The first incarnation's end after step 3, before its final save."""


def _workload_run(name: str, phase: str, mesh, rank: int, conf: dict) -> dict:
    """One incarnation of a same-mesh case through its workload: what was
    saved at step 2 (first) or restored (second), the losses, the
    gradient norms and the checkpoint figures."""
    from tf_operator_tpu_torch.train.checkpoint import WorkloadCheckpointer
    from tf_operator_tpu_torch.workloads import lm, resnet

    case, mode = name.rsplit("_", 1)
    axes, wl = CASES[case]
    d = conf["dirs"][name]
    ctx = SimpleNamespace(num_processes=int(mesh.mesh.numel()), process_id=rank,
                          namespace=JOB[0], job_name=JOB[1], peer_depot="", restore_peers=[])
    if name == "fsdp2_async":  # through the depot: pushed, then pulled into an empty dir
        if phase == "a":
            ctx.peer_depot = conf["depot"]
        else:
            ctx.restore_peers, d = [conf["depot"]], conf["dirs"]["fsdp2_peer"]
    wl = {**wl, "checkpoint_dir": d, "checkpoint_async": mode == "async",
          "checkpoint_digests": name == "tp2_async"}
    ck = WorkloadCheckpointer(wl, ctx=ctx, mesh=mesh)
    out = {"saved": None, "restored": None}
    save, restore = ck.manager.save, ck.restore_or_init

    def saving(step, state, wait=False):
        if step == 2:
            out["saved"] = _wire(state)
        return save(step, state, wait=wait)

    def restoring(trainer, seed=0):
        state = restore(trainer, seed)
        out["restored"] = _wire(state)
        return state

    ck.manager.save, ck.restore_or_init = saving, restoring

    def on_step(step):
        if phase == "a" and step == 3:
            raise _Stop

    run = resnet.run_resnet if case == "resnet_dp2" else lm.run_lm
    try:
        run(wl, device="cpu", ckpt=ck, mesh=mesh, on_step=on_step)
    except _Stop:
        pass
    out.update(losses=[float(x) for x in ck.step_losses],
               grad_norms=[float(x) for x in ck.step_grad_norms], start=ck.start_step,
               source=ck.restore_source, report=ck.report())
    return out


def _torn(mesh, rank: int, conf: dict) -> dict:
    """Step 1 commits; at step 2 rank 1's drain stops for good at its
    second block: the chief's fence raises."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    trainer = _lm_trainer(mesh)
    mgr = CheckpointManager(conf["dirs"]["torn"], mesh=mesh, commit_timeout_s=COMMIT_TIMEOUT_S)
    trainer.bind_checkpoints(mgr)
    state = trainer.init(0)
    mgr.save(1, state, wait=True)
    blocks = []

    def killed(phase, step):
        if phase == "leaf" and step == 2:
            blocks.append(step)
            if len(blocks) == 2:
                threading.Event().wait(TORN_HOLD_S)
                raise RuntimeError("this rank died mid-drain")

    if rank == 1:
        mgr._fault_hook = killed
    mgr.save(2, state)
    if rank == 1:
        return {}
    try:
        mgr.wait_until_finished()
    except RuntimeError as exc:
        return {"error": str(exc)}
    return {"error": None}


def _live(mesh, rank: int, conf: dict) -> dict:
    """A second manager made while the gang's drains hold before their
    markers: the chief's sweep leaves their tmp directory alone."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    d = conf["dirs"]["live"]
    trainer = _lm_trainer(mesh)
    mgr = CheckpointManager(d, mesh=mesh)
    trainer.bind_checkpoints(mgr)
    reached, release = threading.Event(), threading.Event()

    def hold(phase, step):
        if phase == "manifest":
            reached.set()
            release.wait(60)

    mgr._fault_hook = hold
    mgr.save(1, trainer.init(0))
    assert reached.wait(60)
    CheckpointManager(d, mesh=mesh)  # a sweep by the same incarnation's chief
    live = sorted(n for n in os.listdir(d) if n.startswith(".tmp_step_"))
    release.set()
    mgr.wait_until_finished()
    return {"live": live, "steps": mgr.all_steps()}


def _restored_by(mesh, d: str, world_size: int, **kw) -> dict:
    """This rank's leaves restored from ``d`` by the LM trainer on
    ``mesh``, and the restore's figures."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(d, readonly=True, mesh=mesh, world_size=world_size, **kw)
    state = _lm_trainer(mesh).restore_or_init(0, mgr)
    return {"restored": _wire(state), "restore": mgr.last_restore}


def _cadence(mesh, rank: int, conf: dict) -> dict:
    """The LM workload under a cadence directive the chief polls mid-run:
    each rank's saves, the acks it sent, its cadence and the committed
    steps."""
    from tf_operator_tpu_torch.train.checkpoint import WorkloadCheckpointer
    from tf_operator_tpu_torch.workloads import lm

    wl = {**CADENCE_WL, "checkpoint_dir": conf["dirs"]["cadence"]}
    acks = []
    ctx = SimpleNamespace(
        num_processes=2, process_id=rank, namespace=JOB[0], job_name=JOB[1], peer_depot="",
        restore_peers=[], ack_checkpoint_cadence=lambda e, s: acks.append((e, s)),
        poll_checkpoint_cadence_directive=lambda: (
            {"epoch": 1, "checkpoint_every": 2} if ck._step >= 2 else None))
    ck = WorkloadCheckpointer(wl, ctx=ctx, mesh=mesh)
    lm.run_lm(wl, device="cpu", ckpt=ck, mesh=mesh)
    return {"saves": [x["step"] for x in ck.manager.saves], "acks": acks, "every": ck.every,
            "steps": ck.manager.all_steps()}


def _run(name: str, phase: str, mesh, rank: int, conf: dict) -> dict:
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    dirs = conf["dirs"]
    if name in RUNS:
        return _workload_run(name, phase, mesh, rank, conf)
    if name == "torn":
        return _torn(mesh, rank, conf)
    if name == "live":
        return _live(mesh, rank, conf)
    if name == "cadence":
        return _cadence(mesh, rank, conf)
    if name == "recut_tp2":
        return _restored_by(mesh, dirs["fsdp2_async"], 2)
    if name == "sweep":  # the next incarnation's chief sweeps the torn save
        CheckpointManager(dirs["torn"], mesh=mesh)
        return {"names": sorted(os.listdir(dirs["torn"]))}
    assert name == "world1_fsdp2"
    t0 = time.perf_counter()
    while not os.path.exists(dirs["world1_ready"]):
        assert time.perf_counter() - t0 < 240, "no world-1 step in 240 s"
        time.sleep(0.05)
    try:
        _restored_by(mesh, dirs["world1"], 2)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return {**_restored_by(mesh, dirs["world1"], 2, allow_world_resize=True),
            "refused": refused}


def _n(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def _axes(name: str) -> dict:
    if name in RUNS:
        return CASES[name.rsplit("_", 1)[0]][0]
    return {"tp": 2} if name == "recut_tp2" else {"fsdp": 2}


def _worker(rank: int, world: int, ports: list, d: Path) -> None:
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import device_mesh, mesh_ranks

    torch.set_num_threads(1)
    conf = json.loads((d / "conf.json").read_text())
    for phase, port in zip("ab", ports):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=120))
        for rnd in ROUNDS[phase]:
            # every rank takes part in building every mesh
            first, meshes = 0, []
            for name in rnd:
                n = _n(_axes(name))
                meshes.append((name, first, n, device_mesh(*mesh_ranks(_axes(name),
                                                                       range(first, first + n)))))
                first += n
            for name, first, n, mesh in meshes:
                if first <= rank < first + n:
                    out = _run(name, phase, mesh, rank - first, conf)
                    path = d / f"{phase}_{name}.{rank - first}.pt"
                    torch.save(out, path.with_suffix(".tmp"))
                    os.replace(path.with_suffix(".tmp"), path)  # whole when it appears
        dist.barrier()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Gang:
    """The gang's processes, started at once; each rank writes each result
    to a file in ``d`` as soon as it has it."""

    def __init__(self, d: Path, conf: dict) -> None:
        self.d = d
        (d / "conf.json").write_text(json.dumps(conf))
        env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get(
            "PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
        ports = [str(_free_port()), str(_free_port())]
        self.logs = {r: open(d / f"rank{r}.log", "w") for r in range(WORLD)}
        self.procs = {r: subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), *ports,
                                           str(d)], env=env, stdout=self.logs[r],
                                          stderr=subprocess.STDOUT) for r in range(WORLD)}
        self.t0 = time.perf_counter()
        self.rcs = None

    def wait(self) -> None:
        if self.rcs is None:
            self.rcs = {r: p.wait(timeout=300) for r, p in self.procs.items()}
            for f in self.logs.values():
                f.close()
        logs = "\n".join((self.d / f"rank{r}.log").read_text()[-3000:] for r in self.procs)
        assert set(self.rcs.values()) == {0}, f"exit codes {self.rcs}:\n{logs}"

    def result(self, phase: str, name: str) -> list:
        """A run's ranks' results, as soon as they are written."""
        paths = [self.d / f"{phase}_{name}.{i}.pt" for i in range(_n(_axes(name)))]
        while not all(p.exists() for p in paths):
            if any(p.poll() not in (None, 0) for p in self.procs.values()) or all(
                    p.poll() is not None for p in self.procs.values()):
                self.wait()  # fails with the processes' logs
                assert False, f"the gang ended without {phase}_{name}"
            assert time.perf_counter() - self.t0 < 300, f"no {phase}_{name} in 300 s"
            time.sleep(0.05)
        return [torch.load(p, weights_only=False) for p in paths]

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def depot():
    from tf_operator_tpu.rendezvous.statechannel import ShardDepot

    dep = ShardDepot()
    try:
        yield dep
    finally:
        dep.stop()


@pytest.fixture(scope="module")
def gang(tmp_path_factory, depot):
    d = tmp_path_factory.mktemp("gloo-gang-ckpt")
    names = RUNS + ["fsdp2_peer", "torn", "live", "world1", "cadence"]
    conf = {"depot": depot.url, "dirs": {n: str(d / "ckpt" / n) for n in names}}
    conf["dirs"]["world1_ready"] = str(d / "world1.ready")
    g = _Gang(d, conf)
    g.conf = conf
    try:
        yield g
        g.wait()  # every process ended cleanly
    finally:
        g.close()


def _host_mesh(axes: dict):
    from tf_operator_tpu_torch.parallel.mesh import device_mesh, mesh_ranks

    return device_mesh(*mesh_ranks(axes, range(_n(axes))))


def _manifest(d: str, step: int) -> dict:
    return json.loads((Path(d) / f"step_{step}" / "manifest.json").read_text())


def _gathered(per_rank: list, manifest: dict, axes: dict) -> list:
    """Whole leaves from the ranks' (path, block) lists, placed as the
    manifest's leaves are."""
    from tf_operator_tpu_torch.parallel.sharding import gather_shards

    mesh = _host_mesh(axes)
    out = []
    for i, rec in enumerate(manifest["leaves"]):
        paths = {r[i][0] for r in per_rank}
        assert paths == {rec["path"]}, (paths, rec["path"])
        out.append((rec["path"], gather_shards({r: x[i][1] for r, x in enumerate(per_rank)},
                                               mesh, [tuple(p) if isinstance(p, list) else p
                                                      for p in rec["placement"]])))
    return out


def _equal(got: list, want: list, what: str) -> None:
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {path}"
        assert np.array_equal(a, b), f"{what} {path}"


@pytest.mark.parametrize("name", RUNS)
def test_same_mesh_resume_is_bitwise(gang, name):
    """The second incarnation resumes from step 2 on every rank; each
    rank's restored leaves are the ones it saved, bitwise; step 3's loss
    and gradient norm are the first incarnation's (its uninterrupted
    step 3); it reads only its own blocks, and its final save commits."""
    first, second = gang.result("a", name), gang.result("b", name)
    for rank, (a, b) in enumerate(zip(first, second)):
        assert a["start"] == 0 and len(a["losses"]) == 3 and b["start"] == 2, (a, b)
        _equal(b["restored"], a["saved"], f"{name} rank {rank} restored vs saved")
        assert b["losses"] == a["losses"][2:] and b["grad_norms"] == a["grad_norms"][2:]
        assert b["report"]["restore"]["step"] == 2 and not b["report"]["restore"]["recut"]
        save = a["report"]["saves"][0]
        assert save["step"] == 2 and save["stall_s"] >= 0
        assert save["drain_s"] <= save["commit_s"] and (save["bytes"] > 0) == (save["blocks"] > 0)
    # the owners' blocks: one copy of each, every one written
    axes = CASES[name.rsplit("_", 1)[0]][0]
    d = gang.conf["dirs"]["fsdp2_peer" if name == "fsdp2_async" else name]
    m = _manifest(d, 3)
    assert m["world_size"] == _n(axes) and m["mesh"]["shape"] == list(axes.values())
    files = sorted(b["file"] for rec in m["leaves"] for b in rec["blocks"])
    assert files == sorted(n for n in os.listdir(Path(d) / "step_3") if n != "manifest.json")
    written = sum(x["report"]["saves"][-1]["blocks"] for x in second)
    assert written == len(files)
    if name == "fsdp2_async":
        assert [x["source"] for x in second] == ["peer", "peer"]
    if name == "tp2_async":  # checkpoint_digests: each block's sha256 as its file holds it
        step_dir = Path(gang.conf["dirs"][name]) / "step_2"
        digests = {f: h for a in first for f, h in a["report"]["saves"][0]["digests"].items()}
        assert sorted(digests) == sorted(b["file"] for rec in _manifest(step_dir.parent, 2)[
            "leaves"] for b in rec["blocks"])
        for f, h in digests.items():
            body = np.ascontiguousarray(np.load(step_dir / f)).reshape(-1).view(np.uint8)
            assert hashlib.sha256(body).hexdigest() == h, f


@pytest.fixture(scope="module")
def jax_template():
    """The JAX Trainer's state template of the gang's LM (tiny, AdamW
    behind the clip): it only traces."""
    import jax

    from tf_operator_tpu.models import transformer as jt
    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu.train.trainer import Trainer as JaxTrainer
    from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    return JaxTrainer(mesh, loss_fn=None,
                      init_fn=lambda k: jt.init_transformer(k, jt.preset("tiny")),
                      config=JaxTrainerConfig(learning_rate=3e-4)).state_template()


def test_gang_step_read_by_jax(gang, jax_template):
    """The JAX package's readers see the gang's step 2 and its world of 2;
    replicated leaves have one block, written by rank 0, split ones one a
    rank; the JAX npy manager finds no leaf file of its layout in the
    sharded step and raises rather than read it."""
    from tf_operator_tpu.train import checkpoint as jck

    gang.result("a", "fsdp2_async")
    d = gang.conf["dirs"]["fsdp2_async"]  # the second incarnation resumes elsewhere
    assert jck.latest_checkpoint_step(d) == 2 and jck.checkpoint_world_size(d, 2) == 2
    m = _manifest(d, 2)
    by_path = {rec["path"]: rec for rec in m["leaves"]}
    assert [b["rank"] for b in by_path["['step']"]["blocks"]] == [0]
    assert [b["rank"] for b in by_path["['params']['embed']"]["blocks"]] == [0, 1]
    assert by_path["['params']['embed']"]["placement"] == [None, "fsdp"]
    with pytest.raises(FileNotFoundError, match="leaf_0.npy"):
        jck.CheckpointManager(d, backend="npy", world_size=2).restore(jax_template)


def test_mismatched_world_raises_jax_words(gang):
    """A restore of the gang's world-2 step by a world of 4 raises, in the
    JAX package's words, in both packages."""
    from tf_operator_tpu.train import checkpoint as jck
    from tf_operator_tpu_torch.train import checkpoint as ck

    gang.result("a", "fsdp2_sync")
    d = gang.conf["dirs"]["fsdp2_sync"]
    with pytest.raises(ValueError) as port:
        ck.CheckpointManager(d, readonly=True, world_size=4).restore(
            _lm_trainer(None).state_template(), step=2, device="cpu")
    with pytest.raises(ValueError) as ref:
        jck.CheckpointManager(d, backend="npy", world_size=4)._check_restore_world(
            _manifest(d, 2), 2)
    assert str(port.value) == str(ref.value)


@pytest.fixture(scope="module")
def world1(gang):
    """The fsdp 2 step re-cut to one process (the test process), and that
    state saved as a one-process step, which the gang then restores."""
    from tf_operator_tpu_torch.train import checkpoint as ck

    first = gang.result("a", "fsdp2_async")
    d = gang.conf["dirs"]["fsdp2_async"]
    mgr = ck.CheckpointManager(d, readonly=True, world_size=1, allow_world_resize=True)
    state = mgr.restore(_lm_trainer(None).state_template(), step=2, device="cpu")
    ck.CheckpointManager(gang.conf["dirs"]["world1"], async_save=False).save(2, state)
    Path(gang.conf["dirs"]["world1_ready"]).touch()
    gathered = _gathered([r["saved"] for r in first], _manifest(d, 2), {"fsdp": 2})
    return state, gathered, mgr.last_restore


def test_recut_fsdp2_to_world1_then_jax_restores_it(world1, gang, jax_template):
    """One process re-cuts the gang's step: every leaf the gathered state,
    bitwise; the JAX npy manager restores its one-process save into JAX's
    template bitwise."""
    import jax

    from tf_operator_tpu.train import checkpoint as jck

    state, gathered, restore = world1
    _equal(_wire(state), gathered, "world-1 re-cut vs gathered")
    assert restore["recut"] and restore["blocks_read"] > len(gathered)
    js = jck.CheckpointManager(gang.conf["dirs"]["world1"], backend="npy").restore(
        jax_template)
    got = jax.tree_util.tree_leaves(jck._to_tree(js))
    assert len(got) == len(gathered)
    for (path, want), g in zip(gathered, got):
        assert np.asarray(g).dtype == want.dtype and np.array_equal(np.asarray(g), want), path


def test_recut_world1_to_fsdp2(world1, gang):
    """An fsdp 2 gang restores the one-process step only as an explicit
    resize, and then holds exactly its blocks of the whole state."""
    _, gathered, _ = world1
    res = gang.result("b", "world1_fsdp2")
    assert all("mixed-world" in r["refused"] for r in res)
    assert all(r["restore"]["recut"] for r in res)
    m = _manifest(gang.conf["dirs"]["fsdp2_async"], 2)
    _equal(_gathered([r["restored"] for r in res], m, {"fsdp": 2}), gathered,
           "world 1 -> fsdp 2")


def test_recut_fsdp2_to_tp2(world1, gang):
    """A tp 2 gang restores the fsdp 2 step: its blocks gathered under tp
    2's placements are the gathered fsdp 2 state, bitwise."""
    _, gathered, _ = world1
    res = gang.result("b", "recut_tp2")
    assert all(r["restore"]["recut"] for r in res)
    m = _manifest(gang.conf["dirs"]["tp2_async"], 2)
    _equal(_gathered([r["restored"] for r in res], m, {"tp": 2}), gathered, "fsdp 2 -> tp 2")


def test_recut_pp2tp2_to_world1(gang):
    """One process re-cuts the pp 2 x tp 2 step (each rank its stage's
    layers, their tp blocks): every leaf the gathered state, bitwise."""
    from tf_operator_tpu_torch.train import checkpoint as ck

    first = gang.result("a", "pp2tp2_async")
    d = gang.conf["dirs"]["pp2tp2_async"]
    m = _manifest(d, 2)
    assert any(rec["placement"][:1] == ["pp"] for rec in m["leaves"])
    mgr = ck.CheckpointManager(d, readonly=True, world_size=1, allow_world_resize=True)
    state = mgr.restore(_lm_trainer(None).state_template(), step=2, device="cpu")
    assert mgr.last_restore["recut"]
    _equal(_wire(state), _gathered([r["saved"] for r in first], m, {"pp": 2, "tp": 2}),
           "pp 2 x tp 2 -> world 1")


def test_cadence_directive_reaches_every_rank(gang):
    """The chief's directive (every 5 -> every 2, polled at step 2) takes
    effect on both ranks at the same step: each saves at 4, 6 and 7, every
    save commits, and the chief alone acks, once."""
    res = gang.result("b", "cadence")
    for rank, r in enumerate(res):
        assert r["saves"] == [4, 6, 7] and r["every"] == 2, r
        assert r["acks"] == ([(1, 2)] if rank == 0 else []), r
    assert res[0]["steps"] == [4, 6, 7]
    d = Path(gang.conf["dirs"]["cadence"])
    assert all((d / f"step_{s}" / "manifest.json").exists() for s in (4, 6, 7))


def test_torn_save_is_never_a_step_and_is_swept(gang):
    """Rank 1 stopped mid-drain: the chief's fence raises, both packages'
    readers stay at step 1, the tmp directory stays until the next
    incarnation's chief sweeps it."""
    from tf_operator_tpu.train import checkpoint as jck
    from tf_operator_tpu_torch.train import checkpoint as ck

    chief = gang.result("a", "torn")[0]
    assert "never committed" in chief["error"] and "rank(s) [1]" in chief["error"]
    d = gang.conf["dirs"]["torn"]
    assert jck.latest_checkpoint_step(d) == ck.latest_checkpoint_step(d) == 1
    swept = gang.result("b", "sweep")[0]["names"]
    assert swept == ["step_1"], swept


def test_live_drain_is_not_swept(gang):
    """A manager made by the gang while its drains are live leaves their
    tmp directory alone, and the step then commits."""
    for r in gang.result("a", "live"):
        assert len(r["live"]) == 1 and r["live"][0].startswith(".tmp_step_1_g"), r
        assert r["steps"] == [1]


def test_depot_picks_and_skips_gang_steps_as_jax_steps(gang, depot, tmp_path):
    """The chief pushed the whole step directory; the JAX depot tags it
    with the world of 2, and JAX's restore-source choice picks it for a
    world of 2 and skips it for 1, as it does a JAX one-process step's
    world in reverse."""
    from tf_operator_tpu.rendezvous import statechannel as jsc
    from tf_operator_tpu.train import checkpoint as jck

    gang.result("a", "fsdp2_async")
    client = jsc.DepotClient()
    step_dir = Path(gang.conf["dirs"]["fsdp2_async"]) / "step_2"
    assert sorted(depot.files(*JOB, 2)) == sorted(os.listdir(step_dir))
    assert client.step_worlds(depot.url, *JOB) == {2: 2}
    jmgr = jck.CheckpointManager(str(tmp_path / "solo"), backend="npy", world_size=1)
    jmgr.save(5, {"x": np.arange(3.0)}, wait=True)
    assert client.push_step(depot.url, JOB[0], "solo", 5, str(tmp_path / "solo" / "step_5"))
    for job, step, world, other in ((JOB[1], 2, 2, 1), ("solo", 5, 1, 2)):
        assert jsc.choose_restore_source([depot.url], JOB[0], job, 0, client=client,
                                         expect_world_size=world) == ("peer", depot.url, step)
        assert jsc.choose_restore_source([depot.url], JOB[0], job, 0, client=client,
                                         expect_world_size=other) == ("disk", None, 0)


def test_evaluator_scores_a_gang_step(world1, gang, tmp_path):
    """The Evaluator (one process) restores the fsdp 2 step whole through
    the re-cut and scores it as a plain recompute on the gathered params."""
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.workloads import eval as ev

    _, gathered, _ = world1
    wl = {"model": "lm", "preset": "tiny", "checkpoint_dir": gang.conf["dirs"]["fsdp2_async"],
          "eval_batch_size": 2, "eval_seq_len": 16, "eval_batches": 2, "train_steps": 0,
          "device": "cpu", "eval_report": str(tmp_path / "report.json")}
    ev.main(SimpleNamespace(workload=wl))
    scored = json.loads((tmp_path / "report.json").read_text())
    cfg = tt.preset_from_workload(wl)
    params = {}
    for path, x in gathered:
        if path.startswith("['params']"):
            keys = path[len("['params']"):].strip("[]'").split("']['")
            node = params
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = torch.from_numpy(x)
    with torch.no_grad():
        losses = [tt.lm_loss_and_metrics(params, tok, cfg)[1]["ce_loss"]
                  for tok in ev.lm_eval_batches(wl, cfg, torch.device("cpu"))]
    assert list(scored) == ["2"] and scored["2"] == sum(float(x) for x in losses) / len(losses)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    # below the test runner's own processes: on a loaded host the gang
    # yields the cores to the other test files
    os.nice(10)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3:5], Path(sys.argv[5]))
