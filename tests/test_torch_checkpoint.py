"""The port's npy checkpoints against the JAX package's, on the CPU at tiny
sizes: a state saved by either package (sync and async) restores into the
other with every leaf bitwise equal, and both write the same manifest and
the same leaf files (tiny LM with AdamW behind a grad clip, tiny ResNet
with SGD and its BN state as ``extra``, a bfloat16 leaf); the drift and
world-size refusals; a crash at each phase of the async drain; the NaN
gate and keep-N; ``run_loop``'s save steps under ``device_loop`` against
the JAX loop's; the depot push and peer prefetch against the JAX
package's ``ShardDepot``; and the cadence directive with a stub context.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import resnet as jr  # noqa: E402
from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu.parallel import build_mesh  # noqa: E402
from tf_operator_tpu.rendezvous.statechannel import ShardDepot  # noqa: E402
from tf_operator_tpu.train import checkpoint as jck  # noqa: E402
from tf_operator_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tf_operator_tpu.train.trainer import TrainState as JaxTrainState  # noqa: E402
from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from tf_operator_tpu_torch.compat import tree_map  # noqa: E402
from tf_operator_tpu_torch.models import resnet as tr  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402
from tf_operator_tpu_torch.rendezvous import statechannel  # noqa: E402
from tf_operator_tpu_torch.train import checkpoint as ck  # noqa: E402
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig, _leaves  # noqa: E402
from tf_operator_tpu_torch.workloads.resnet import resnet_loss  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
MESH = build_mesh({"dp": 1}, devices=jax.devices()[:1])


def _models(name):
    """(port Trainer, JAX Trainer) of one tiny model and optimizer; the JAX
    trainer only traces (its template), it never compiles."""
    if name == "lm":
        tcfg, jcfg = tt.preset("tiny"), jt.preset("tiny")
        port = Trainer(loss_fn=None, init_fn=lambda g: tt.init_transformer(tcfg, g, "cpu"),
                       config=TrainerConfig(), device="cpu")
        jax_tr = JaxTrainer(MESH, loss_fn=None, init_fn=lambda k: jt.init_transformer(k, jcfg),
                            config=JaxTrainerConfig())
    else:
        tcfg, jcfg = tr.ResNetConfig.tiny(10), jr.ResNetConfig.tiny(10)
        conf = dict(optimizer="sgd", learning_rate=0.1, grad_clip=None)
        port = Trainer(loss_fn=lambda p, b, s: resnet_loss(p, b, s, tcfg),
                       init_fn=lambda g: tr.init_resnet(tcfg, g, "cpu"),
                       config=TrainerConfig(**conf), device="cpu")
        jax_tr = JaxTrainer(MESH, loss_fn=None, init_fn=lambda k: jr.init_resnet(k, jcfg),
                            config=JaxTrainerConfig(**conf))
    return port, jax_tr


def _busy_state(trainer, seed=7):
    """A port TrainState with every leaf nonzero: random moments (or
    trace), BN state and a step count of 3."""
    rng = np.random.RandomState(seed)
    state = trainer.init(0)
    rand = lambda t: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))  # noqa: E731
    opt = state.opt_state
    for k in [k for k in opt if k != "count"]:
        opt[k] = tree_map(rand, opt[k])
    opt["count"] = 3
    state.step = 3
    if state.extra is not None:
        state.extra = tree_map(rand, state.extra)
    return state


def _port_leaves(state):
    return [x for _, x in ck._flatten(ck._to_tree(state))]


def _same_dir(a, b):
    """Two step directories hold the same manifest and byte-equal leaves."""
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma == mb
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return ma


@pytest.mark.parametrize("model", ["lm", "resnet"])
@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_checkpoints_cross_both_ways_bitwise(tmp_path, model, async_save):
    """port save -> JAX restore -> JAX save -> port restore: the JAX
    package reads every port leaf bit for bit, writes back the same
    manifest and leaf files, and the port reads those back bit for bit."""
    port, jax_tr = _models(model)
    state = _busy_state(port)
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    ck.CheckpointManager(pdir, async_save=async_save).save(3, state, wait=True)
    jmgr = jck.CheckpointManager(str(jdir), backend="npy", async_save=async_save)
    js = jck.CheckpointManager(str(pdir), backend="npy").restore(jax_tr.state_template())
    want = _port_leaves(state)
    got = jax.tree_util.tree_leaves(jck._to_tree(js))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert w.dtype == np.asarray(g).dtype and np.array_equal(w, np.asarray(g))
    jmgr.save(3, js, wait=True)
    manifest = _same_dir(pdir / "step_3", jdir / "step_3")
    paths = [r["path"] for r in manifest["leaves"]]
    if model == "lm":
        assert paths[0] == "['opt_state'][1][0].count" and paths[-1] == "['step']"
        assert "['opt_state'][1][0].mu['embed']" in paths
    else:
        assert paths[0].startswith("['extra']") and "['opt_state'][0].trace['head']['w']" in paths
    template = port.state_template()
    back = ck.CheckpointManager(jdir).restore(template, device="cpu")
    assert back.step == 3 and back.opt_state["count"] == 3
    assert back.opt_state.chain == state.opt_state.chain
    for w, g in zip(want, _port_leaves(back)):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w.detach())
        else:
            assert int(g) == int(w)
    # what an evaluator restores: the params, and the BN state with them
    part = ck.CheckpointManager(jdir, readonly=True).restore_subtrees(
        {"params": template.params, "extra": template.extra}, device="cpu")
    assert (part["extra"] is None) == (state.extra is None)
    for got, ref in ((part["params"], state.params), (part["extra"] or {}, state.extra or {})):
        assert all(torch.equal(g, r.detach()) for g, r in zip(_leaves(got), _leaves(ref)))
    params = ck.CheckpointManager(jdir).restore_params(template.params, device="cpu")
    assert all(torch.equal(g, r.detach()) for g, r in zip(_leaves(params),
                                                          _leaves(state.params)))


def test_bf16_leaf_round_trips_as_jax_writes_it(tmp_path):
    """A bfloat16 leaf is a raw 2-byte .npy (descr <V2) with "bfloat16" in
    the manifest, the same file the JAX package writes, both ways."""
    bits = np.random.RandomState(0).randint(-2**15, 2**15, (5, 3)).astype(np.int16)
    w = torch.from_numpy(bits).view(torch.bfloat16)
    tree = {"w": w, "b": torch.arange(4, dtype=torch.float32)}
    ck.CheckpointManager(tmp_path / "port", async_save=True).save(1, tree, wait=True)
    jtree = jck.CheckpointManager(str(tmp_path / "port"), backend="npy").restore(
        {"w": jnp.zeros((5, 3), jnp.bfloat16), "b": jnp.zeros(4, jnp.float32)})
    assert jtree["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(jtree["w"]).view(np.int16), bits)
    jck.CheckpointManager(str(tmp_path / "jax"), backend="npy").save(1, jtree, wait=True)
    m = _same_dir(tmp_path / "port" / "step_1", tmp_path / "jax" / "step_1")
    assert m["leaves"][1] == {"path": "['w']", "index": 1, "shape": [5, 3], "dtype": "bfloat16"}
    back = ck.CheckpointManager(tmp_path / "jax").restore(
        {"w": torch.empty(5, 3, dtype=torch.bfloat16), "b": torch.empty(4)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"].view(torch.int16),
                                                             w.view(torch.int16))


@pytest.mark.parametrize("drift", ["tree", "shape", "dtype", "world"])
def test_drift_refused_as_jax_refuses(tmp_path, drift):
    """A restore whose template differs from the checkpoint in tree, leaf
    shape or dtype, or whose world differs from the writer's, raises
    ValueError in both packages on the same directory."""
    tree = {"a": torch.ones(3), "b": torch.zeros(2, 2)}
    ck.CheckpointManager(tmp_path, world_size=2, async_save=False).save(1, tree)
    tmpl = {"tree": {"a": torch.ones(3)},
            "shape": {"a": torch.ones(4), "b": torch.zeros(2, 2)},
            "dtype": {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.zeros(2, 2)},
            "world": tree}[drift]
    world = 4 if drift == "world" else 2
    match = {"tree": "does not match", "shape": "template expects",
             "dtype": "template expects", "world": "mixed-world"}[drift]
    with pytest.raises(ValueError, match=match):
        ck.CheckpointManager(tmp_path, world_size=world).restore(tmpl)
    jtmpl = {k: jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32) for k, v in tmpl.items()}
    with pytest.raises(ValueError, match=match):
        jck.CheckpointManager(str(tmp_path), backend="npy", world_size=world).restore(jtmpl)
    assert ck.checkpoint_world_size(str(tmp_path), 1) == jck.checkpoint_world_size(
        str(tmp_path), 1) == 2


# Save step 2 asynchronously and die (no cleanup) at the phase given.
CRASH_CHILD = """
import os, sys, torch
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
mgr = CheckpointManager(sys.argv[1])
mgr._fault_hook = lambda p, step: os._exit(0) if p == sys.argv[2] else None
mgr.save(2, {"x": torch.full((4,), 2.0)}, wait=True)
os._exit(1)  # the hook never fired
"""


@pytest.mark.parametrize("phase", ["leaf", "manifest", "commit"])
def test_crash_in_drain_leaves_no_step_and_orphan_is_swept(tmp_path, phase):
    """A process killed at any phase of the async drain leaves a
    .tmp_step_* orphan, never a discoverable step (for either package's
    reader); the next manager sweeps the orphan and a retry lands. A tmp
    dir carrying our own pid is never swept (a live drain may own it)."""
    root = tmp_path / "ckpt"
    ck.CheckpointManager(root).save(1, {"x": torch.ones(4)}, wait=True)
    child = subprocess.run([sys.executable, "-c", CRASH_CHILD, str(root), phase], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
    assert child.returncode == 0, child.stderr
    orphans = [n for n in os.listdir(root) if n.startswith(".tmp_step_2_")]
    assert len(orphans) == 1
    assert ck.latest_checkpoint_step(str(root)) == jck.latest_checkpoint_step(str(root)) == 1
    mine = root / f".tmp_step_9_{os.getpid()}"
    mine.mkdir()
    mgr = ck.CheckpointManager(root)
    assert sorted(n for n in os.listdir(root) if n.startswith(".tmp")) == [mine.name]
    assert mgr.all_steps() == [1]
    # an in-process failure surfaces at the next fence, then a retry lands
    def boom(p, step):
        if p == phase:
            raise RuntimeError(f"injected crash at {p}")

    mgr._fault_hook = boom
    assert mgr.save(2, {"x": torch.full((4,), 2.0)})
    with pytest.raises(RuntimeError, match="never committed"):
        mgr.wait_until_finished()
    mgr._fault_hook = None
    assert mgr.save(2, {"x": torch.full((4,), 2.0)}, wait=True)
    assert torch.equal(mgr.restore({"x": torch.empty(4)})["x"], torch.full((4,), 2.0))


def test_nan_gate_and_keep_n(tmp_path):
    """A save step whose loss is not finite raises and saves nothing;
    keep=2 keeps the newest two steps; the final save fences."""
    ckpt = ck.WorkloadCheckpointer({"checkpoint_dir": str(tmp_path), "checkpoint_every": 1,
                                    "checkpoint_keep": 2})
    with pytest.raises(AssertionError, match="refusing to checkpoint"):
        ckpt.advance({"x": torch.ones(2)}, loss=torch.tensor(float("nan")))
    assert ckpt.manager.all_steps() == []
    for _ in range(4):
        ckpt.advance({"x": torch.ones(2)}, loss=torch.tensor(1.0))
    ckpt.final({"x": torch.ones(2)})
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    assert len(ckpt.save_stalls) == 4 and ckpt.is_complete(4) and not ckpt.is_complete(5)


class _FakeTrainer:
    """A trainer over params {"w": x}, each step adding 1, in either
    package's TrainState and array library: enough for both packages'
    run_loop (the JAX one's multi_step included) and checkpoint trees."""

    def __init__(self, state_cls, lib):
        self.state_cls, self.lib = state_cls, lib

    def _state(self, w, step):
        return self.state_cls(params={"w": w}, opt_state=None, step=step)

    def restore_or_init(self, key, manager=None):
        if manager is not None and manager.latest_step() is not None:
            s = manager.latest_step()
            return self._state(self.lib.full((2,), float(s)), s)
        return self._state(self.lib.zeros(2), 0)

    def step(self, state, batch):
        return self._state(state.params["w"] + 1, state.step + 1), {"loss": 1.0}

    def multi_step(self, state, batch, k, stacked=False):
        return self._state(state.params["w"] + k, state.step + k), {"loss": 1.0}


@pytest.mark.parametrize("device_loop", [1, 3])
def test_run_loop_save_steps_match_jax(tmp_path, monkeypatch, device_loop):
    """Steps 8 with checkpoint_every 3: the steps saved, in order, and the
    steps on_step sees are the JAX loop's, fresh and after a resume."""
    def trace(mod_ck, trainer, sub):
        saved, seen = [], []
        real = mod_ck.CheckpointManager.save

        def save(self, step, state, wait=False):
            saved.append(step)
            return real(self, step, state, wait=wait)

        monkeypatch.setattr(mod_ck.CheckpointManager, "save", save)
        wl = {"checkpoint_dir": str(tmp_path / sub), "checkpoint_every": 3,
              "checkpoint_async": False, "checkpoint_backend": "npy"}
        for steps in (8, 12):  # a fresh run, then one resumed from step 9
            w = mod_ck.WorkloadCheckpointer(wl)
            w.run_loop(trainer, 0, None, steps, on_step=seen.append,
                       device_loop=device_loop)
            w.manager.close()
        return saved, seen

    got = trace(ck, _FakeTrainer(ck.TrainState, torch), "port")
    want = trace(jck, _FakeTrainer(JaxTrainState, jnp), "jax")
    assert got[0] == want[0] and got[1] == want[1], (got, want)
    assert ck.latest_checkpoint_step(str(tmp_path / "port")) == 13


def test_depot_push_and_peer_prefetch_against_jax_depot(tmp_path, monkeypatch):
    """Committed steps go to the JAX package's ShardDepot; a restore pulls
    them from a live peer past a dead one, and falls back to disk when
    every peer is dead or behind."""
    depot = ShardDepot()
    dead = "http://127.0.0.1:9"  # nothing listens on the discard port
    try:
        ctx = SimpleNamespace(namespace="ns", job_name="job", peer_depot=depot.url,
                              restore_peers=[])
        src = ck.WorkloadCheckpointer({"checkpoint_dir": str(tmp_path / "src"),
                                       "checkpoint_every": 2}, ctx=ctx)
        for _ in range(4):
            src.advance({"x": torch.arange(3.0)}, loss=1.0)
        src.manager.close()
        assert statechannel.DepotClient().steps(depot.url, "ns", "job") == [2, 4]
        ctx.restore_peers = [dead, depot.url]
        dst = ck.WorkloadCheckpointer({"checkpoint_dir": str(tmp_path / "dst")}, ctx=ctx)
        assert dst.prefetch_from_peers() == "peer"
        _same_dir(tmp_path / "src" / "step_4", tmp_path / "dst" / "step_4")
        ctx.restore_peers = [dead]
        cold = ck.WorkloadCheckpointer({"checkpoint_dir": str(tmp_path / "cold")}, ctx=ctx)
        assert cold.prefetch_from_peers() == "disk"
        # a live peer that dies mid-transfer: the next source is disk
        monkeypatch.setattr(statechannel.DepotClient, "fetch_step", lambda *a, **k: None)
        ctx.restore_peers = [depot.url]
        assert cold.prefetch_from_peers() == "disk"
    finally:
        depot.stop()


def test_cadence_directive_poll_and_ack(tmp_path):
    """The chief applies each cadence epoch once and acks it with the step;
    a stub context without the directive methods changes nothing."""
    acks = []
    directive = {"epoch": 1, "checkpoint_every": 5}
    ctx = SimpleNamespace(process_id=0, poll_checkpoint_cadence_directive=lambda: directive,
                          ack_checkpoint_cadence=lambda e, s: acks.append((e, s)))
    ckpt = ck.WorkloadCheckpointer({"checkpoint_dir": str(tmp_path), "checkpoint_every": 2,
                                    "cadence_poll_s": 0}, ctx=ctx)
    ckpt._step = 6
    assert ckpt.poll_cadence_directive() and ckpt.every == 5 and acks == [(1, 6)]
    assert not ckpt.poll_cadence_directive()  # the same epoch again
    directive["epoch"] = 2
    assert ckpt.poll_cadence_directive(step=9) and acks[-1] == (2, 9)
    bare = ck.WorkloadCheckpointer({"checkpoint_every": 2}, ctx=SimpleNamespace())
    assert not bare.poll_cadence_directive() and bare.every == 2
    worker = ck.WorkloadCheckpointer({"checkpoint_every": 2},
                                     ctx=SimpleNamespace(**{**vars(ctx), "process_id": 1}))
    assert not worker.poll_cadence_directive()


def test_trainer_restore_or_init_resumes_on_device(tmp_path):
    """restore_or_init: fresh init without a checkpoint; with one, the
    saved state on the trainer's device, params requiring grad, and a
    step that goes on from it."""
    port, _ = _models("lm")
    mgr = ck.CheckpointManager(tmp_path)
    fresh = port.restore_or_init(0, mgr)
    assert fresh.step == 0
    state = _busy_state(port)
    mgr.save(3, state, wait=True)
    back = port.restore_or_init(0, mgr)
    assert back.step == 3 and all(p.requires_grad and p.device.type == "cpu"
                                  for p in _leaves(back.params))
    assert all(not t.is_meta for t in _leaves(back.opt_state["mu"]))
