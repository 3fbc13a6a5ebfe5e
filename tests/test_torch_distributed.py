"""The port's sharded training steps on gloo CPU gangs against the JAX package.

One gang of four processes (gloo, one thread each, f32, tiny shapes) is
spawned once for the module and runs every case; a two-device case runs
on ranks 0-1 while another runs on ranks 2-3. Meanwhile the test process
runs the JAX package's Trainer on the same mesh over its CPU devices
(tests/conftest.py makes eight), from the same converted init and batch,
and the port's single-process step. Each rank writes its losses, its
gradient norms and its param blocks; the test gathers the blocks
(``compat.gather_params``) and holds them to both.

- LM: tiny causal, dense and flash attention, ``save_mid`` remat, two
  AdamW steps with the clip active, under dp 2, fsdp 2, tp 2, tp 4 (tiny
  has 2 KV heads: the K/V repeat), fsdp 2 x tp 2 and dp 2 x tp 2.
- MLM: tiny bidirectional under fsdp 2, JAX's PRNGKey(0) mask fed to
  both; the loss's denominator is the global batch's; the port's default
  mask cut to a rank's rows gives the single-process loss.
- ResNet: the test ResNet under dp 2, fused 1x1 and not: loss, BN state
  and params (synced batch norm).
- The tp pair: ``tp_region_enter``/``tp_region_exit`` gradients against
  JAX's ``custom_vjp`` pair in a ``shard_map``; the ring shift and its
  transpose.

Run as ``python tests/test_torch_distributed.py RANK WORLD PORT DIR`` the
file is one rank of the gang (it imports no jax then).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
B, T = 4, 16  # the global LM batch
LR, WD, CLIP = 3e-3, 0.1, 1.0
STEPS = 2
RESNET_LR, RESNET_IMAGE = 0.05, 64
LM_MESHES = {"dp2": {"dp": 2}, "fsdp2": {"fsdp": 2}, "tp2": {"tp": 2}, "tp4": {"tp": 4},
             "fsdp2_tp2": {"fsdp": 2, "tp": 2}, "dp2_tp2": {"dp": 2, "tp": 2}}
ATTNS = ("dense", "flash")
# f32 on both sides; only the order of sums differs (the sharded products,
# the reductions over ranks, the gathered norm)
ATOL = 1e-5


def _n(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def _cases() -> list:
    """Rounds of cases: each round's cases run at once on disjoint ranks."""
    lm = [dict(name=f"lm_{m}_{a}", kind="lm", axes=axes, attn=a)
          for m, axes in LM_MESHES.items() for a in ATTNS]
    two = [c for c in lm if _n(c["axes"]) == 2]
    four = [c for c in lm if _n(c["axes"]) == 4]
    rounds = [two[i:i + 2] for i in range(0, len(two), 2)] + [[c] for c in four]
    rounds.append([dict(name="mlm_fsdp2", kind="mlm", axes={"fsdp": 2}),
                   dict(name="tp_pair", kind="tp_pair", axes={"tp": 2})])
    rounds.append([dict(name="resnet_dp2_unfused", kind="resnet", axes={"dp": 2}, fused=False),
                   dict(name="resnet_dp2_fused", kind="resnet", axes={"dp": 2}, fused=True)])
    return rounds


CASES = {c["name"]: c for r in _cases() for c in r}


# ---------------------------------------------------------------------------
# the inputs both packages see
# ---------------------------------------------------------------------------


def _tiny(causal=True, attn="dense"):
    from tf_operator_tpu_torch.models import transformer as tt

    return tt.preset("tiny", dtype=torch.float32, attn_impl=attn, remat="save_mid",
                     causal=causal)


def _resnet_cfg(fused: bool):
    from tf_operator_tpu_torch.models import resnet as tr

    return tr.ResNetConfig((1, 1, 1, 1), (16, 32, 64, 128), 10, dtype=torch.float32,
                           fused_1x1=fused)


def _inputs() -> dict:
    """Params and batches for every case (numpy), made from seeds."""
    from tf_operator_tpu_torch.models import resnet as tr
    from tf_operator_tpu_torch.models import transformer as tt

    rng = np.random.RandomState(3)
    rparams, rstate = _to_numpy(tr.init_resnet(_resnet_cfg(False),
                                               torch.Generator().manual_seed(1), "cpu"))
    return {
        "lm_params": tt.init_transformer_numpy(_tiny(), 0),
        "tokens": np.random.RandomState(1).randint(0, 256, (B, T)),
        "mlm_params": tt.init_transformer_numpy(_tiny(causal=False), 5),
        "resnet_params": rparams, "resnet_state": rstate,
        "images": rng.randn(4, RESNET_IMAGE, RESNET_IMAGE, 3).astype(np.float32),
        "labels": rng.randint(0, 10, 4),
        "tp_x": np.random.RandomState(7).randn(4, 8).astype(np.float32),
        "tp_w1": np.random.RandomState(8).randn(8, 6).astype(np.float32),
        "tp_w2": np.random.RandomState(9).randn(6, 8).astype(np.float32),
    }


def _to_numpy(tree):
    from tf_operator_tpu_torch import compat

    return compat.params_to_numpy(tree)


def _trainer_config(kind: str):
    from tf_operator_tpu_torch.train.trainer import TrainerConfig

    if kind == "resnet":
        return TrainerConfig(optimizer="sgd", learning_rate=RESNET_LR, grad_clip=None)
    return TrainerConfig(learning_rate=LR, weight_decay=WD, grad_clip=CLIP)


# ---------------------------------------------------------------------------
# one rank of the gang
# ---------------------------------------------------------------------------


def _run_case(case: dict, mesh, inp: dict, rank: int) -> dict:
    """This rank's part of one case: losses, grad norms, param blocks."""
    from tf_operator_tpu_torch import compat
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.parallel import collectives as coll
    from tf_operator_tpu_torch.parallel.sharding import MeshPlan
    from tf_operator_tpu_torch.train.trainer import Trainer
    from tf_operator_tpu_torch.workloads import resnet as rw

    plan = MeshPlan(mesh)
    if case["kind"] == "tp_pair":
        x = torch.from_numpy(inp["tp_x"]).requires_grad_(True)
        i = coll.axis_index(mesh, "tp")
        w1 = torch.from_numpy(inp["tp_w1"][:, 3 * i:3 * i + 3].copy()).requires_grad_(True)
        w2 = torch.from_numpy(inp["tp_w2"][3 * i:3 * i + 3].copy()).requires_grad_(True)
        z = coll.tp_region_exit(coll.tp_region_enter(x, mesh) @ w1 @ w2, mesh)
        loss = (z * z).sum()
        loss.backward()
        # the ring shift: index i receives index i - 1's block; its
        # cotangent goes back the other way
        r = torch.full((3,), float(i + 1), requires_grad=True)
        shifted = coll.ring_shift(r, mesh, "tp")
        (shifted * torch.arange(3.0) * (i + 1)).sum().backward()
        return {"loss": float(loss), "dx": x.grad.numpy(), "dw1": w1.grad.numpy(),
                "dw2": w2.grad.numpy(), "shifted": shifted.detach().numpy(),
                "shift_grad": r.grad.numpy(), "tp_index": i}
    if case["kind"] == "resnet":
        cfg = _resnet_cfg(case["fused"])
        trainer = Trainer(lambda p, b, s: rw.resnet_loss(p, b, s, cfg, mesh), None,
                          _trainer_config("resnet"), device="cpu", mesh=mesh)
        state = trainer.state_from_params(compat.params_from_numpy(inp["resnet_params"], "cpu"),
                                          compat.params_from_numpy(inp["resnet_state"], "cpu"))
        batch = (plan.data_rows(torch.from_numpy(inp["images"])),
                 plan.data_rows(torch.from_numpy(inp["labels"])))
    else:
        mlm = case["kind"] == "mlm"
        cfg = _tiny(causal=not mlm, attn=case.get("attn", "dense"))
        axes = tt.transformer_logical_axes(cfg)
        full = inp["mlm_params" if mlm else "lm_params"]
        mask = (plan.data_rows(torch.from_numpy(inp["mask"])) if mlm else None)
        trainer = Trainer(lambda p, b, e: tt.lm_loss(p, b, cfg, mesh=mesh, mask=mask), None,
                          _trainer_config("lm"), device="cpu", mesh=mesh, logical_axes=axes)
        state = trainer.state_from_params(compat.params_from_numpy(
            compat.shard_params(full, mesh, axes, rank), "cpu"))
        batch = plan.data_rows(torch.from_numpy(inp["tokens"]))
    out = {"losses": [], "grad_norms": []}
    if case["kind"] == "mlm":
        with torch.no_grad():  # the default mask: the global batch's, cut to these rows
            out["default_mask_loss"] = float(tt.lm_loss(state.params, batch, cfg, mesh=mesh))
    out["grads"] = _to_numpy(trainer.gradients(state, batch)[1])
    for _ in range(STEPS):
        state, m = trainer.step(state, batch)
        out["losses"].append(float(m["loss"]))
        if "grad_norm" in m:
            out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = _to_numpy(state.params)
    if state.extra is not None:
        out["extra"] = _to_numpy(state.extra)
    return out


def _worker(rank: int, world: int, port: int, d: Path) -> None:
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import device_mesh, mesh_ranks

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    inp = torch.load(d / "inputs.pt", weights_only=False)
    for rnd in _cases():
        start, meshes = 0, []
        for case in rnd:  # every rank takes part in building every mesh
            n = _n(case["axes"])
            names, arr = mesh_ranks(case["axes"], range(start, start + n))
            meshes.append((case, start, n, device_mesh(names, arr)))
            start += n
        for case, first, n, mesh in meshes:
            if first <= rank < first + n:
                out = _run_case(case, mesh, inp, rank)
                path = d / f"{case['name']}.{rank - first}.pt"
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
    def __init__(self, d: Path) -> None:
        self.d = d
        env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get(
            "PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
        port = _free_port()
        self.logs = [open(d / f"rank{r}.log", "w") for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(WORLD), str(port), str(d)], env=env,
            stdout=self.logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
        self.t0 = time.perf_counter()
        self.rcs = None

    def wait(self) -> None:
        if self.rcs is None:
            self.rcs = [p.wait(timeout=300) for p in self.procs]
            for f in self.logs:
                f.close()
        logs = "\n".join((self.d / f"rank{r}.log").read_text()[-3000:] for r in range(WORLD))
        assert self.rcs == [0] * WORLD, f"gang exit codes {self.rcs}:\n{logs}"

    def result(self, name: str) -> list:
        """The case's per-rank results, as soon as its ranks have written
        them (the test side's JAX work overlaps the gang's later rounds)."""
        paths = [self.d / f"{name}.{i}.pt" for i in range(_n(CASES[name]["axes"]))]
        while not all(p.exists() for p in paths):
            if all(p.poll() is not None for p in self.procs) or any(
                    p.poll() not in (None, 0) for p in self.procs):
                self.wait()  # fails with the ranks' logs
                assert False, f"the gang ended without {name}"
            assert time.perf_counter() - self.t0 < 300, f"no result for {name} in 300 s"
            time.sleep(0.05)
        return [torch.load(p, weights_only=False) for p in paths]

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def inputs():
    jax = pytest.importorskip("jax")
    inp = _inputs()
    inp["mask"] = np.array(jax.random.bernoulli(jax.random.PRNGKey(0), 0.15, (B, T)))
    return inp


@pytest.fixture(scope="module")
def gang(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo-gang")
    torch.save(inputs, d / "inputs.pt")
    g = _Gang(d)
    try:
        yield g
        g.wait()  # every rank ended cleanly
    finally:
        g.close()


def _host_mesh(axes: dict):
    """The case's mesh over ranks 0..n-1, without a process group (the
    blocks' layout for gather_params)."""
    from tf_operator_tpu_torch.parallel.mesh import device_mesh, mesh_ranks

    return device_mesh(*mesh_ranks(axes, range(_n(axes))))


def _gathered(results: list, axes: dict, logical_axes, key="params") -> dict:
    from tf_operator_tpu_torch import compat

    return compat.gather_params({i: r[key] for i, r in enumerate(results)},
                                _host_mesh(axes), logical_axes)


_JAX_GRAD: dict = {}
_JAX_LM: dict = {}


def _jax_lm(axes: dict, attn: str, params, tokens, causal=True):
    """The JAX Trainer on the same mesh: losses, grad norms (of the loss at
    each step's params, without the mesh), params after the steps, and
    the gradients at the first step's params."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import transformer as jt
    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu.train.trainer import Trainer as JaxTrainer
    from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    mesh = build_mesh(axes, devices=jax.devices()[:_n(axes)])
    cfg = jt.preset("tiny", dtype=jnp.float32, attn_impl=attn, remat="save_mid", causal=causal)
    jtr = JaxTrainer(mesh, loss_fn=lambda p, b, e: jt.lm_loss(p, b, cfg, mesh=mesh),
                     init_fn=lambda k: jax.tree_util.tree_map(jnp.asarray, params),
                     logical_axes=jt.transformer_logical_axes(cfg),
                     config=JaxTrainerConfig(learning_rate=LR, weight_decay=WD,
                                             grad_clip=CLIP))
    key = (attn, causal)
    if key not in _JAX_GRAD:  # one compile a model: the gradient without the mesh
        _JAX_GRAD[key] = jax.jit(lambda p, t: jax.grad(lambda q: jt.lm_loss(q, t, cfg))(p))
    grad = _JAX_GRAD[key]
    js = jtr.init(jax.random.PRNGKey(0))
    tok = jnp.asarray(tokens)
    losses, norms, grads = [], [], []
    for _ in range(STEPS):
        grads.append(grad(jax.tree_util.tree_map(np.asarray, js.params), tok))
        norms.append(float(optax.global_norm(grads[-1])))
        js, m = jtr.step(js, tok)
        losses.append(float(m["loss"]))
    return (losses, norms, jax.tree_util.tree_map(np.asarray, js.params),
            jax.tree_util.tree_map(np.asarray, grads[0]))


_SINGLE: dict = {}


def _port_single(kind: str, inp: dict, attn="dense", fused=False):
    """The port's single-process run of a case (once a kind, attention
    and path)."""
    key = (kind, attn, fused)
    if key not in _SINGLE:
        _SINGLE[key] = _port_single_run(kind, inp, attn, fused)
    return _SINGLE[key]


def _port_single_run(kind: str, inp: dict, attn: str, fused: bool):
    from tf_operator_tpu_torch import compat
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.train.trainer import Trainer
    from tf_operator_tpu_torch.workloads import resnet as rw

    if kind == "resnet":
        cfg = _resnet_cfg(fused)
        trainer = Trainer(lambda p, b, s: rw.resnet_loss(p, b, s, cfg), None,
                          _trainer_config("resnet"), device="cpu")
        state = trainer.state_from_params(compat.params_from_numpy(inp["resnet_params"], "cpu"),
                                          compat.params_from_numpy(inp["resnet_state"], "cpu"))
        batch = (torch.from_numpy(inp["images"]), torch.from_numpy(inp["labels"]))
    else:
        mlm = kind == "mlm"
        cfg = _tiny(causal=not mlm, attn=attn)
        mask = torch.from_numpy(inp["mask"]) if mlm else None
        trainer = Trainer(lambda p, b, e: tt.lm_loss(p, b, cfg, mask=mask), None,
                          _trainer_config("lm"), device="cpu")
        state = trainer.state_from_params(compat.params_from_numpy(
            inp["mlm_params" if mlm else "lm_params"], "cpu"))
        batch = torch.from_numpy(inp["tokens"])
    out = {"losses": [], "grad_norms": []}
    if kind == "mlm":
        with torch.no_grad():
            out["default_mask_loss"] = float(tt.lm_loss(state.params, batch, cfg))
    for _ in range(STEPS):
        state, m = trainer.step(state, batch)
        out["losses"].append(float(m["loss"]))
        if "grad_norm" in m:
            out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = _to_numpy(state.params)
    if state.extra is not None:
        out["extra"] = _to_numpy(state.extra)
    return out


def _assert_trees(got, want, atol, what):
    import jax

    pairs = zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want))
    for (path, a), b in pairs:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _assert_adam_params(got, want, grads0, what):
    """Params after the AdamW steps within ATOL, but for the elements whose
    first gradient is within f32 rounding of zero (below 1e-5 of the
    leaf's largest): Adam divides such a gradient by its own square root,
    so rounding alone sets the sign of their update, and they are held to
    the update's size (lr a step) instead."""
    import jax

    for (path, a), b, g in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(grads0)):
        g = np.abs(np.asarray(g))
        tol = np.where(g >= 1e-5 * g.max(), ATOL, 2 * STEPS * LR)
        err = np.abs(np.asarray(a) - np.asarray(b))
        assert (err <= tol).all(), (f"{what} {jax.tree_util.keystr(path)}: max error "
                                    f"{(err - tol).max() + ATOL} over the limit")


@pytest.mark.parametrize("mesh_name,attn", [(m, a) for m in LM_MESHES for a in ATTNS])
def test_lm_sharded_steps_match_jax_and_single_process(inputs, gang, mesh_name, attn):
    """Two AdamW steps under the mesh: every rank's losses and grad norms,
    the gathered first gradients and the gathered params within 1e-5 of
    JAX's Trainer on the same mesh (its flash path, the shard_map over the
    mesh, for the port's dense and flash cases alike: JAX's dense and
    flash compute the same function) and of the port's single-process
    steps."""
    from tf_operator_tpu_torch.models import transformer as tt

    axes = LM_MESHES[mesh_name]
    if mesh_name not in _JAX_LM:  # one JAX compile a mesh
        _JAX_LM[mesh_name] = _jax_lm(axes, "flash", inputs["lm_params"], inputs["tokens"])
    want_losses, want_norms, want_params, want_grads = _JAX_LM[mesh_name]
    single = _port_single("lm", inputs, attn=attn)
    results = gang.result(f"lm_{mesh_name}_{attn}")
    logical = tt.transformer_logical_axes(_tiny())
    for r in results:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["grad_norms"], want_norms, rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["grad_norms"], single["grad_norms"], rtol=0, atol=ATOL)
    assert want_norms[0] > CLIP  # the clip acted
    _assert_trees(_gathered(results, axes, logical, "grads"), want_grads, ATOL, "grads vs JAX")
    got = _gathered(results, axes, logical)
    _assert_adam_params(got, single["params"], want_grads, "params vs single process")
    _assert_adam_params(got, want_params, want_grads, "params vs JAX")


def test_mlm_global_denominator_under_fsdp(inputs, gang):
    """The masked LM under fsdp 2: sum(w·xent) and sum(w) summed over the
    ranks before the division (the ranks' masks cover different counts, so
    a mean of per-rank ratios would differ), held to JAX and to one
    process; the port's default mask under the mesh is the global batch's
    mask cut to each rank's rows."""
    from tf_operator_tpu_torch.models import transformer as tt

    mask = inputs["mask"]
    assert mask[:B // 2].sum() != mask[B // 2:].sum()
    axes = {"fsdp": 2}
    want_losses, want_norms, want_params, want_grads = _jax_lm(
        axes, "dense", inputs["mlm_params"], inputs["tokens"], causal=False)
    single = _port_single("mlm", inputs)
    results = gang.result("mlm_fsdp2")
    for r in results:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["grad_norms"], want_norms, rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=0, atol=ATOL)
        assert abs(r["default_mask_loss"] - single["default_mask_loss"]) <= ATOL
    logical = tt.transformer_logical_axes(_tiny(causal=False))
    _assert_trees(_gathered(results, axes, logical, "grads"), want_grads, ATOL, "grads vs JAX")
    got = _gathered(results, axes, logical)
    _assert_adam_params(got, want_params, want_grads, "params vs JAX")
    _assert_adam_params(got, single["params"], want_grads, "params vs single process")


_JAX_RESNET: dict = {}


def _jax_resnet(inp: dict):
    """JAX's dp 2 run of the test ResNet on its plain path (its fused_1x1
    path computes the same function, as the port's two cases do), once
    for both cases."""
    if "run" in _JAX_RESNET:
        return _JAX_RESNET["run"]
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import resnet as jr
    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu.train.trainer import Trainer as JaxTrainer
    from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    jcfg = jr.ResNetConfig((1, 1, 1, 1), (16, 32, 64, 128), 10, dtype=jnp.float32)

    def jloss(p, batch, s):
        logits, new_s = jr.resnet_forward(p, s, batch[0], jcfg, train=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, batch[1][:, None], axis=-1)), new_s

    mesh = build_mesh({"dp": 2}, devices=jax.devices()[:2])
    jtr = JaxTrainer(mesh, loss_fn=jloss, init_fn=lambda k: jax.tree_util.tree_map(
        jnp.asarray, (inp["resnet_params"], inp["resnet_state"])),
        config=JaxTrainerConfig(optimizer="sgd", learning_rate=RESNET_LR, grad_clip=None))
    js = jtr.init(jax.random.PRNGKey(0))
    batch = (jnp.asarray(inp["images"]), jnp.asarray(inp["labels"]))
    losses = []
    for _ in range(STEPS):
        js, m = jtr.step(js, batch)
        losses.append(float(m["loss"]))
    _JAX_RESNET["run"] = losses, jax.tree_util.tree_map(np.asarray, (js.params, js.extra))
    return _JAX_RESNET["run"]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_1x1"])
def test_resnet_dp2_synced_bn_matches_jax(inputs, gang, fused):
    """Two SGD steps under dp 2 with synced batch norm: both ranks' losses
    within 1e-5 of JAX's dp 2 run (its plain path, for both cases) and of
    one process; the BN running
    statistics bitwise equal across the ranks and within 1e-5 of both; the
    params within 1e-5 of one process, and of JAX within the single-device
    parity test's limit (1e-2 of each leaf's update: a few grads cancel to
    near zero, tests/test_torch_resnet_train.py)."""
    want_losses, (want_params, want_state) = _jax_resnet(inputs)
    single = _port_single("resnet", inputs, fused=fused)
    results = gang.result(f"resnet_dp2_{'fused' if fused else 'unfused'}")
    import jax

    for r in results:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=0, atol=ATOL)
        _assert_trees(r["extra"], want_state, ATOL, "BN state vs JAX")
        _assert_trees(r["extra"], single["extra"], ATOL, "BN state vs single process")
        _assert_trees(r["params"], single["params"], ATOL, "params vs single process")
    for a, b in zip(jax.tree_util.tree_leaves(results[0]["extra"]),
                    jax.tree_util.tree_leaves(results[1]["extra"])):
        assert np.array_equal(a, b)
    p0 = jax.tree_util.tree_leaves(inputs["resnet_params"])
    for (path, a), b, p in zip(jax.tree_util.tree_leaves_with_path(results[0]["params"]),
                               jax.tree_util.tree_leaves(want_params), p0):
        scale = np.abs(np.asarray(b) - p).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * scale,
                                   err_msg=f"params vs JAX {jax.tree_util.keystr(path)}")


def test_tp_region_pair_grads_match_jax_custom_vjp(inputs, gang):
    """z = exit(enter(x) @ w1[:, cols] @ w2[rows, :]) over tp 2, loss
    sum(z²): the loss, x's gradient on each rank and the gathered weight
    gradients equal JAX's custom_vjp pair differentiated inside a
    shard_map (each device's own loss, as each rank's autograd), and the
    plain single-device gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu.parallel.collectives import shard_map_compat, tp_region_enter
    from tf_operator_tpu.parallel.collectives import tp_region_exit

    mesh = build_mesh({"tp": 2}, devices=jax.devices()[:2])

    def body(x, w1, w2):
        z = tp_region_exit(tp_region_enter(x, "tp") @ w1 @ w2, "tp")
        return jnp.sum(z * z)

    # each device differentiates its own copy of the loss, as each rank does
    fn = shard_map_compat(lambda *a: jax.value_and_grad(body, argnums=(0, 1, 2))(*a),
                          mesh=mesh, in_specs=(P(), P(None, "tp"), P("tp", None)),
                          out_specs=(P(), (P(), P(None, "tp"), P("tp", None))))
    x, w1, w2 = (jnp.asarray(inputs[k]) for k in ("tp_x", "tp_w1", "tp_w2"))
    loss, (dx, dw1, dw2) = fn(x, w1, w2)
    plain = jax.grad(lambda a, b, c: jnp.sum((a @ b @ c) ** 2), argnums=(0, 1, 2))(x, w1, w2)
    results = gang.result("tp_pair")
    got_dw1 = np.concatenate([r["dw1"] for r in results], axis=1)
    got_dw2 = np.concatenate([r["dw2"] for r in results], axis=0)
    for r in results:
        assert abs(r["loss"] - float(loss)) <= 1e-4 * abs(float(loss))
        np.testing.assert_allclose(r["dx"], dx, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(r["dx"], plain[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_dw1, dw1, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_dw2, dw2, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_dw1, plain[1], rtol=1e-5, atol=1e-4)
    for r in results:  # ring_shift over the pair, and its transpose
        i = r["tp_index"]
        peer = 1 - i
        np.testing.assert_array_equal(r["shifted"], np.full(3, peer + 1.0))
        np.testing.assert_array_equal(r["shift_grad"], np.arange(3.0) * (peer + 1))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    # below the test runner's own processes: on a loaded host the gang
    # yields the cores to the other test files
    os.nice(10)
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
