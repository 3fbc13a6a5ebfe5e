"""The port's expert-parallel and context-parallel training on gloo CPU gangs
against the JAX package.

One gang of four processes (gloo, one thread each, f32, tiny shapes, a
grouped-matmul row block of 8 in both packages) is spawned once for the
module and runs every case; two-rank cases run two at a time on disjoint
ranks. Beside it four processes (``JAX_GROUPS``) run the JAX package's
Trainer on the same mesh over eight CPU devices, from the same converted
init and batch. Each rank writes its losses, pre-clip gradient norms, the
gradients at each step's params and the params after the steps; the test
gathers the blocks (``compat.gather_params``) and holds them to JAX's
within 1e-5, the params with the allowance of ``_assert_adam_params``.

- MoE (``tiny-moe``, save_mid): gmm top-1 under ep 2, dp 2 x ep 2 and tp
  2; sort and einsum top-2 at capacity factor 0.5 under ep 2 (per-shard
  queues, choices dropped); ragged under ep 2 (warns and runs sort);
  fsdp 2 x ep 2 sort; fsdp 2 sort without ep (JAX's global queues over
  the whole batch, choices dropped).
- cp (``tiny``, save_mid): ring (flash body) causal under cp 2 and dp 2 x
  cp 2, ring non-causal (the masked LM) under cp 2, Ulysses under cp 2
  (tiny's 2 KV heads split) and cp 4 (``gather_kv``), flash under cp 2
  (the sequence gathered); the ring's flash and einsum bodies called
  alone, values and gradients against JAX's ``ring_attention``.
- Two planted faults, forward only, each of which must move the first
  loss: the gmm receiver's block map built from its own counts instead of
  the exchanged ones; the ring's causal skip inverted.

Run as ``python tests/test_torch_ep_cp.py RANK WORLD PORT DIR`` the file
is one rank of the gang (it imports no jax then); as ``python
tests/test_torch_ep_cp.py jax DIR REF...`` it computes JAX references.
"""

from __future__ import annotations

import logging
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
BLOCK = 8  # TPUJOB_GMM_BLOCK_ROWS for both packages
LOW_CF = 0.5  # capacity factor at which the capacity dispatches drop choices
# f32 on both sides; only the order of sums differs
ATOL = 1e-5
# a plant must move the first loss by more than this (each moves it by far more)
PLANT_MIN = 1e-3

MOE_TOP1 = dict(moe_dispatch="gmm")
MOE_TOP2 = dict(moe_top_k=2, capacity_factor=LOW_CF)
# name -> (mesh axes, model, config overrides, JAX reference key)
CASES = {
    "ep2_gmm": ({"ep": 2}, "tiny-moe", MOE_TOP1, "ep2_gmm"),
    "ep2_sort": ({"ep": 2}, "tiny-moe", dict(MOE_TOP2, moe_dispatch="sort"), "ep2_sort"),
    "ep2_einsum": ({"ep": 2}, "tiny-moe", dict(MOE_TOP2, moe_dispatch="einsum"), "ep2_sort"),
    "ep2_ragged": ({"ep": 2}, "tiny-moe", dict(MOE_TOP2, moe_dispatch="ragged"), "ep2_sort"),
    "dp2_ep2_gmm": ({"dp": 2, "ep": 2}, "tiny-moe", MOE_TOP1, "dp2_ep2_gmm"),
    "fsdp2_ep2_sort": ({"fsdp": 2, "ep": 2}, "tiny-moe", dict(MOE_TOP2, moe_dispatch="sort"),
                       "fsdp2_ep2_sort"),
    "fsdp2_sort": ({"fsdp": 2}, "tiny-moe", dict(MOE_TOP2, moe_dispatch="sort"), "fsdp2_sort"),
    "tp2_gmm": ({"tp": 2}, "tiny-moe", MOE_TOP1, "tp2_gmm"),
    "cp2_ring": ({"cp": 2}, "tiny", dict(attn_impl="ring"), "cp2_ring"),
    "cp2_ring_mlm": ({"cp": 2}, "tiny", dict(attn_impl="ring", causal=False), "cp2_ring_mlm"),
    "cp2_ulysses": ({"cp": 2}, "tiny", dict(attn_impl="ulysses"), "cp2_ulysses"),
    "cp4_ulysses": ({"cp": 4}, "tiny", dict(attn_impl="ulysses"), "cp4_ulysses"),
    "dp2_cp2_ring": ({"dp": 2, "cp": 2}, "tiny", dict(attn_impl="ring"), "dp2_cp2_ring"),
    "cp2_flash": ({"cp": 2}, "tiny", dict(attn_impl="flash"), "cp2_flash"),
    "plant_ep_own_counts": ({"ep": 2}, "tiny-moe", MOE_TOP1, "ep2_gmm"),
    "plant_cp_skip_inverted": ({"cp": 2}, "tiny", dict(attn_impl="ring"), "cp2_ring"),
}
def _coll():
    from tf_operator_tpu_torch.parallel import collectives

    return collectives


def _ring():
    from tf_operator_tpu_torch.parallel import ring_attention

    return ring_attention


# name -> (the module, its attribute, the faulty stand-in)
PLANTS = {
    # the receiver rebuilds block_expert from its own counts
    "plant_ep_own_counts": (_coll, "exchange_counts", lambda counts, mesh, axis: counts),
    # the ring skips the blocks of earlier ranks and attends the later ones
    "plant_cp_skip_inverted": (_ring, "_in_future", lambda src, my: src < my),
}
# the JAX references, one process a list, each computed once, the lists'
# times about equal (each reference logs its seconds in its process's log;
# the first in a process also pays ~5 s of JAX's first compile);
# "ring_bodies" is ``_jax_ring``
JAX_GROUPS = [
    ["ep2_gmm", "tp2_gmm"],
    ["dp2_ep2_gmm", "ring_bodies", "cp2_flash", "cp2_ring_mlm"],
    ["ep2_sort", "fsdp2_ep2_sort", "fsdp2_sort"],
    ["cp2_ring", "cp2_ulysses", "cp4_ulysses", "dp2_cp2_ring"],
]


def _n(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def _rounds() -> list:
    """Rounds of cases: each round's cases run at once on disjoint ranks."""
    two = [n for n, c in CASES.items() if _n(c[0]) == 2]
    four = [n for n, c in CASES.items() if _n(c[0]) == 4]
    return [two[i:i + 2] for i in range(0, len(two), 2)] + [[n] for n in four]


# ---------------------------------------------------------------------------
# the inputs both packages see
# ---------------------------------------------------------------------------


def _port_cfg(name: str):
    from tf_operator_tpu_torch.models import transformer as tt

    _, model, over, _ = CASES[name]
    return tt.preset(model, dtype=torch.float32, remat="save_mid", **over)


def _inputs() -> dict:
    """Params, batches and ring inputs for every case (numpy), from seeds."""
    from tf_operator_tpu_torch.models import transformer as tt

    rng = np.random.RandomState(11)
    return {
        "tiny": tt.init_transformer_numpy(tt.preset("tiny"), 0),
        "tiny-moe": tt.init_transformer_numpy(tt.preset("tiny-moe"), 1),
        "tokens": np.random.RandomState(1).randint(0, 256, (B, T)),
        "ring_q": rng.randn(2, 16, 4, 16).astype(np.float32),
        "ring_k": rng.randn(2, 16, 2, 16).astype(np.float32),
        "ring_v": rng.randn(2, 16, 2, 16).astype(np.float32),
        "ring_w": rng.randn(2, 16, 4, 16).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# one rank of the gang
# ---------------------------------------------------------------------------


def _ring_alone(mesh, inp: dict) -> dict:
    """ring_attention's two bodies on this rank's sequence blocks: the
    output block and the gradients of sum(o * w) in q, k and v."""
    from tf_operator_tpu_torch.parallel.ring_attention import ring_attention
    from tf_operator_tpu_torch.parallel.sharding import MeshPlan

    plan = MeshPlan(mesh)
    out = {}
    for impl in ("flash", "einsum"):
        q, k, v = (plan.seq_cols(torch.from_numpy(inp[f"ring_{x}"])).clone()
                   .requires_grad_(True) for x in "qkv")
        o = ring_attention(q, k, v, mesh, causal=True, impl=impl)
        (o * plan.seq_cols(torch.from_numpy(inp["ring_w"]))).sum().backward()
        out[impl] = {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                     "dv": v.grad.numpy()}
    return out


def _run_case(name: str, mesh, inp: dict, rank: int) -> dict:
    """This rank's part of one case: losses, grad norms, the gradients at
    each step's params, params (a plant: its first loss only)."""
    from tf_operator_tpu_torch import compat
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.parallel.sharding import MeshPlan
    from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = _port_cfg(name)
    plan = MeshPlan(mesh)
    axes = tt.transformer_logical_axes(cfg)
    mask = None if cfg.causal else plan.local_batch(torch.from_numpy(inp["mask"]))
    trainer = Trainer(lambda p, b, e: tt.lm_loss(p, b, cfg, mesh=mesh, mask=mask), None,
                      TrainerConfig(learning_rate=LR, weight_decay=WD, grad_clip=CLIP),
                      device="cpu", mesh=mesh, logical_axes=axes)
    state = trainer.state_from_params(compat.params_from_numpy(
        compat.shard_params(inp[CASES[name][1]], mesh, axes, rank), "cpu"))
    batch = plan.local_batch(torch.from_numpy(inp["tokens"]))
    if name in PLANTS:
        module, attr, fault = PLANTS[name]
        sound = getattr(module(), attr)
        setattr(module(), attr, fault)
        try:
            with torch.no_grad():
                return {"first_loss": float(tt.lm_loss(state.params, batch, cfg, mesh=mesh,
                                                       mask=mask))}
        finally:
            setattr(module(), attr, sound)
    warnings = []
    handler = logging.Handler()
    handler.emit = lambda r: warnings.append(r.getMessage())
    logging.getLogger("tpujob.moe").addHandler(handler)
    try:
        out = {"losses": [], "grad_norms": [], "grads": []}
        for _ in range(STEPS):
            out["grads"].append(compat.params_to_numpy(trainer.gradients(state, batch)[1]))
            state, m = trainer.step(state, batch)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
    finally:
        logging.getLogger("tpujob.moe").removeHandler(handler)
    out["params"] = compat.params_to_numpy(state.params)
    out["warnings"] = warnings
    if name == "cp2_ring":
        out["ring"] = _ring_alone(mesh, inp)
    return out


def _load_inputs(d: Path) -> dict:
    """The inputs, once the test process has written them (whole when
    they appear)."""
    t0 = time.perf_counter()
    while not (d / "inputs.pt").exists():
        assert time.perf_counter() - t0 < 120, "no inputs in 120 s"
        time.sleep(0.05)
    return torch.load(d / "inputs.pt", weights_only=False)


def _worker(rank: int, world: int, port: int, d: Path) -> None:
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import device_mesh, mesh_ranks

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    inp = _load_inputs(d)
    for rnd in _rounds():
        start, meshes = 0, []
        for name in rnd:  # every rank takes part in building every mesh
            n = _n(CASES[name][0])
            meshes.append((name, start, n, device_mesh(*mesh_ranks(CASES[name][0],
                                                                   range(start, start + n)))))
            start += n
        for name, first, n, mesh in meshes:
            if first <= rank < first + n:
                out = _run_case(name, mesh, inp, rank)
                path = d / f"{name}.{rank - first}.pt"
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
    """The gang's WORLD ranks and a process for each list of JAX_GROUPS
    computing its JAX references (``_jax_worker``), started together; each
    writes its results to files in ``d`` as they are done."""

    def __init__(self, d: Path) -> None:
        self.d = d
        env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get(
            "PYTHONPATH", ""), "OMP_NUM_THREADS": "1", "TPUJOB_GMM_BLOCK_ROWS": str(BLOCK)}
        port = _free_port()
        refs = sorted(r for g in JAX_GROUPS for r in g)
        assert refs == sorted({c[3] for c in CASES.values()} | {"ring_bodies"}), refs
        cmds = {f"rank{r}": [str(r), str(WORLD), str(port), str(d)] for r in range(WORLD)}
        cmds.update({f"jax{j}": ["jax", str(d)] + g for j, g in enumerate(JAX_GROUPS)})
        self.logs = {k: open(d / f"{k}.log", "w") for k in cmds}
        self.procs = {k: subprocess.Popen([sys.executable, __file__] + args, env=env,
                                          stdout=self.logs[k], stderr=subprocess.STDOUT)
                      for k, args in cmds.items()}
        self.t0 = time.perf_counter()
        self.rcs = None

    def wait(self) -> None:
        if self.rcs is None:
            self.rcs = {k: p.wait(timeout=300) for k, p in self.procs.items()}
            for f in self.logs.values():
                f.close()
        logs = "\n".join((self.d / f"{k}.log").read_text()[-3000:] for k in self.procs)
        assert set(self.rcs.values()) == {0}, f"exit codes {self.rcs}:\n{logs}"

    def _load(self, paths: list, what: str) -> list:
        while not all(p.exists() for p in paths):
            if any(p.poll() not in (None, 0) for p in self.procs.values()) or all(
                    p.poll() is not None for p in self.procs.values()):
                self.wait()  # fails with the processes' logs
                assert False, f"the processes ended without {what}"
            assert time.perf_counter() - self.t0 < 300, f"no {what} in 300 s"
            time.sleep(0.05)
        return [torch.load(p, weights_only=False) for p in paths]

    def result(self, name: str) -> list:
        """The case's per-rank results, as soon as its ranks have written
        them."""
        return self._load([self.d / f"{name}.{i}.pt" for i in range(_n(CASES[name][0]))],
                          f"result for {name}")

    def jax(self, ref: str):
        """_jax_run's (or _jax_ring's) result for reference ``ref``."""
        return self._load([self.d / f"jax_{ref}.pt"], f"JAX reference {ref}")[0]

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def inputs():
    jax = pytest.importorskip("jax")
    inp = _inputs()
    # the masked LM's mask: JAX's default, PRNGKey(0)'s
    inp["mask"] = np.array(jax.random.bernoulli(jax.random.PRNGKey(0), 0.15, (B, T)))
    return inp


@pytest.fixture(scope="module")
def gang(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo-gang-ep-cp")
    g = _Gang(d)  # its processes import while the inputs are made
    try:
        torch.save(request.getfixturevalue("inputs"), d / "inputs.tmp")
        os.replace(d / "inputs.tmp", d / "inputs.pt")
        yield g
        g.wait()  # every process ended cleanly
    finally:
        g.close()


def _jax_worker(d: Path, refs: list) -> None:
    """Compute JAX references ``refs`` on the CPU's eight devices, one file
    each (``jax_<ref>.pt``), from the gang's inputs."""
    # eight devices, as tests/conftest.py makes; LLVM's cheap passes only, a
    # third off the compiles that are most of this work (same HLO, same f32)
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    inp = _load_inputs(d)
    for ref in refs:
        path = d / f"jax_{ref}.pt"
        t0 = time.perf_counter()
        out = _jax_ring(inp) if ref == "ring_bodies" else _jax_run(ref, inp)
        print(f"{ref}: {time.perf_counter() - t0:.1f} s", flush=True)
        torch.save(out, path.with_suffix(".tmp"))
        os.replace(path.with_suffix(".tmp"), path)


def _host_mesh(axes: dict):
    """The case's mesh over ranks 0..n-1, without a process group (the
    blocks' layout for gather_params)."""
    from tf_operator_tpu_torch.parallel.mesh import device_mesh, mesh_ranks

    return device_mesh(*mesh_ranks(axes, range(_n(axes))))


def _gathered(results: list, axes: dict, logical_axes, pick=lambda r: r["params"]) -> dict:
    from tf_operator_tpu_torch import compat

    return compat.gather_params({i: pick(r) for i, r in enumerate(results)},
                                _host_mesh(axes), logical_axes)


def _jax_cfg(name: str):
    import jax.numpy as jnp

    from tf_operator_tpu.models import transformer as jt

    _, model, over, _ = CASES[name]
    return jt.preset(model, dtype=jnp.float32, remat=False, **over)


def _jax_run(ref: str, inp: dict):
    """The JAX Trainer on reference ``ref``'s mesh and config: losses, the
    pre-clip gradient norms at each step's params, params after the steps
    and the gradients at each step's params."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import transformer as jt
    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu.train.trainer import Trainer as JaxTrainer
    from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    axes, model, _, _ = CASES[ref]
    mesh = build_mesh(axes, devices=jax.devices()[:_n(axes)])
    cfg = _jax_cfg(ref)  # a masked LM uses JAX's PRNGKey(0) mask, the gang's inp["mask"]
    params = inp[model]
    jtr = JaxTrainer(mesh, loss_fn=lambda p, b, e: jt.lm_loss(p, b, cfg, mesh=mesh),
                     init_fn=lambda k: jax.tree_util.tree_map(jnp.asarray, params),
                     logical_axes=jt.transformer_logical_axes(cfg),
                     config=JaxTrainerConfig(learning_rate=LR, weight_decay=WD,
                                             grad_clip=CLIP))
    # under the mesh, as the Trainer's step computes it: the params' replay
    # in _assert_adam_params needs the gradients the Trainer used
    grad = jax.jit(jax.grad(lambda q, t: jt.lm_loss(q, t, cfg, mesh=mesh)))
    js = jtr.init(jax.random.PRNGKey(0))
    tok = jnp.asarray(inp["tokens"])
    losses, norms, grads = [], [], []
    for _ in range(STEPS):
        grads.append(grad(js.params, tok))
        norms.append(float(optax.global_norm(grads[-1])))
        js, m = jtr.step(js, tok)
        losses.append(float(m["loss"]))
    return (losses, norms, jax.tree_util.tree_map(np.asarray, js.params),
            jax.tree_util.tree_map(np.asarray, grads))


def _jax_ring(inp: dict) -> dict:
    """JAX's ring_attention, each body, under cp 2, causal, on the ring
    inputs: the output and the gradients of sum(o * w) in q, k and v."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu.parallel.ring_attention import ring_attention as jring

    mesh = build_mesh({"cp": 2}, devices=jax.devices()[:2])
    q, k, v, w = (jnp.asarray(inp[f"ring_{x}"]) for x in "qkvw")
    out = {}
    for impl in ("flash", "einsum"):
        def loss(q, k, v):
            o = jring(q, k, v, mesh, causal=True, impl=impl)
            return jnp.sum(o * w), o

        (_, o), (dq, dk, dv) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                          has_aux=True))(q, k, v)
        out[impl] = {key: np.asarray(x) for key, x in
                     (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))}
    return out


def _assert_trees(got, want, atol, what):
    import jax

    pairs = zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want))
    for (path, a), b in pairs:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _adamw_replay(p0, grads: list, norms: list) -> np.ndarray:
    """One leaf after len(grads) steps of both packages' optimizer (global
    norm clip to CLIP, then AdamW: b1 0.9, b2 0.95, eps 1e-8, decoupled
    weight decay, constant lr), in f64, from the gradients and the
    pre-clip global norms given."""
    p, m, v = np.asarray(p0, np.float64), 0.0, 0.0
    for t, (g, norm) in enumerate(zip(grads, norms), 1):
        g = np.asarray(g, np.float64) * min(1.0, CLIP / norm)
        m, v = 0.9 * m + 0.1 * g, 0.95 * v + 0.05 * g * g
        p = p - LR * (m / (1 - 0.9 ** t) / (np.sqrt(v / (1 - 0.95 ** t)) + 1e-8) + WD * p)
    return p


def _assert_adam_params(got, want, init, port: tuple, ref: tuple, what: str) -> int:
    """Params after the AdamW steps, ``port`` and ``ref`` each (gradients at
    every step, pre-clip norms) of its side:

    - the port's within ATOL of the replay of its own gradients (its clip
      and AdamW, with the gradients its step used), and JAX's within ATOL
      of the replay of JAX's, everywhere;
    - the port's within ATOL of JAX's, plus what the two sides' gradients,
      held to ATOL at every step, move through AdamW: |replay(port) -
      replay(JAX)|. That is ~0 but where Adam's update is sensitive to
      rounding, a gradient near eps or a second step's that nearly
      cancels the first in the momentum.

    Returns the count of elements whose allowance is above ATOL."""
    import jax

    leaves = jax.tree_util.tree_leaves
    n_allowed = 0
    for (path, a), b, p0, *g in zip(jax.tree_util.tree_leaves_with_path(got), leaves(want),
                                    leaves(init), *map(leaves, port[0]), *map(leaves, ref[0])):
        key = f"{what} {jax.tree_util.keystr(path)}"
        mine, theirs = _adamw_replay(p0, g[:STEPS], port[1]), _adamw_replay(p0, g[STEPS:], ref[1])
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        np.testing.assert_allclose(a, mine, rtol=0, atol=ATOL, err_msg=f"{key} vs its replay")
        np.testing.assert_allclose(b, theirs, rtol=0, atol=ATOL, err_msg=f"{key}: JAX's replay")
        allow = np.abs(mine - theirs)
        err = np.abs(a - b)
        assert (err <= ATOL + allow).all(), (
            f"{key}: max error {(err - allow).max()} over the allowance")
        n_allowed += int((allow > ATOL).sum())
    return n_allowed


TRAINED = [n for n in CASES if n not in PLANTS]


@pytest.mark.parametrize("name", TRAINED)
def test_sharded_steps_match_jax(gang, inputs, name):
    """Two AdamW steps (clip active) under the case's mesh: every rank's
    losses and pre-clip gradient norms, the gathered gradients at each
    step's params and the gathered params (``_assert_adam_params``) within
    1e-5 of the JAX Trainer on the same mesh (einsum and ragged against
    JAX's sort, the same queues: JAX's ragged runs sort under ep)."""
    from tf_operator_tpu_torch.models import transformer as tt

    axes, model, over, ref = CASES[name]
    want_losses, want_norms, want_params, want_grads = gang.jax(ref)  # grads: both steps
    results = gang.result(name)
    for r in results:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["grad_norms"], want_norms, rtol=0, atol=ATOL)
    assert want_norms[0] > CLIP  # the clip acted
    assert any("falling back to 'sort'" in w for w in results[0]["warnings"]) == (
        over.get("moe_dispatch") == "ragged")
    logical = tt.transformer_logical_axes(_port_cfg(name))
    grads = [_gathered(results, axes, logical, lambda r: r["grads"][s]) for s in range(STEPS)]
    for step in range(STEPS):
        _assert_trees(grads[step], want_grads[step], ATOL, f"step {step} grads vs JAX")
    n_allowed = _assert_adam_params(
        _gathered(results, axes, logical), want_params, inputs[model],
        (grads, results[0]["grad_norms"]), (want_grads, want_norms), "params vs JAX")
    print(f"{name}: {n_allowed} elements allowed more than {ATOL} by the replay")


def test_capacity_queues_drop_under_every_layout(inputs):
    """The capacity cases run where choices drop: the first layer's router
    on the first batch, at the per-shard capacity of ep 2 and at the
    global one of fsdp 2, leaves some choice without a slot (else the
    queues' order would be untested)."""
    from tf_operator_tpu_torch import compat
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.parallel import moe

    cfg = _port_cfg("ep2_sort")
    p = compat.params_from_numpy(inputs["tiny-moe"], "cpu")
    x = tt._rms_norm(p["embed"][torch.from_numpy(inputs["tokens"])], p["layers"]["attn_norm"][0],
                     cfg.norm_eps).reshape(B * T, -1)
    logits = x @ p["layers"]["w_router"][0]
    for tokens in (B * T // 2, B * T):  # an ep shard's queues, the global ones
        cap = moe.expert_capacity(LOW_CF, 2, tokens, cfg.n_experts)
        counts = torch.bincount(moe._routing(logits[:tokens], 2)[2].reshape(-1),
                                minlength=cfg.n_experts)
        assert int(counts.max()) > cap


def test_ring_bodies_match_jax(gang):
    """ring_attention's flash and einsum bodies under cp 2, causal, GQA 4/2:
    each rank's output block and the gradients of sum(o * w) in its q, k
    and v blocks within 1e-5 of JAX's ring_attention (each body) on the
    same mesh."""
    want = gang.jax("ring_bodies")
    results = gang.result("cp2_ring")
    for impl in ("flash", "einsum"):
        for key in ("o", "dq", "dk", "dv"):
            got = np.concatenate([r["ring"][impl][key] for r in results], axis=1)
            np.testing.assert_allclose(got, want[impl][key], rtol=0, atol=ATOL,
                                       err_msg=f"{impl} {key}")


@pytest.mark.parametrize("name", list(PLANTS))
def test_planted_fault_moves_the_first_loss(gang, name):
    """Each planted fault, forward only: the first loss on every rank is
    more than PLANT_MIN from JAX's, where the sound case sits within 1e-5."""
    want = gang.jax(CASES[name][3])[0][0]
    for r in gang.result(name):
        assert abs(r["first_loss"] - want) > PLANT_MIN, (name, r["first_loss"], want)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    # below the test runner's own processes: on a loaded host the gang and
    # the JAX references yield the cores to the other test files
    os.nice(10)
    if sys.argv[1] == "jax":
        _jax_worker(Path(sys.argv[2]), sys.argv[3:])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
