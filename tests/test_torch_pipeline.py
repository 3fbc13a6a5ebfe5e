"""The port's pipeline parallelism on gloo CPU gangs against the JAX package.

One gang of four processes (gloo, one thread each, f32, tiny shapes, a
grouped-matmul row block of 8 in both packages) is spawned once for the
module, at nice 10, and runs every case; two-rank cases run two at a
time on disjoint ranks. Beside it ``JAX_GROUPS`` processes run the JAX
package's Trainer on the same mesh over eight CPU devices, from the same
converted init and batch. Each rank writes its losses, pre-clip gradient
norms, the gradients at each step's params and the params after the
steps; the test gathers the blocks (``compat.gather_params``) and holds
them to JAX's within 1e-5, the params with the allowance of
``test_torch_ep_cp._assert_adam_params``.

- Dense (``tiny``, save_mid): pp 2 under gpipe and 1f1b, 1f1b interleaved
  with pp_chunks 2 (4 layers), pp 4 (4 layers), pp 2 x dp 2, pp 2 x fsdp
  2, pp 2 x tp 2 under both schedules.
- MoE (``tiny-moe``, save_mid) under pp 2 with the experts replicated in
  the stage (gmm top-1; sort top-2 at capacity factor 0.5, where choices
  drop per microbatch) and pp 2 x ep 2 (gmm).
- The schedule's integer functions against the JAX package's over a grid
  of (S, M, v), and every refusal in the JAX package's words.

Run as ``python tests/test_torch_pipeline.py RANK WORLD PORT DIR`` the
file is one rank of the gang (it imports no jax then); as ``python
tests/test_torch_pipeline.py jax DIR REF...`` it computes JAX references.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_ep_cp as epcp  # noqa: E402  (the gang helpers and the AdamW replay)

ROOT = epcp.ROOT
WORLD = 4
B, T = 8, 16  # the global LM batch
BLOCK = epcp.BLOCK
LOW_CF = 0.5

GPIPE = dict(pp_microbatches=2, pp_schedule="gpipe")
F1B = dict(pp_microbatches=2, pp_schedule="1f1b")
# name -> (mesh axes, model, config overrides); each is its own JAX reference
CASES = {
    "pp2_gpipe": ({"pp": 2}, "tiny", GPIPE),
    "pp2_1f1b": ({"pp": 2}, "tiny", F1B),
    "pp2_1f1b_v2": ({"pp": 2}, "tiny4", dict(F1B, pp_chunks=2)),
    "pp2_moe_gmm": ({"pp": 2}, "tiny-moe", dict(F1B, moe_dispatch="gmm")),
    "pp2_moe_sort": ({"pp": 2}, "tiny-moe", dict(F1B, moe_dispatch="sort", moe_top_k=2,
                                                   capacity_factor=LOW_CF)),
    "pp4": ({"pp": 4}, "tiny4", dict(F1B, pp_microbatches=4)),
    "pp2_dp2": ({"pp": 2, "dp": 2}, "tiny", F1B),
    "pp2_fsdp2": ({"pp": 2, "fsdp": 2}, "tiny", F1B),
    "pp2_tp2_gpipe": ({"pp": 2, "tp": 2}, "tiny", GPIPE),
    "pp2_tp2_1f1b": ({"pp": 2, "tp": 2}, "tiny", F1B),
    "pp2_ep2_gmm": ({"pp": 2, "ep": 2}, "tiny-moe", dict(F1B, moe_dispatch="gmm")),
}
MODELS = {"tiny": ("tiny", {}), "tiny4": ("tiny", {"n_layers": 4}), "tiny-moe": ("tiny-moe", {})}
# the JAX references, one process a list, the lists' times about equal
# (each reference logs its seconds in its process's log)
JAX_GROUPS = [
    ["pp2_ep2_gmm", "pp2_fsdp2"],
    ["pp2_moe_gmm", "pp2_dp2"],
    ["pp2_gpipe", "pp2_tp2_1f1b"],
    ["pp2_1f1b", "pp2_tp2_gpipe", "pp2_moe_sort"],
    ["pp2_1f1b_v2", "pp4"],
]


def _n(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def _rounds() -> list:
    two = [n for n, c in CASES.items() if _n(c[0]) == 2]
    four = [n for n, c in CASES.items() if _n(c[0]) == 4]
    return [two[i:i + 2] for i in range(0, len(two), 2)] + [[n] for n in four]


def _port_cfg(name: str):
    from tf_operator_tpu_torch.models import transformer as tt

    _, model, over = CASES[name]
    preset, size = MODELS[model]
    return tt.preset(preset, dtype=torch.float32, remat="save_mid", **size, **over)


def _inputs() -> dict:
    from tf_operator_tpu_torch.models import transformer as tt

    inp = {m: tt.init_transformer_numpy(tt.preset(p, **size), i)
           for i, (m, (p, size)) in enumerate(MODELS.items())}
    inp["tokens"] = np.random.RandomState(1).randint(0, 256, (B, T))
    return inp


# ---------------------------------------------------------------------------
# one rank of the gang
# ---------------------------------------------------------------------------


def _run_case(name: str, mesh, inp: dict, rank: int) -> dict:
    """This rank's part of one case: losses, grad norms, the gradients at
    each step's params, params."""
    from tf_operator_tpu_torch import compat
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.parallel.sharding import MeshPlan
    from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = _port_cfg(name)
    plan = MeshPlan(mesh)
    axes = tt.transformer_logical_axes(cfg)
    trainer = Trainer(lambda p, b, e: tt.lm_loss(p, b, cfg, mesh=mesh), None,
                      TrainerConfig(learning_rate=epcp.LR, weight_decay=epcp.WD,
                                    grad_clip=epcp.CLIP),
                      device="cpu", mesh=mesh, logical_axes=axes)
    state = trainer.state_from_params(compat.params_from_numpy(
        compat.shard_params(inp[CASES[name][1]], mesh, axes, rank), "cpu"))
    batch = plan.local_batch(torch.from_numpy(inp["tokens"]))
    out = {"losses": [], "grad_norms": [], "grads": []}
    for _ in range(epcp.STEPS):
        out["grads"].append(compat.params_to_numpy(trainer.gradients(state, batch)[1]))
        state, m = trainer.step(state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["params"] = compat.params_to_numpy(state.params)
    if cfg.n_experts:
        with torch.no_grad():
            out["metrics"] = sorted(tt.lm_loss_and_metrics(state.params, batch, cfg, mesh)[1])
    return out


def _worker(rank: int, world: int, port: int, d: Path) -> None:
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.mesh import device_mesh, mesh_ranks

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    inp = epcp._load_inputs(d)
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


class _Gang(epcp._Gang):
    """The gang's WORLD ranks and a process for each list of JAX_GROUPS."""

    def __init__(self, d: Path) -> None:
        self.d = d
        env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get(
            "PYTHONPATH", ""), "OMP_NUM_THREADS": "1", "TPUJOB_GMM_BLOCK_ROWS": str(BLOCK)}
        port = epcp._free_port()
        assert sorted(r for g in JAX_GROUPS for r in g) == sorted(CASES)
        cmds = {f"rank{r}": [str(r), str(WORLD), str(port), str(d)] for r in range(WORLD)}
        cmds.update({f"jax{j}": ["jax", str(d)] + g for j, g in enumerate(JAX_GROUPS)})
        self.logs = {k: open(d / f"{k}.log", "w") for k in cmds}
        self.procs = {k: subprocess.Popen([sys.executable, __file__] + args, env=env,
                                          stdout=self.logs[k], stderr=subprocess.STDOUT)
                      for k, args in cmds.items()}
        self.t0 = time.perf_counter()
        self.rcs = None

    def result(self, name: str) -> list:
        return self._load([self.d / f"{name}.{i}.pt" for i in range(_n(CASES[name][0]))],
                          f"result for {name}")


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def gang(inputs, tmp_path_factory):
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("gloo-gang-pp")
    g = _Gang(d)
    try:
        torch.save(inputs, d / "inputs.tmp")
        os.replace(d / "inputs.tmp", d / "inputs.pt")
        yield g
        g.wait()  # every process ended cleanly
    finally:
        g.close()


def _jax_cfg(name: str):
    import jax.numpy as jnp

    from tf_operator_tpu.models import transformer as jt

    _, model, over = CASES[name]
    preset, size = MODELS[model]
    return jt.preset(preset, dtype=jnp.float32, remat=False, **size, **over)


def _jax_run(ref: str, inp: dict):
    """The JAX Trainer on case ``ref``'s mesh and config: losses, the
    pre-clip gradient norms, params after the steps, the gradients at each
    step's params."""
    import jax
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models import transformer as jt
    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu.train.trainer import Trainer as JaxTrainer
    from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    axes, model, _ = CASES[ref]
    mesh = build_mesh(axes, devices=jax.devices()[:_n(axes)])
    cfg = _jax_cfg(ref)
    params = inp[model]
    jtr = JaxTrainer(mesh, loss_fn=lambda p, b, e: jt.lm_loss(p, b, cfg, mesh=mesh),
                     init_fn=lambda k: jax.tree_util.tree_map(jnp.asarray, params),
                     logical_axes=jt.transformer_logical_axes(cfg),
                     config=JaxTrainerConfig(learning_rate=epcp.LR, weight_decay=epcp.WD,
                                             grad_clip=epcp.CLIP))
    grad = jax.jit(jax.grad(lambda q, t: jt.lm_loss(q, t, cfg, mesh=mesh)))
    js = jtr.init(jax.random.PRNGKey(0))
    tok = jnp.asarray(inp["tokens"])
    losses, norms, grads = [], [], []
    for _ in range(epcp.STEPS):
        grads.append(grad(js.params, tok))
        norms.append(float(optax.global_norm(grads[-1])))
        js, m = jtr.step(js, tok)
        losses.append(float(m["loss"]))
    return (losses, norms, jax.tree_util.tree_map(np.asarray, js.params),
            jax.tree_util.tree_map(np.asarray, grads))


def _jax_worker(d: Path, refs: list) -> None:
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    inp = epcp._load_inputs(d)
    for ref in refs:
        path = d / f"jax_{ref}.pt"
        t0 = time.perf_counter()
        out = _jax_run(ref, inp)
        print(f"{ref}: {time.perf_counter() - t0:.1f} s", flush=True)
        torch.save(out, path.with_suffix(".tmp"))
        os.replace(path.with_suffix(".tmp"), path)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_steps_match_jax(gang, inputs, name):
    """Two AdamW steps (clip active) under the case's mesh and schedule:
    every rank's losses and pre-clip gradient norms, the gathered gradients
    at each step's params and the gathered params within 1e-5 of the JAX
    Trainer on the same mesh (``_assert_adam_params``)."""
    from tf_operator_tpu_torch.models import transformer as tt

    axes, model, _ = CASES[name]
    want_losses, want_norms, want_params, want_grads = gang.jax(name)
    results = gang.result(name)
    for r in results:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=0, atol=epcp.ATOL)
        np.testing.assert_allclose(r["grad_norms"], want_norms, rtol=0, atol=epcp.ATOL)
    assert want_norms[0] > epcp.CLIP  # the clip acted
    if CASES[name][1] == "tiny-moe":  # the scalar router losses only, as in JAX
        assert results[0]["metrics"] == ["ce_loss", "moe_lb_loss", "moe_z_loss"]
    logical = tt.transformer_logical_axes(_port_cfg(name))
    grads = [epcp._gathered(results, axes, logical, lambda r: r["grads"][s])
             for s in range(epcp.STEPS)]
    for step in range(epcp.STEPS):
        epcp._assert_trees(grads[step], want_grads[step], epcp.ATOL, f"step {step} grads vs JAX")
    n_allowed = epcp._assert_adam_params(
        epcp._gathered(results, axes, logical), want_params, inputs[model],
        (grads, results[0]["grad_norms"]), (want_grads, want_norms), "params vs JAX")
    print(f"{name}: {n_allowed} elements allowed more than {epcp.ATOL} by the replay")


def test_capacity_queues_drop_per_microbatch(inputs):
    """The sort case runs where choices drop: the first layer's router on
    the first microbatch (rows 0, 2, 4, 6: the strided split), at its
    capacity, leaves some choice without a slot."""
    from tf_operator_tpu_torch import compat
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.parallel import moe

    cfg = _port_cfg("pp2_moe_sort")
    p = compat.params_from_numpy(inputs["tiny-moe"], "cpu")
    rows = torch.from_numpy(inputs["tokens"])[0::cfg.pp_microbatches]
    x = tt._rms_norm(p["embed"][rows], p["layers"]["attn_norm"][0], cfg.norm_eps)
    logits = x.reshape(-1, cfg.d_model) @ p["layers"]["w_router"][0]
    cap = moe.expert_capacity(LOW_CF, 2, logits.shape[0], cfg.n_experts)
    counts = torch.bincount(moe._routing(logits, 2)[2].reshape(-1), minlength=cfg.n_experts)
    assert int(counts.max()) > cap


def test_schedule_coordinates_match_jax():
    """bubble_fraction, _fwd_coords and _bwd_coords against the JAX
    package's over every tick and stage of a grid of (S, M, v)."""
    import jax.numpy as jnp

    from tf_operator_tpu.parallel import pipeline as jp
    from tf_operator_tpu_torch.parallel import pipeline as pp

    # one shape of tick and stage grid for every (S, M, v): JAX's eager ops
    # compile once a shape
    t, stage = (jnp.asarray(a) for a in np.meshgrid(np.arange(64), np.arange(4), indexing="ij"))
    for S in (1, 2, 3, 4):
        for v in (1, 2, 3):
            for M in sorted({S, 2 * S, 3 * S} if v > 1 else {1, 2, 3, 5, 8}):
                assert pp.bubble_fraction(S, M, v) == jp.bubble_fraction(S, M, v)
                ticks = pp.n_ticks(S, M, v)
                assert ticks <= t.shape[0]
                for port_fn, jax_fn in ((pp._fwd_coords, jp._fwd_coords),
                                        (pp._bwd_coords, jp._bwd_coords)):
                    want = np.stack([np.broadcast_to(np.asarray(a), t.shape).astype(int)
                                     for a in jax_fn(t, stage, S, M, v)], axis=-1)[:ticks, :S]
                    got = np.array([[port_fn(i, s, S, M, v) for s in range(S)]
                                    for i in range(ticks)], dtype=int)
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{port_fn.__name__} S={S} M={M} v={v}")


def _host_mesh(axes: dict):
    return epcp._host_mesh(axes)


def _refusal(fn) -> str:
    with pytest.raises((ValueError, NotImplementedError)) as exc:
        fn()
    return f"{type(exc.value).__name__}: {exc.value}"


# pipeline_apply's refusals: (mesh axes, local batch rows, n_microbatches,
# schedule, n_chunks); the JAX side gets the global batch
APPLY_REFUSALS = {
    "interleaved_gpipe": ({"pp": 2}, 4, 2, "gpipe", 2),
    "interleaved_rounds": ({"pp": 2}, 6, 3, "1f1b", 2),
    "batch_microbatches": ({"pp": 2}, 6, 4, "1f1b", 1),
    "microbatch_data_shards": ({"pp": 2, "dp": 2}, 2, 4, "1f1b", 1),
    "unknown_schedule": ({"pp": 2}, 4, 2, "zigzag", 1),
}


@pytest.mark.parametrize("case", list(APPLY_REFUSALS))
def test_pipeline_apply_refusals_match_jax(case):
    """pipeline_apply refuses what the JAX package's refuses, in its words."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu.parallel import pipeline as jp
    from tf_operator_tpu_torch.parallel import pipeline as pp

    axes, rows, M, schedule, v = APPLY_REFUSALS[case]
    n_data = axes.get("dp", 1)
    jmesh = build_mesh(axes, devices=jax.devices()[:_n(axes)])
    jparams = jnp.zeros((axes["pp"] * v, 3))
    want = _refusal(lambda: jp.pipeline_apply(jparams, jnp.zeros((rows * n_data, 3)),
                                              lambda p, x: x, jmesh, M, schedule=schedule,
                                              n_chunks=v))
    got = _refusal(lambda: pp.pipeline_apply(torch.zeros(v, 3), torch.zeros(rows, 3),
                                             lambda p, x: x, _host_mesh(axes), M,
                                             schedule=schedule, n_chunks=v))
    assert got == want


# the transformer's refusals: (mesh axes, model, config overrides)
MODEL_REFUSALS = {
    "moe_tp_in_stage": ({"pp": 2, "tp": 2}, "tiny-moe", {}),
    "layers_virtual_stages": ({"pp": 2}, "tiny", {"pp_chunks": 2}),
    "kv_heads_tp": ({"pp": 2, "tp": 4}, "tiny", {"n_heads": 8}),
    "d_ff_tp": ({"pp": 2, "tp": 2}, "tiny", {"d_ff": 129}),
    "experts_ep": ({"pp": 2, "ep": 4}, "tiny-moe", {"n_experts": 6}),
}


@pytest.mark.parametrize("case", list(MODEL_REFUSALS))
def test_transformer_pp_refusals_match_jax(case):
    """The pipelined transformer refuses what the JAX package's does, in
    its words, before any compute."""
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import transformer as jt
    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu_torch import compat
    from tf_operator_tpu_torch.models import transformer as tt

    axes, model, over = MODEL_REFUSALS[case]
    over = dict(over, pp_microbatches=2)
    jcfg = jt.preset(model, dtype=jnp.float32, **over)
    jmesh = build_mesh(axes, devices=jax.devices()[:_n(axes)])
    want = _refusal(lambda: jt.transformer_hidden_pp(None, None, jcfg, jmesh))
    cfg = tt.preset(model, dtype=torch.float32, **over)
    params = compat.params_from_numpy(tt.init_transformer_numpy(cfg, 0), "cpu")
    got = _refusal(lambda: tt.transformer_hidden_pp(params, params["embed"],
                                                    torch.zeros(4, 8, dtype=torch.long), cfg,
                                                    tt._Spmd(cfg, _host_mesh(axes))))
    assert got == want


def test_port_only_refusals():
    """What the port does not run under pp raises naming its reason: a pp
    axis without pp_microbatches, pp with cp; MoE under cp still raises."""
    from tf_operator_tpu_torch.models import transformer as tt

    cases = {("tiny", 2, "cp"): "cp inside a pipeline stage is not ported",
             ("tiny", 2, None): None,
             ("tiny", 0, None): "without pp_microbatches",
             ("tiny-moe", 0, "cp"): "MoE under a cp axis"}
    for (model, micro, other), words in cases.items():
        axes = {"pp": 2} if other is None else {"pp": 2, other: 2}
        if model == "tiny-moe":
            axes = {"cp": 2}
        cfg = tt.preset(model, pp_microbatches=micro)
        if words is None:
            tt.check_supported(cfg, _host_mesh(axes))
            continue
        with pytest.raises(NotImplementedError, match=words):
            tt.check_supported(cfg, _host_mesh(axes))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    # below the test runner's own processes: on a loaded host the gang and
    # the JAX references yield the cores to the other test files
    os.nice(10)
    if sys.argv[1] == "jax":
        _jax_worker(Path(sys.argv[2]), sys.argv[3:])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
