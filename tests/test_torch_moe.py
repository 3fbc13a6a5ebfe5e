"""The port's MoE training path against the JAX package's, on the CPU in
f32 with a row block of 8, inputs from a numpy seed: ``_moe_single_gmm``'s
output, stats and grads for top-1 and top-2 routing with planted logit
ties and an expert that gets no token; ``tiny-moe`` with
``moe_dispatch="gmm"``: loss, the four MoE metrics and every grad in each
ported remat mode, and a 5-step AdamW trajectory against the JAX Trainer;
the grouped-matmul calls one step makes per remat mode; and the lm
workload on ``tiny-moe`` with a stub context. The Pallas kernels on the
JAX side run in interpret mode, as ``_moe_single_gmm`` runs them off TPU.
"""

import logging
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu.parallel import build_mesh  # noqa: E402
from tf_operator_tpu.parallel import moe as jmoe  # noqa: E402
from tf_operator_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from tf_operator_tpu_torch import compat  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402
from tf_operator_tpu_torch.ops import grouped_matmul as gm  # noqa: E402
from tf_operator_tpu_torch.parallel import moe  # noqa: E402
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from tf_operator_tpu_torch.workloads import lm  # noqa: E402

torch.set_num_threads(1)

BLOCK = 8
B, T = 4, 16
# f32 on both sides; only the order of the sums differs (~1e-7 seen).
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _block_rows():
    """Both packages read the row block from TPUJOB_GMM_BLOCK_ROWS."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUJOB_GMM_BLOCK_ROWS", str(BLOCK))
        yield


def _assert_trees_close(got, want, what):
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=f"{what} {path}")


def _router_case(k_top):
    """40 tokens, 4 experts, d 16, f 24. Tokens 0-4 tie for the top expert
    (0 and 2), tokens 5-9 for the second (1 and 2, top-2 only); expert 3
    never wins a choice, so it owns one all-padding block."""
    rng = np.random.RandomState(7 + k_top)
    tokens, d, f, n_e = 40, 16, 24, 4
    x = rng.randn(tokens, d).astype(np.float32)
    logits = rng.randn(tokens, n_e).astype(np.float32)
    logits[:, 3] = -10.0
    logits[0:5, :3] = [3.0, 1.0, 3.0]
    logits[5:10, :3] = [4.0, 2.0, 2.0]
    params = {"w_gate": rng.randn(n_e, d, f) / 4, "w_up": rng.randn(n_e, d, f) / 4,
              "w_down": rng.randn(n_e, f, d) / 5}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    g = rng.randn(tokens, d).astype(np.float32)
    return x, logits, params, g


@pytest.mark.parametrize("k_top", [1, 2])
def test_moe_single_gmm_matches_jax(k_top):
    """Output, stats, and grads of x, the logits and the three expert
    weights, against JAX; ties go to the lower expert; the expert with no
    token gets exact-zero weight grads."""
    x, logits, params, g = _router_case(k_top)

    def jfn(x, logits, params):
        return jmoe._moe_single_gmm(x, logits, params, k_top, block_rows=BLOCK)

    @jax.jit
    def jax_side(x, logits, params, g):
        (out, stats), vjp = jax.vjp(jfn, x, logits, params)
        zero_stats = jax.tree_util.tree_map(jnp.zeros_like, stats)
        return out, stats, vjp((g, zero_stats))

    want_out, want_stats, want_grads = jax_side(x, logits, params, g)

    xt = torch.from_numpy(x).requires_grad_(True)
    lt = torch.from_numpy(logits).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    out, stats = moe._moe_single_gmm(xt, lt, pt, k_top, block_rows=BLOCK)
    out.backward(torch.from_numpy(g))

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL, rtol=0)
    for name in ("expert_load", "mean_gate", "drop_frac"):
        np.testing.assert_allclose(stats[name].detach().numpy(), np.asarray(want_stats[name]),
                                   atol=ATOL, rtol=0, err_msg=name)
    _assert_trees_close([xt.grad.numpy(), lt.grad.numpy(),
                         {k: v.grad.numpy() for k, v in pt.items()}],
                        list(want_grads), f"k_top={k_top} grad")
    _, idx = moe._top_k(torch.softmax(torch.from_numpy(logits), -1), k_top)
    assert (idx[0:5, 0] == 0).all()
    if k_top == 2:
        assert (idx[0:5, 1] == 2).all() and (idx[5:10, 1] == 1).all()
    assert float(stats["expert_load"][3]) == 0.0
    for k in pt:
        assert (pt[k].grad[3] == 0).all(), k


@pytest.fixture(scope="module")
def tiny_moe():
    """tiny-moe (gmm dispatch) in f32: JAX params (numpy), tokens, and
    JAX's loss, metrics and grads."""
    jcfg = jt.preset("tiny-moe", dtype=jnp.float32, moe_dispatch="gmm")
    params = jax.tree_util.tree_map(np.asarray, jt.init_transformer(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.RandomState(5).randint(0, jcfg.vocab, (B, T)).astype(np.int32)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss_and_metrics(p, tokens, jcfg), has_aux=True))(params)
    return params, tokens, float(loss), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("remat", ["none", "full", "save_mid"])
def test_tiny_moe_loss_metrics_and_grads_match_jax(tiny_moe, remat):
    """Total loss (CE plus the weighted router losses), ce_loss,
    moe_lb_loss, moe_z_loss, moe_expert_entropy, moe_drop_frac and every
    param's grad (router and experts included) within 1e-5."""
    params, tokens, want_loss, want_metrics, want_grads = tiny_moe
    cfg = tt.preset("tiny-moe", dtype=torch.float32, moe_dispatch="gmm", remat=remat)
    p = compat.params_from_numpy(params, "cpu")
    for x in jax.tree_util.tree_leaves(p):
        x.requires_grad_(True)
    loss, metrics = tt.lm_loss_and_metrics(p, torch.from_numpy(tokens).long(), cfg)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(want_loss, abs=ATOL)
    assert set(metrics) == set(want_metrics)
    for name, want in want_metrics.items():
        assert float(metrics[name].detach()) == pytest.approx(want, abs=ATOL), name
    assert want_metrics["moe_lb_loss"] > 0 and want_metrics["moe_z_loss"] > 0
    _assert_trees_close(jax.tree_util.tree_map(lambda x: x.grad.numpy(), p), want_grads,
                        remat)


@pytest.mark.parametrize("remat,per_layer", [
    ("none", (5, 1, 2, 1)), ("full", (7, 2, 2, 1)), ("save_mid", (7, 2, 2, 1)),
])
def test_grouped_matmul_calls_per_remat_mode(monkeypatch, remat, per_layer):
    """One step's grouped-matmul calls per layer (K5, K6, K7a, K7b): the
    forward's gate, up and down products, the backward's three transposed
    products and three dw walks, and under full or save_mid remat the MoE
    forward again (what chip_smoke.py checks as kernel launches)."""
    calls = {"k5": 0, "k6": 0, "k7a": 0, "k7b": 0}
    real_fwd, real_dw = gm.gmm_fwd_reference, gm.gmm_dw_reference

    def fwd(x, w, be, row_scale=None, **kw):
        calls["k5" if row_scale is None else "k6"] += 1
        return real_fwd(x, w, be, row_scale, **kw)

    def dw(x, dy, be, n, row_scale=None, **kw):
        calls["k7a" if row_scale is None else "k7b"] += 1
        return real_dw(x, dy, be, n, row_scale, **kw)

    monkeypatch.setattr(gm, "gmm_fwd_reference", fwd)
    monkeypatch.setattr(gm, "gmm_dw_reference", dw)
    cfg = tt.preset("tiny-moe", moe_dispatch="gmm", attn_impl="flash", remat=remat)
    p = tt.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    for x in jax.tree_util.tree_leaves(p):
        x.requires_grad_(True)
    tt.lm_loss(p, torch.randint(0, cfg.vocab, (2, 8)), cfg).backward()
    L = cfg.n_layers
    assert calls == dict(zip(("k5", "k6", "k7a", "k7b"), (n * L for n in per_layer)))


def test_adamw_trajectory_matches_jax_trainer(tiny_moe):
    """Five AdamW steps (clip 1.0, lr 3e-3, weight decay 0.1) on one batch
    of tiny-moe: the losses (router losses included) within 2e-5, as for
    the dense model (tests/test_torch_train.py). Routing is re-decided
    every step from the updated router on both sides."""
    params, tokens, _, _, _ = tiny_moe
    jcfg = jt.preset("tiny-moe", dtype=jnp.float32, moe_dispatch="gmm")
    tcfg = tt.preset("tiny-moe", dtype=torch.float32, moe_dispatch="gmm")
    conf = dict(learning_rate=3e-3, weight_decay=0.1)
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jtr = JaxTrainer(mesh, loss_fn=lambda p, b, e: jt.lm_loss(p, b, jcfg),
                     init_fn=lambda k: jax.tree_util.tree_map(jnp.asarray, params),
                     config=JaxTrainerConfig(**conf))
    js = jtr.init(jax.random.PRNGKey(0))
    ttr = Trainer(loss_fn=lambda p, b, e: tt.lm_loss(p, b, tcfg), init_fn=None,
                  config=TrainerConfig(**conf), device="cpu")
    ts = ttr.state_from_params(compat.params_from_numpy(params, "cpu"))
    tok = torch.from_numpy(tokens).long()
    want, got = [], []
    for _ in range(5):
        js, jm = jtr.step(js, jnp.asarray(tokens))
        ts, tm = ttr.step(ts, tok)
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert got[-1] < got[0] - 1e-3


class _Ctx:
    num_processes = 1

    def __init__(self, workload):
        self.workload = workload
        self.first = []

    def mark_first_step(self, step):
        self.first.append(step)


def test_lm_workload_main_on_tiny_moe(caplog):
    wl = {"preset": "tiny-moe", "moe_dispatch": "gmm", "steps": 2, "batch_size": 2,
          "seq_len": 16, "attn": "flash", "remat": "full", "device": "cpu"}
    ctx = _Ctx(wl)
    with caplog.at_level(logging.INFO, logger="tpujob.lm"):
        lm.main(ctx)
    assert ctx.first == [1]
    router = [r.message for r in caplog.records if r.message.startswith("moe router:")]
    assert len(router) == 1 and f"(uniform={math.log(4):.3f})" in router[0]
    assert any("lm done: preset=tiny-moe" in r.message for r in caplog.records)
    run = lm.run_lm(wl, device="cpu")
    m = lm.router_metrics(run)
    assert 0.0 < m["expert_entropy"] <= math.log(4) + 1e-6 and m["drop_frac"] == 0.0
    assert run.cfg.n_active_params() < run.cfg.n_params()
    assert lm.router_metrics(lm.run_lm({**wl, "preset": "tiny"}, device="cpu")) is None


GMM_KEYS = ("w_gate", "w_up", "w_down")


def tmesh_of(axes):
    from tf_operator_tpu_torch.parallel import mesh

    return mesh.build_mesh(axes, ranks=range(int(np.prod(list(axes.values())))))


def test_unported_moe_paths_raise():
    x, logits = torch.zeros(8, 4), torch.zeros(8, 2)
    experts = {"w_gate": torch.zeros(2, 4, 8), "w_up": torch.zeros(2, 4, 8),
               "w_down": torch.zeros(2, 8, 4)}
    # under ep the mesh branch's errors are JAX's, word for word (each is
    # raised before any collective: a mesh without a process group will do)
    for axes, n_tok, n_exp, keys, impl in (({"ep": 2}, 8, 3, GMM_KEYS, "sort"),
                                           ({"ep": 2}, 7, 2, GMM_KEYS, "einsum"),
                                           ({"dp": 2, "ep": 2}, 6, 2, GMM_KEYS, "sort"),
                                           ({"ep": 2}, 8, 2, ("w",), "gmm")):
        jmesh = build_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
        tmesh = tmesh_of(axes)
        errors = []
        for pkg, mesh, arr in ((jmoe, jmesh, jnp.zeros), (moe, tmesh, torch.zeros)):
            # the port takes a rank's rows: the global count over the data axes
            rows = n_tok if pkg is jmoe else n_tok // axes.get("dp", 1)
            with pytest.raises(ValueError) as err:
                pkg.moe_apply(arr((rows, 4)), arr((rows, n_exp)), {k: arr((n_exp, 4, 4))
                                                                    for k in keys},
                              None, mesh, dispatch_impl=impl)
            errors.append(str(err.value))
        assert errors[0] == errors[1], errors
    with pytest.raises(ValueError, match="needs an expert_fn"):
        moe.moe_apply(x, logits, experts, dispatch_impl="sort")
    with pytest.raises(ValueError, match="needs a ragged_expert_fn"):
        moe.moe_apply(x, logits, experts, dispatch_impl="ragged")
    with pytest.raises(ValueError, match="unknown dropped mode"):
        moe.moe_apply(x, logits, experts, lambda wp, t: t, dispatch_impl="einsum",
                      dropped="drop")
    with pytest.raises(ValueError, match="SwiGLU"):
        moe.moe_apply(x, logits, {"w": x}, dispatch_impl="gmm")
    with pytest.raises(ValueError, match="unknown dispatch_impl"):
        moe.moe_apply(x, logits, experts, dispatch_impl="dense")
    assert moe.expert_capacity(2.0, 2, 100, 8) == jmoe.expert_capacity(2.0, 2, 100, 8) == 50
