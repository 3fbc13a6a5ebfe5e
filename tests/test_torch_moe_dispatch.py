"""The port's sort, einsum and ragged MoE dispatches against the JAX
package's, on the CPU in f32, inputs from a numpy seed.

- ``_moe_single`` (sort and einsum, top-1 and top-2, ``passthrough`` and
  ``zero``) at a capacity of half the tokens' share, where choices drop:
  the kept slots (the sort path's flat slots, the einsum path's one-hot
  dispatch) identical to JAX's, the output, the stats (drop fraction
  above 0) and the grads of x, the router logits and the expert weights
  within 1e-5; planted logit ties go to the lower expert on both sides;
  sort and einsum agree with each other. Under ``passthrough`` at top-2,
  JAX's router gradient can be NaN on the rows of tokens that lost every
  choice (a fault of the reference, ROADMAP Queue 3 F2; eager JAX on the
  CPU shows it for sort); the port's is 0 there, the gradient (such a
  token yields its input), and JAX's NaN rows are held to that.
- ``_moe_single_ragged`` with ``ragged_swiglu``, top-1 and top-2: output,
  stats and grads within 1e-5.
- ``tiny-moe`` (top-2, capacity factor 0.5) under each dispatch: loss,
  the MoE metrics and every grad within 1e-5 of JAX's; and the lm
  workload's router line reports the drops.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu.parallel import moe as jmoe  # noqa: E402
from tf_operator_tpu_torch import compat  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402
from tf_operator_tpu_torch.parallel import moe  # noqa: E402
from tf_operator_tpu_torch.workloads import lm  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5  # f32 on both sides; only the order of the sums differs
CF = 0.5  # half of each expert's even share: choices drop


def _jax_expert(wp, t):
    return (jax.nn.silu(t @ wp["w_gate"]) * (t @ wp["w_up"])) @ wp["w_down"]


def _case(k_top):
    """40 tokens, 4 experts, d 16, f 24; tokens 0-4 tie for their top
    expert (0 and 2), tokens 5-9 for their second (1 and 2)."""
    rng = np.random.RandomState(11 + k_top)
    tokens, d, f, n_e = 40, 16, 24, 4
    x = rng.randn(tokens, d).astype(np.float32)
    logits = rng.randn(tokens, n_e).astype(np.float32)
    logits[0:5, :3] = [3.0, 1.0, 3.0]
    logits[5:10, :3] = [4.0, 2.0, 2.0]
    params = {"w_gate": rng.randn(n_e, d, f) / 4, "w_up": rng.randn(n_e, d, f) / 4,
              "w_down": rng.randn(n_e, f, d) / 5}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    g = rng.randn(tokens, d).astype(np.float32)
    return x, logits, params, g


def _jax_side(fn, x, logits, params, g):
    @jax.jit
    def run(x, logits, params, g):
        (out, stats), vjp = jax.vjp(fn, x, logits, params)
        return out, stats, vjp((g, jax.tree_util.tree_map(jnp.zeros_like, stats)))

    return jax.tree_util.tree_map(np.array, run(x, logits, params, g))


def _port_side(fn, x, logits, params, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    lt = torch.from_numpy(logits).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    out, stats = fn(xt, lt, pt)
    out.backward(torch.from_numpy(g))
    grads = (xt.grad.numpy(), lt.grad.numpy(), {k: v.grad.numpy() for k, v in pt.items()})
    return out.detach().numpy(), {k: v.detach().numpy() for k, v in stats.items()}, grads


def _assert_close(got, want, what):
    out, stats, grads = got
    w_out, w_stats, w_grads = want
    np.testing.assert_allclose(out, w_out, atol=ATOL, rtol=0, err_msg=f"{what} out")
    for name in ("expert_load", "mean_gate", "drop_frac"):
        np.testing.assert_allclose(stats[name], w_stats[name], atol=ATOL, rtol=0,
                                   err_msg=f"{what} {name}")
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(grads),
                            jax.tree_util.tree_leaves(w_grads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0,
                                   err_msg=f"{what} grad {path}")


@pytest.mark.parametrize("dropped", ["passthrough", "zero"])
@pytest.mark.parametrize("k_top", [1, 2])
def test_capacity_dispatches_match_jax(k_top, dropped):
    x, logits, params, g = _case(k_top)
    cap = moe.expert_capacity(CF, k_top, x.shape[0], logits.shape[1])
    assert cap == jmoe.expert_capacity(CF, k_top, x.shape[0], logits.shape[1])

    # the kept slots, identical: sort's flat slots and einsum's one-hot map
    slot_j, disp_j = jax.jit(lambda x, lg: (
        jmoe._route_sparse(x, lg, cap, k_top, dropped)[0],
        jmoe._route(x, lg, cap, k_top, dropped)[0] != 0))(x, logits)
    slot_t = moe._route_sparse(torch.from_numpy(x), torch.from_numpy(logits), cap, k_top,
                               dropped)[0].numpy()
    np.testing.assert_array_equal(slot_t, np.asarray(slot_j))
    disp_t = moe._route(torch.from_numpy(x), torch.from_numpy(logits), cap, k_top,
                        dropped)[0].numpy() != 0
    np.testing.assert_array_equal(disp_t, np.asarray(disp_j))
    dump = logits.shape[1] * cap
    lost_all = (slot_t == dump).all(axis=1)
    e, c = np.divmod(slot_t[slot_t < dump], cap)
    assert disp_t.sum() == len(e) and disp_t[np.nonzero(slot_t < dump)[0], e, c].all()
    assert (slot_t == dump).any()  # something dropped
    assert slot_t[0, 0] == 0  # token 0's tie went to expert 0, the lower index

    outs = {}
    for impl in ("sort", "einsum"):
        want = _jax_side(
            lambda a, b, p, impl=impl: jmoe._moe_single(a, b, p, _jax_expert, cap, dropped,
                                                        k_top, impl),
            x, logits, params, g)
        got = _port_side(
            lambda a, b, p, impl=impl: moe._moe_single(a, b, p, tt._swiglu_experts, cap,
                                                       dropped, k_top, impl),
            x, logits, params, g)
        nan_rows = np.isnan(want[2][1]).any(axis=1)
        if dropped == "passthrough" and k_top == 2:
            assert lost_all.any() and (got[2][1][lost_all] == 0).all()
            want[2][1][nan_rows] = 0.0
        assert (nan_rows <= lost_all).all() and (not nan_rows.any() or dropped == "passthrough")
        _assert_close(got, want, f"{impl} k={k_top} {dropped}")
        assert got[1]["drop_frac"] > 0
        outs[impl] = got
    _assert_close(outs["sort"], outs["einsum"], "sort vs einsum")


@pytest.mark.parametrize("k_top", [1, 2])
def test_ragged_dispatch_matches_jax(k_top):
    x, logits, params, g = _case(k_top)
    want = _jax_side(
        lambda a, b, p: jmoe._moe_single_ragged(a, b, p, jmoe.ragged_swiglu, k_top),
        x, logits, params, g)
    got = _port_side(
        lambda a, b, p: moe._moe_single_ragged(a, b, p, moe.ragged_swiglu, k_top),
        x, logits, params, g)
    _assert_close(got, want, f"ragged k={k_top}")
    assert got[1]["drop_frac"] == 0


@pytest.fixture(scope="module")
def tiny_moe():
    """tiny-moe's params (numpy, the JAX package's tree) and tokens."""
    params = tt.init_transformer_numpy(tt.preset("tiny-moe"), 0)
    tokens = np.random.RandomState(5).randint(0, 256, (4, 16)).astype(np.int32)
    return params, tokens


@pytest.mark.parametrize("impl", ["sort", "einsum", "ragged"])
def test_tiny_moe_dispatch_matches_jax(tiny_moe, impl):
    """Total loss, ce_loss, the four MoE metrics (a nonzero drop fraction
    under sort and einsum) and every grad within 1e-5, top-2 at capacity
    factor 0.5, full remat on the port's side."""
    params, tokens = tiny_moe
    over = dict(moe_dispatch=impl, moe_top_k=2, capacity_factor=CF)
    jcfg = jt.preset("tiny-moe", dtype=jnp.float32, **over)
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss_and_metrics(p, tokens, jcfg), has_aux=True))(params)
    cfg = tt.preset("tiny-moe", dtype=torch.float32, remat="full", **over)
    p = compat.params_from_numpy(params, "cpu")
    for x in jax.tree_util.tree_leaves(p):
        x.requires_grad_(True)
    loss, metrics = tt.lm_loss_and_metrics(p, torch.from_numpy(tokens).long(), cfg)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), abs=ATOL)
    assert set(metrics) == set(want_m)
    for name, want in want_m.items():
        assert float(metrics[name].detach()) == pytest.approx(float(want), abs=ATOL), name
    assert (float(metrics["moe_drop_frac"]) > 0) == (impl != "ragged")
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(p),
                            jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=ATOL, rtol=0,
                                   err_msg=f"{impl} {path}")


def test_lm_workload_reports_drops():
    """tiny-moe with the default dispatch (sort) at capacity factor 0.5:
    the workload trains and its router line carries the drops."""
    wl = {"preset": "tiny-moe", "capacity_factor": CF, "steps": 2, "batch_size": 2,
          "seq_len": 16, "attn": "flash", "remat": "dots", "device": "cpu"}
    run = lm.run_lm(wl, device="cpu")
    assert run.cfg.moe_dispatch == "sort" and np.isfinite(run.losses).all()
    assert 0.0 < lm.router_metrics(run)["drop_frac"] < 1.0
