"""The port's training path against the JAX package's, on the CPU at the
``tiny`` preset in f32, inputs from a numpy seed: the model's loss and
grads in every ported attention and remat mode, a 5-step AdamW loss
trajectory against the JAX Trainer on a 1-device mesh (grad_accum 1 and
2), the optimizer's schedules, the FLOP accounting, and the lm workload
with a stub context.
"""

import logging

import numpy as np
import optax
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu.parallel import build_mesh  # noqa: E402
from tf_operator_tpu.train import metrics as jmetrics  # noqa: E402
from tf_operator_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from tf_operator_tpu.train.trainer import _make_tx  # noqa: E402
from tf_operator_tpu_torch import compat  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402
from tf_operator_tpu_torch.ops import flash_attention as fa  # noqa: E402
from tf_operator_tpu_torch.train import checkpoint as ck  # noqa: E402
from tf_operator_tpu_torch.train import metrics  # noqa: E402
from tf_operator_tpu_torch.train.trainer import (  # noqa: E402
    Trainer,
    TrainerConfig,
    learning_rate_at,
)
from tf_operator_tpu_torch.workloads import lm  # noqa: E402

torch.set_num_threads(1)

B, T = 4, 16


@pytest.fixture(scope="module")
def setup():
    """tiny in f32: JAX params (numpy), tokens, and JAX's loss and grads."""
    jcfg = jt.preset("tiny", dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jt.init_transformer(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.RandomState(5).randint(0, jcfg.vocab, (B, T)).astype(np.int32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jt.lm_loss(p, tokens, jcfg)))(params)
    return params, tokens, float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("attn,remat,fused", [
    ("dense", "none", True), ("dense", "full", True), ("dense", "save_mid", True),
    ("flash", "none", True), ("flash", "full", True), ("flash", "save_mid", False),
])
def test_lm_loss_and_grads_match_jax(setup, attn, remat, fused):
    """Loss and every param's grad within 1e-5 (f32; only the order of the
    sums differs), the tied embedding's grad included."""
    params, tokens, want_loss, want_grads = setup
    cfg = tt.preset("tiny", dtype=torch.float32, attn_impl=attn, remat=remat,
                    fused_xent=fused)
    p = compat.params_from_numpy(params, "cpu")
    for x in jax.tree_util.tree_leaves(p):
        x.requires_grad_(True)
    loss = tt.lm_loss(p, torch.from_numpy(tokens).long(), cfg)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(want_loss, abs=1e-5)
    got = jax.tree_util.tree_map(lambda x: x.grad.numpy(), p)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want_grads)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("save_mid", 2)])
def test_flash_forward_runs_per_remat_mode(monkeypatch, remat, fwd_per_layer):
    """save_mid recomputes the attention half in the backward, so one step
    runs the flash forward 2·L times and the backward L times; without
    remat L and L (what chip_smoke.py checks as kernel launches)."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.flash_fwd_reference, fa.flash_bwd_reference

    def fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(fa, "flash_fwd_reference", fwd)
    monkeypatch.setattr(fa, "flash_bwd_reference", bwd)
    cfg = tt.preset("tiny", attn_impl="flash", remat=remat)
    p = tt.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    for x in jax.tree_util.tree_leaves(p):
        x.requires_grad_(True)
    tt.lm_loss(p, torch.randint(0, cfg.vocab, (2, 8)), cfg).backward()
    assert calls == {"fwd": fwd_per_layer * cfg.n_layers, "bwd": cfg.n_layers}


def test_unported_modes_raise():
    p = tt.init_transformer(tt.preset("tiny"), torch.Generator().manual_seed(0), "cpu")
    tok = torch.zeros(1, 4, dtype=torch.long)
    # without a cp axis ring and ulysses attend densely, as JAX's do; without
    # a pp axis pp_microbatches changes nothing, as in JAX
    dense = tt.lm_loss(p, tok, tt.preset("tiny"))
    for impl in ("ring", "ulysses"):
        assert float(tt.lm_loss(p, tok, tt.preset("tiny", attn_impl=impl))) == float(dense)
    assert float(tt.lm_loss(p, tok, tt.preset("tiny", pp_microbatches=2))) == float(dense)
    # under a mesh: a pp axis without pp_microbatches, pp with cp, and MoE
    # under a cp axis (Queue 1 item 12); no process group is needed to
    # build a mesh, and the check comes before any collective
    from tf_operator_tpu_torch.parallel.mesh import build_mesh

    for axes, cfg, match in (({"pp": 2}, tt.preset("tiny"), "without pp_microbatches"),
                             ({"pp": 2, "cp": 2}, tt.preset("tiny", pp_microbatches=2),
                              "cp inside a pipeline stage"),
                             ({"cp": 2}, tt.preset("tiny-moe"), "item 12")):
        with pytest.raises(NotImplementedError, match=match):
            tt.lm_loss(p, tok, cfg, mesh=build_mesh(axes, ranks=range(2 * len(axes))))
    with pytest.raises(ValueError, match="unknown remat mode"):
        tt.lm_loss(p, tok, tt.preset("tiny", remat="save_everything"))
    with pytest.raises(ValueError, match="unknown activation"):
        tt.remat_save_names("save:resid_mld")
    assert tt.remat_save_names("save:resid_mid") == ("resid_mid",)
    assert tt.KNOWN_SAVE_NAMES == jt.KNOWN_SAVE_NAMES
    for name in ("tiny", "gqa-2048", "mixtral-8x7b"):
        assert tt.PRESETS[name].n_active_params() == jt.PRESETS[name].n_active_params()
    # sgd is ported (the ResNet path); an optimizer neither package has raises
    Trainer(loss_fn=None, init_fn=None, config=TrainerConfig(optimizer="sgd"), device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer"):
        Trainer(loss_fn=None, init_fn=None, config=TrainerConfig(optimizer="lion"), device="cpu")


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_trajectory_matches_jax_trainer(setup, accum):
    """Five AdamW steps (clip 1.0, lr 3e-3, weight decay 0.1) on one fixed
    batch: the losses within 2e-5. Both sides are f32 with sums in other
    orders; Adam's m/sqrt(v) divides out the grads' scale, so a 1e-7
    relative grad difference stays ~1e-7 in each update (the measured gap
    is ~1e-6), while five steps at this learning rate move the loss by
    ~1, so a wrong moment, bias correction or clip shows far above it."""
    params, tokens, _, _ = setup
    jcfg = jt.preset("tiny", dtype=jnp.float32)
    tcfg = tt.preset("tiny", dtype=torch.float32)
    conf = dict(learning_rate=3e-3, weight_decay=0.1, grad_accum=accum)
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
    assert ts.step == 5 and ts.opt_state["count"] == 5
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert got[-1] < got[0] - 1e-3


@pytest.mark.parametrize("over", [
    {}, {"warmup_steps": 4}, {"lr_schedule": "cosine", "warmup_steps": 3, "total_steps": 20},
    # cosine edges: optax refuses total_steps <= max(warmup_steps, 1)
    {"lr_schedule": "cosine", "warmup_steps": 10, "total_steps": 5},
    {"lr_schedule": "cosine", "warmup_steps": 4, "total_steps": 4},
    {"lr_schedule": "cosine", "warmup_steps": 0, "total_steps": 1},
    {"lr_schedule": "cosine", "warmup_steps": 0, "total_steps": 2},
], ids=["constant", "warmup", "cosine", "cosine_w10_t5", "cosine_w4_t4", "cosine_w0_t1",
        "cosine_w0_t2"])
def test_schedules_match_optax(over):
    """constant, linear warmup and warmup-cosine at optax's update counts:
    the JAX _make_tx and the port's Trainer both refuse a config, or the
    port's lr equals optax's at every count."""
    conf = dict(learning_rate=1e-3, **over)
    jcfg = JaxTrainerConfig(**conf)
    cfg = TrainerConfig(**conf)
    make = lambda: Trainer(lambda *a: None, lambda g: {}, cfg, device="cpu")  # noqa: E731
    try:
        if jcfg.lr_schedule == "cosine":
            sched = optax.warmup_cosine_decay_schedule(
                0.0, 1e-3, max(jcfg.warmup_steps, 1), jcfg.total_steps)
        elif jcfg.warmup_steps:
            sched = optax.linear_schedule(0.0, 1e-3, jcfg.warmup_steps)
        else:
            sched = lambda c: 1e-3  # noqa: E731
    except ValueError:
        with pytest.raises(ValueError):
            _make_tx(jcfg)
        with pytest.raises(ValueError, match="cosine schedule"):
            make()
        with pytest.raises(ValueError, match="cosine schedule"):
            learning_rate_at(cfg, jcfg.warmup_steps + 1)
        return
    assert _make_tx(jcfg) is not None
    make()
    for count in range(0, 26):
        assert learning_rate_at(cfg, count) == pytest.approx(
            float(sched(count)), rel=1e-6, abs=1e-12), (over, count)


def test_flop_accounting_matches_jax_and_peak_table():
    n = tt.PRESETS["gqa-2048"].n_active_params()
    assert metrics.transformer_train_flops(n, 12288) == jmetrics.transformer_train_flops(n, 12288)
    assert metrics.transformer_train_flops_exact(n, 12288, 12, 2048, 2048) == \
        jmetrics.transformer_train_flops_exact(n, 12288, 12, 2048, 2048)
    with pytest.raises(ValueError, match="CUDA-card"):
        metrics.peak_flops_per_chip(torch.device("cpu"))


class _Ctx:
    num_processes = 1

    def __init__(self, workload):
        self.workload = workload
        self.first = []

    def mark_first_step(self, step):
        self.first.append(step)


def test_lm_workload_main_and_fault_injection(tmp_path, caplog):
    wl = {"preset": "tiny", "steps": 3, "batch_size": 2, "seq_len": 16,
          "attn": "flash", "remat": "save_mid", "device": "cpu"}
    ctx = _Ctx(wl)
    with caplog.at_level(logging.INFO, logger="tpujob.lm"):
        lm.main(ctx)
    assert ctx.first == [1]
    assert any("lm done: preset=tiny" in r.message for r in caplog.records)

    marker = tmp_path / "failed-once"
    ctx = _Ctx({**wl, "fail_at_step": 2, "fail_marker": str(marker)})
    with pytest.raises(SystemExit) as exc:
        lm.main(ctx)
    assert exc.value.code == lm.USER_RETRYABLE_CODE == 138 and marker.exists()
    lm.main(ctx)  # the marker makes the fault once-only

    run = lm.run_lm(wl, device="cpu")
    assert len(run.losses) == 4 and run.timed == 3 and run.tokens_per_step == 32
    assert all(np.isfinite(run.losses)) and run.mfu(run.flops_exact) is None
    with pytest.raises(NotImplementedError, match="orbax"):
        lm.run_lm({**wl, "checkpoint_dir": str(tmp_path), "checkpoint_backend": "orbax"},
                  device="cpu")
    # streamed batches through the DeviceLoader (ported: ROADMAP M5)
    streamed = lm.run_lm({**wl, "data": "stream"}, device="cpu")
    assert streamed.data["delivered"] == 4 and all(np.isfinite(streamed.losses))
    with pytest.raises(ValueError, match="unknown data mode"):
        lm.run_lm({**wl, "data": "tfrecord"}, device="cpu")
    # a two-process job's checkpointer (made before a gang is joined, it
    # stamps the job's world and refuses another world's step), and more
    # than one card a process still raises, before the gang is joined
    two = ck.WorkloadCheckpointer({**wl, "checkpoint_dir": str(tmp_path / "gang")},
                                  ctx=type("C", (_Ctx,), {"num_processes": 2})(wl))
    assert two.manager.world_size == 2 and not two.manager.allow_world_resize
    with pytest.raises(NotImplementedError, match="one process drives one card"):
        lm.main(type("C", (_Ctx,), {"num_processes": 2, "chips": 4})(wl))
