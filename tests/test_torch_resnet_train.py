"""The port's ResNet training path against the JAX package's, on the CPU in
f32: a 3-step SGD (momentum 0.9) trajectory on ``tiny`` from the same
params and BN state against JAX's Trainer (as tests/test_models.py builds
it), with ``fused_1x1`` off and on; the ResNet-50 parameter count; the
model-FLOPs accounting; and the resnet workload with a stub context.
"""

import logging
import os
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import resnet as jr  # noqa: E402
from tf_operator_tpu.parallel import build_mesh  # noqa: E402
from tf_operator_tpu.train import metrics as jmetrics  # noqa: E402
from tf_operator_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from tf_operator_tpu.workloads import resnet as jwl  # noqa: E402
from tf_operator_tpu_torch import compat  # noqa: E402
from tf_operator_tpu_torch.models import resnet as tr  # noqa: E402
from tf_operator_tpu_torch.train import metrics  # noqa: E402
from tf_operator_tpu_torch.train.checkpoint import WorkloadCheckpointer  # noqa: E402
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig, _leaves  # noqa: E402
from tf_operator_tpu_torch.workloads import resnet as wl_mod  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("fused,clip", [(False, None), (True, 1.0)],
                         ids=["plain_noclip", "fused_1x1_clip"])
def test_sgd_trajectory_matches_jax_trainer(fused, clip):
    """Three SGD steps (lr 0.05, momentum 0.9) on one fixed batch from the
    same params and BN state: the losses within 2e-5, and the params (each
    leaf's total update), the BN running statistics and the momentum trace
    after them within 1e-2 of each leaf's largest magnitude. Both sides are
    f32 with sums in other orders; the grads of a few leaves whose true
    values cancel to near zero (a BN bias in front of another batch norm)
    carry that f32 rounding at up to ~5e-3 of their size here (see
    tests/test_torch_resnet_forward.py), the rest at ~1e-4. A wrong trace,
    learning rate or clip moves an update by O(1) of itself."""
    jcfg = jr.ResNetConfig((1, 1, 1, 1), (16, 32, 64, 128), 10, dtype=jnp.float32,
                           fused_1x1=fused)
    tcfg = tr.ResNetConfig((1, 1, 1, 1), (16, 32, 64, 128), 10, dtype=torch.float32,
                           fused_1x1=fused)
    params, state = compat.params_to_numpy(
        tr.init_resnet(tcfg, torch.Generator().manual_seed(1), "cpu"))
    rng = np.random.RandomState(3)
    images = rng.randn(4, 64, 64, 3).astype(np.float32)
    labels = rng.randint(0, 10, 4)

    def jloss(p, batch, s):
        logits, new_s = jr.resnet_forward(p, s, batch[0], jcfg, train=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, batch[1][:, None], axis=-1)), new_s

    conf = dict(optimizer="sgd", learning_rate=0.05, grad_clip=clip)
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jtr = JaxTrainer(mesh, loss_fn=jloss,
                     init_fn=lambda k: jax.tree_util.tree_map(jnp.asarray, (params, state)),
                     config=JaxTrainerConfig(**conf))
    js = jtr.init(jax.random.PRNGKey(0))
    ttr = Trainer(loss_fn=lambda p, b, s: wl_mod.resnet_loss(p, b, s, tcfg), init_fn=None,
                  config=TrainerConfig(**conf), device="cpu")
    ts = ttr.state_from_params(compat.params_from_numpy(params, "cpu"),
                               compat.params_from_numpy(state, "cpu"))
    batch = (torch.from_numpy(images), torch.from_numpy(labels))
    want, got = [], []
    for _ in range(3):
        js, jm = jtr.step(js, (jnp.asarray(images), jnp.asarray(labels)))
        ts, tm = ttr.step(ts, batch)
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    assert ts.step == 3 and ts.opt_state["count"] == 3
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert got[-1] < got[0] - 1e-2, got
    jtrace = [s for s in jax.tree_util.tree_leaves(js.opt_state, is_leaf=lambda x: hasattr(
        x, "trace")) if hasattr(s, "trace")][0].trace
    p0 = jax.tree_util.tree_leaves(params)
    for what, g, w in (("params", ts.params, js.params), ("bn state", ts.extra, js.extra),
                       ("trace", ts.opt_state["trace"], jtrace)):
        for i, ((path, a), b) in enumerate(zip(jax.tree_util.tree_leaves_with_path(g),
                                               jax.tree_util.tree_leaves(w))):
            b = np.asarray(b)
            scale = np.abs(b - p0[i] if what == "params" else b).max()
            np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-2 * scale,
                                       err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_tree_helpers_walk_stage_lists():
    """Stage lists convert as lists and their leaves reach the optimizer,
    in list order."""
    params, state = tr.init_resnet(tr.ResNetConfig.tiny(), torch.Generator().manual_seed(0),
                                   "cpu")
    back = compat.params_from_numpy(compat.params_to_numpy(params), "cpu")
    assert isinstance(back["stage0"], list) and len(back["stage0"]) == 1
    assert len(_leaves(params)) == len(jax.tree_util.tree_leaves(params)) == 50
    assert all(a is b for a, b in zip(_leaves(params), jax.tree_util.tree_leaves(params)))
    assert compat.tree_map(lambda t: t.shape[0], ([torch.zeros(2)], (torch.zeros(3),))) == \
        ([2], (3,))


def test_resnet50_param_count_matches_jax():
    """ResNet-50 is ~25.5M params (tests/test_models.py), the same count
    and shapes as the JAX package's init."""
    cfg = tr.ResNetConfig.resnet50()
    params, state = tr.init_resnet(cfg, torch.Generator().manual_seed(0), "cpu")
    n = sum(p.numel() for p in _leaves(params))
    assert 25e6 < n < 26e6, n
    shapes = jax.eval_shape(lambda k: jr.init_resnet(k, jr.ResNetConfig.resnet50()),
                            jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes[0]))
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), (params, state))
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    assert jax.tree_util.tree_structure(got, is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree_util.tree_structure(want, is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, tuple))


def test_configs_and_flops_match_jax():
    for variant in ("resnet50", "resnet18", "tiny"):
        wl = {"variant": variant, "num_classes": 7}
        got, want = wl_mod.resnet_config_from_workload(wl), jwl.resnet_config_from_workload(wl)
        for field in ("stage_sizes", "widths", "num_classes", "stem", "bn_in_activation_dtype",
                      "bn_fused_stats", "bn_stats_stop_gradient", "bn_ghost_stats",
                      "fused_1x1"):
            assert getattr(got, field) == getattr(want, field), (variant, field)
        assert got.flops_per_image(160) == want.flops_per_image(160)
        assert got.dtype == torch.bfloat16
    assert metrics.resnet_train_flops(8.2e9, 128) == jmetrics.resnet_train_flops(8.2e9, 128)


class _Ctx:
    num_processes = 1

    def __init__(self, workload):
        self.workload = workload


def test_resnet_workload_main(tmp_path, caplog):
    wl = {"variant": "tiny", "num_classes": 10, "steps": 2, "batch_size": 4,
          "image_size": 32, "lr": 0.05, "device": "cpu"}
    with caplog.at_level(logging.INFO, logger="tpujob.resnet"):
        wl_mod.main(_Ctx(wl))
    assert any("resnet done: loss=" in r.message for r in caplog.records)
    cfg = replace(wl_mod.resnet_config_from_workload(wl), dtype=torch.float32, fused_1x1=True)
    run = wl_mod.run_resnet(wl, device="cpu", cfg=cfg)
    assert run.cfg.fused_1x1 and len(run.losses) == 3 and run.timed == 2
    assert all(np.isfinite(run.losses)) and run.losses[-1] < run.losses[0]
    assert run.mfu() is None and run.flops == 3 * cfg.flops_per_image(32) * 4
    images, labels = run.batch
    assert images.shape == (4, 32, 32, 3) and images.dtype == torch.float32
    assert labels.dtype == torch.int64 and int(labels.max()) < 10
    with pytest.raises(NotImplementedError, match="orbax"):
        wl_mod.run_resnet({**wl, "checkpoint_dir": str(tmp_path),
                           "checkpoint_backend": "orbax"}, device="cpu")
    # streamed synthetic batches (ported: ROADMAP M5); idx trains through train_real
    streamed = wl_mod.run_resnet({**wl, "data": "stream"}, device="cpu")
    assert streamed.data["delivered"] == 3 and all(np.isfinite(streamed.losses))
    with pytest.raises(ValueError, match="train_real"):
        wl_mod.run_resnet({**wl, "data": "idx"}, device="cpu")
    # a two-process job's checkpointer (made before a gang is joined, it
    # stamps the job's world and refuses another world's step), and more
    # than one card a process still raises, before the gang is joined
    two = WorkloadCheckpointer({**wl, "checkpoint_dir": str(tmp_path / "gang")},
                               ctx=type("C", (_Ctx,), {"num_processes": 2})(wl))
    assert two.manager.world_size == 2 and not two.manager.allow_world_resize
    with pytest.raises(NotImplementedError, match="one process drives one card"):
        wl_mod.main(type("C", (_Ctx,), {"num_processes": 2, "chips": 2})(wl))


def test_resnet_real_data_path(tmp_path, caplog):
    """``data: idx`` through main: an 8x8 idx fixture upsampled to 32,
    augmented, 2 epochs of 4 steps with a checkpoint every 3 (and the
    final one), eval-mode accuracy reported to the context and gated by
    target_accuracy."""
    from tf_operator_tpu_torch.train import data as td
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 40).astype(np.uint8)
    images = (rng.random((40, 8, 8)) * 80 + labels[:, None, None] * 120).astype(np.uint8)
    for prefix, n in (("train", 32), ("t10k", 10)):
        td.write_idx(str(tmp_path / f"{prefix}-images-idx3-ubyte"), images[:n])
        td.write_idx(str(tmp_path / f"{prefix}-labels-idx1-ubyte.gz"), labels[:n])
    wl = {"variant": "tiny", "num_classes": 2, "data": "idx", "data_dir": str(tmp_path),
          "image_size": 32, "batch_size": 8, "epochs": 2, "lr": 0.05, "crop_padding": 2,
          "checkpoint_dir": str(tmp_path / "ckpt"), "checkpoint_every": 3, "device": "cpu"}
    reported = []
    ctx = type("C", (_Ctx,), {"process_id": 0,
                              "report_eval_metrics": lambda self, s, m: reported.append((s, m))})
    before = td.native_augment_batches
    with caplog.at_level(logging.INFO, logger="tpujob.resnet"):
        wl_mod.main(ctx(wl))
    msgs = [r.message for r in caplog.records]
    assert any("test accuracy" in m for m in msgs)
    assert [m.split()[1] for m in msgs if m.startswith("step ")] == ["0/8", "1/8", "2/8",
                                                                      "3/8", "4/8", "5/8",
                                                                      "6/8", "7/8"]
    assert td.native_augment_batches - before >= 8
    assert CheckpointManager(str(tmp_path / "ckpt"), readonly=True).all_steps() == [3, 6, 8]
    (step, metrics), = reported
    assert step == 8 and 0.0 <= metrics["accuracy"] <= 1.0
    run = wl_mod.train_real({**wl, "checkpoint_dir": None}, device="cpu")
    assert len(run.losses) == 8 and run.data["delivered"] == 8 and run.step_s is not None
    assert run.accuracy == metrics["accuracy"]  # the same seeds, the same run
    with pytest.raises(AssertionError, match="below target"):
        wl_mod.train_real({**wl, "checkpoint_dir": None, "target_accuracy": 1.01},
                          device="cpu")


def test_resnet_real_data_checkpoints_keep_world_and_depot(tmp_path):
    """``train_real`` saves through the job's checkpointer, as the
    fixed-data path does: the workload's ``checkpoint_keep`` leaves the
    newest step only, the manifest carries the context's world, and each
    committed step goes to the context's depot tagged with that world."""
    from tf_operator_tpu.rendezvous.statechannel import ShardDepot
    from tf_operator_tpu_torch.rendezvous.statechannel import DepotClient
    from tf_operator_tpu_torch.train import data as td
    from tf_operator_tpu_torch.train.checkpoint import checkpoint_world_size

    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, 20).astype(np.uint8)
    images = (rng.random((20, 8, 8)) * 80 + labels[:, None, None] * 120).astype(np.uint8)
    for prefix, n in (("train", 16), ("t10k", 4)):
        td.write_idx(str(tmp_path / f"{prefix}-images-idx3-ubyte"), images[:n])
        td.write_idx(str(tmp_path / f"{prefix}-labels-idx1-ubyte.gz"), labels[:n])
    ckpt = tmp_path / "ckpt"
    wl = {"variant": "tiny", "num_classes": 2, "data": "idx", "data_dir": str(tmp_path),
          "image_size": 32, "batch_size": 8, "epochs": 1, "lr": 0.05, "crop_padding": 2,
          "checkpoint_dir": str(ckpt), "checkpoint_every": 1, "checkpoint_keep": 1,
          "checkpoint_async": False, "device": "cpu"}
    depot = ShardDepot()
    try:
        ctx = type("C", (_Ctx,), {"num_processes": 1, "process_id": 0, "namespace": "ns",
                                  "job_name": "real", "peer_depot": depot.url})(wl)
        wl_mod.train_real(wl, device="cpu", ctx=ctx)
        assert sorted(os.listdir(ckpt)) == ["step_2"]
        assert checkpoint_world_size(str(ckpt), 2) == 1
        assert DepotClient().step_worlds(depot.url, "ns", "real") == {1: 1, 2: 1}
    finally:
        depot.stop()
