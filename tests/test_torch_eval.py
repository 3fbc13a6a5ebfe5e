"""The port's Evaluator against the JAX package's, on the CPU at tiny sizes.

- A tiny LM trained and checkpointed by the JAX package (npy backend) is
  scored by both ``eval.main``s over one memmap holdout: every saved step,
  oldest first, each CE within 1e-5 in f32; the same for a bidirectional
  (BERT-class, masked-LM) tiny model, scored with JAX's fixed mask (the
  port's ``mlm_mask`` pointed at ``bernoulli(PRNGKey(0), ...)`` for the
  test: the port's own draw is numpy's, a declared difference).
- A tiny ResNet trained and checkpointed by the JAX package on an 8x8 idx
  fixture upsampled to 32 is scored by both: equal accuracy.
- The refusals raise as JAX's do; a step that vanishes mid-scan is
  skipped; the evaluator started on an empty directory scores what a
  writer saves meanwhile.

Both packages run these models in f32 here (the tiny presets' activation
dtype is set to f32 in each package for the test), so the comparison sees
the scorers, not bf16 rounding. The JAX evaluator opens its directory
with the default backend, which is orbax where orbax imports; the test
points that default at npy, the backend both packages share.
"""

import functools
import json
import logging
import threading
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import resnet as jr  # noqa: E402
from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu.parallel import build_mesh  # noqa: E402
from tf_operator_tpu.rendezvous.context import JobContext  # noqa: E402
from tf_operator_tpu.train import checkpoint as jck  # noqa: E402
from tf_operator_tpu.train import data as jd  # noqa: E402
from tf_operator_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from tf_operator_tpu.workloads import eval as jeval  # noqa: E402
from tf_operator_tpu.workloads import resnet as jres  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402
from tf_operator_tpu_torch.train import checkpoint as ck  # noqa: E402
from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from tf_operator_tpu_torch.workloads import eval as teval  # noqa: E402
from tf_operator_tpu_torch.workloads import resnet as tres  # noqa: E402

torch.set_num_threads(1)
MESH = build_mesh({"dp": 1}, devices=jax.devices()[:1])
LM_WL = {"preset": "tiny", "eval_batch_size": 4, "eval_seq_len": 16, "eval_batches": 2,
         "poll_interval_s": 0.05, "max_wait_s": 30, "device": "cpu"}


@pytest.fixture
def f32(monkeypatch):
    """Both packages' tiny LM and ResNet in f32; the JAX default backend npy."""
    monkeypatch.setitem(jt.PRESETS, "tiny", replace(jt.PRESETS["tiny"], dtype=jnp.float32))
    monkeypatch.setitem(tt.PRESETS, "tiny", replace(tt.PRESETS["tiny"], dtype=torch.float32))
    for mod, dtype in ((jres, jnp.float32), (tres, torch.float32)):
        orig = mod.resnet_config_from_workload
        monkeypatch.setattr(mod, "resnet_config_from_workload",
                            lambda wl, orig=orig, dtype=dtype: replace(orig(wl), dtype=dtype))
    monkeypatch.setattr(jck, "CheckpointManager",
                        functools.partial(jck.CheckpointManager, backend="npy"))


def _scores(module, ctx, report):
    module.main(ctx)
    return json.loads(report.read_text())


def _jax_lm_checkpoints(tmp_path, cfg):
    """Train the JAX package's ``cfg`` on a memmap corpus, checkpointed at
    steps 2 and 4; returns (tmp_path, the corpus)."""
    trainer = JaxTrainer(MESH, loss_fn=lambda p, tok, extra: jt.lm_loss(p, tok, cfg),
                         init_fn=lambda k: jt.init_transformer(k, cfg),
                         config=JaxTrainerConfig(optimizer="adamw", learning_rate=1e-3))
    state = trainer.init(jax.random.PRNGKey(0))
    corpus = str(tmp_path / "corpus.bin")
    jd.write_token_corpus(corpus, np.random.default_rng(0).integers(0, 256, 40 * 32))
    ds = jd.TokenMemmapDataset(corpus, 4, 32, holdout=8, process_shard=False)
    mgr = jck.CheckpointManager(str(tmp_path / "ckpt"))
    for s, batch in zip(range(1, 5), ds):
        state, _ = trainer.step(state, jnp.asarray(batch["tokens"]))
        if s in (2, 4):
            mgr.save(s, state, wait=True)
    return tmp_path, corpus


@pytest.fixture
def lm_run(tmp_path, f32):
    """A JAX-trained tiny LM checkpointed at steps 2 and 4, and a corpus."""
    return _jax_lm_checkpoints(tmp_path, jt.preset("tiny"))


def test_lm_scores_match_jax_over_memmap_holdout(lm_run, caplog):
    tmp_path, corpus = lm_run
    wl = {**LM_WL, "checkpoint_dir": str(tmp_path / "ckpt"), "data": "memmap",
          "corpus": corpus, "seq_len": 32, "holdout_windows": 8, "train_steps": 4}
    want = _scores(jeval, JobContext(workload={**wl, "eval_report": str(tmp_path / "j.json")}),
                   tmp_path / "j.json")
    with caplog.at_level(logging.INFO, logger="tpujob.eval"):
        got = _scores(teval, SimpleNamespace(workload={**wl, "eval_report": str(tmp_path / "p.json")}),
                      tmp_path / "p.json")
    assert list(got) == list(want) == ["2", "4"]
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want], atol=1e-5, rtol=0)
    assert np.isfinite(list(got.values())).all() and got["4"] < got["2"]
    msgs = [r.getMessage() for r in caplog.records]
    assert [m.split()[2] for m in msgs if m.startswith("eval: checkpoint")] == \
        ["step=2", "step=4"]
    assert any(m.startswith("eval done: 2 checkpoints scored") for m in msgs)


def test_mlm_scores_match_jax_with_the_fixed_mask(tmp_path, f32, monkeypatch):
    tmp_path, corpus = _jax_lm_checkpoints(tmp_path, jt.preset("tiny", causal=False))
    monkeypatch.setattr(tt, "mlm_mask", lambda shape, rate, device: torch.from_numpy(
        np.array(jax.random.bernoulli(jax.random.PRNGKey(0), rate, shape))).to(device))
    wl = {**LM_WL, "causal": False, "checkpoint_dir": str(tmp_path / "ckpt"),
          "data": "memmap", "corpus": corpus, "seq_len": 32, "holdout_windows": 8,
          "train_steps": 4}
    want = _scores(jeval, JobContext(workload={**wl, "eval_report": str(tmp_path / "j.json")}),
                   tmp_path / "j.json")
    got = _scores(teval, SimpleNamespace(workload={**wl, "eval_report": str(tmp_path / "p.json")}),
                  tmp_path / "p.json")
    assert list(got) == list(want) == ["2", "4"]
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want], atol=1e-5, rtol=0)
    assert np.isfinite(list(got.values())).all()


def _port_checkpoints(ckpt_dir, steps=(2, 4), pause=0.0):
    """Train the port's tiny LM, saving at ``steps`` (``pause`` s after each)."""
    cfg = tt.preset("tiny")
    trainer = Trainer(loss_fn=lambda p, tok, e: tt.lm_loss(p, tok, cfg),
                      init_fn=lambda g: tt.init_transformer(cfg, g, "cpu"),
                      config=TrainerConfig(learning_rate=1e-3), device="cpu")
    state = trainer.init(0)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (4, 16)))
    mgr = ck.CheckpointManager(str(ckpt_dir))
    for s in range(1, max(steps) + 1):
        state, _ = trainer.step(state, tokens)
        if s in steps:
            mgr.save(s, state, wait=True)
            time.sleep(pause)


def test_lm_one_shot_scores_latest_and_reports(tmp_path):
    _port_checkpoints(tmp_path / "ckpt")
    reported = []
    ctx = SimpleNamespace(workload={**LM_WL, "checkpoint_dir": str(tmp_path / "ckpt"),
                                    "eval_report": str(tmp_path / "r.json")},
                          report_eval_metrics=lambda step, m: reported.append((step, m)))
    scored = _scores(teval, ctx, tmp_path / "r.json")
    assert list(scored) == ["4"] and reported == [(4, {"loss": scored["4"]})]
    # the synthetic batches: RandomState(10_000 + i), eval_seq_len 16
    batches = teval.lm_eval_batches(ctx.workload, tt.preset("tiny"), torch.device("cpu"))
    assert [b.shape for b in batches] == [(4, 16)] * 2
    assert batches[1].numpy().tolist() == \
        np.random.RandomState(10_001).randint(0, 256, (4, 16)).tolist()


def test_vanished_step_is_skipped(tmp_path, monkeypatch):
    _port_checkpoints(tmp_path / "ckpt")
    real = ck.CheckpointManager.restore_subtrees

    def flaky(self, templates, step=None, device=None):
        if step == 2:
            raise FileNotFoundError("pruned by keep-N")
        return real(self, templates, step=step, device=device)

    monkeypatch.setattr(ck.CheckpointManager, "restore_subtrees", flaky)
    wl = {**LM_WL, "checkpoint_dir": str(tmp_path / "ckpt"), "train_steps": 4,
          "eval_report": str(tmp_path / "r.json")}
    assert list(_scores(teval, SimpleNamespace(workload=wl), tmp_path / "r.json")) == ["4"]


def test_resnet_accuracy_matches_jax(tmp_path, f32):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 96).astype(np.uint8)
    images = (rng.random((96, 8, 8)) * 80 + labels[:, None, None] * 120).astype(np.uint8)
    data = tmp_path / "digits"
    data.mkdir()
    for name, arr in (("train-images-idx3-ubyte", images), ("train-labels-idx1-ubyte", labels),
                      ("t10k-images-idx3-ubyte", images[:40]),
                      ("t10k-labels-idx1-ubyte", labels[:40])):
        jd.write_idx(str(data / name), arr)
    wl = {"model": "resnet", "variant": "tiny", "num_classes": 2, "image_size": 32,
          "data_dir": str(data), "checkpoint_dir": str(tmp_path / "ckpt"), "train_steps": 30,
          "eval_batch_size": 16, "poll_interval_s": 0.05, "max_wait_s": 30, "device": "cpu"}
    cfg = jres.resnet_config_from_workload(wl)

    def loss_fn(params, batch, st):
        logits, new = jr.resnet_forward(params, st, batch[0], cfg, train=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, batch[1][:, None], axis=-1)), new

    trainer = JaxTrainer(MESH, loss_fn=loss_fn, init_fn=lambda k: jr.init_resnet(k, cfg),
                         config=JaxTrainerConfig(optimizer="sgd", learning_rate=0.1,
                                                 grad_clip=None))
    x = jnp.asarray(jd.prepare_classification_images(images[:32].astype(np.float32) / 255, 32))
    y = jnp.asarray(labels[:32].astype(np.int32))
    state = trainer.init(jax.random.PRNGKey(0))
    mgr = jck.CheckpointManager(str(tmp_path / "ckpt"))
    for s in range(1, 31):
        state, _ = trainer.step(state, (x, y))
        if s in (2, 30):
            mgr.save(s, state, wait=True)
    want = _scores(jeval, JobContext(workload={**wl, "eval_report": str(tmp_path / "j.json")}),
                   tmp_path / "j.json")
    got = _scores(teval, SimpleNamespace(workload={**wl, "eval_report": str(tmp_path / "p.json")}),
                  tmp_path / "p.json")
    assert got == want and list(got) == ["2", "30"]
    assert all(0.0 <= v <= 1.0 for v in got.values())
    # the tail of a split that eval_b does not divide is masked, not scored
    restored = ck.CheckpointManager(str(tmp_path / "ckpt"), readonly=True).restore_subtrees(
        teval.resnet_scorer(wl, torch.device("cpu"))[0], step=30, device="cpu")
    tcfg = tres.resnet_config_from_workload(wl)
    imgs, labs = tres.test_split(str(data), 32)
    score = tres.make_test_accuracy(tcfg)
    assert score(restored["params"], restored["extra"], imgs, labs, 16) == \
        score(restored["params"], restored["extra"], imgs, labs, 40) == \
        score(restored["params"], restored["extra"], imgs, labs, 7) == got["30"]


def _refusal_cases(tmp_path):
    corpus = str(tmp_path / "corpus.bin")
    jd.write_token_corpus(corpus, np.zeros(64 * 32, np.uint16))
    ck.CheckpointManager(str(tmp_path / "ckpt"))  # an empty directory
    base = {**LM_WL, "checkpoint_dir": str(tmp_path / "ckpt")}
    memmap = {**base, "data": "memmap", "corpus": corpus, "seq_len": 32, "eval_seq_len": 32}
    return {
        "no_checkpoint_dir": (ValueError, "checkpoint_dir", {"preset": "tiny"}),
        "memmap_without_holdout": (ValueError, "holdout_windows", memmap),
        "eval_seq_longer_than_trainer": (ValueError, "eval_seq_len",
                                         {**memmap, "holdout_windows": 8, "eval_seq_len": 64}),
        "holdout_too_small": (ValueError, "eval_batches",
                              {**memmap, "holdout_windows": 1, "eval_batches": 3}),
        "resnet_without_data_dir": (ValueError, "data_dir", {**base, "model": "resnet"}),
        "unknown_model": (ValueError, "unknown eval model", {**base, "model": "bert"}),
        "timeout": (TimeoutError, "no new checkpoint", {**base, "max_wait_s": 0.2}),
    }


@pytest.mark.parametrize("case", ["no_checkpoint_dir", "memmap_without_holdout",
                                  "eval_seq_longer_than_trainer", "holdout_too_small",
                                  "resnet_without_data_dir", "unknown_model", "timeout"])
def test_refusals_raise_as_jax(tmp_path, case):
    exc, match, wl = _refusal_cases(tmp_path)[case]
    with pytest.raises(exc, match=match):
        jeval.main(JobContext(workload=dict(wl)))
    with pytest.raises(exc, match=match):
        teval.main(SimpleNamespace(workload=dict(wl)))


def test_concurrent_with_live_writer(tmp_path):
    """Started on an empty directory, the evaluator scores the steps a
    writer saves while it polls, and ends at train_steps."""
    report = tmp_path / "report.json"
    wl = {**LM_WL, "checkpoint_dir": str(tmp_path / "ckpt"), "train_steps": 4,
          "eval_batches": 1, "max_wait_s": 60, "eval_report": str(report)}
    (tmp_path / "ckpt").mkdir()
    err = []

    def run():
        try:
            teval.main(SimpleNamespace(workload=wl))
        except BaseException as e:  # surfaced after join
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.3)  # the evaluator is up, polling the empty directory
    _port_checkpoints(tmp_path / "ckpt", pause=0.2)
    t.join(timeout=60)
    assert not t.is_alive() and not err, err
    scored = json.loads(report.read_text())
    assert "4" in scored and all(np.isfinite(v) for v in scored.values())
