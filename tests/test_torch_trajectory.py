"""The port's training trajectory against the JAX package's, from one
numpy-seeded init and batch, in f32.

- ``test_tiny_trajectory_matches_jax``: 1 + 3 AdamW steps of ``tiny`` on
  the CPU, the port (flash and save_mid, through the kernels' plain
  versions here) against the JAX Trainer (dense attention): every loss
  within 1e-5.
- ``test_generate_gqa2048_artifact`` (``slow``, run by hand): the same at
  gqa-2048 width and depth, batch 1, t 2048, JAX on the CPU (dense
  attention: Pallas in interpret mode at t 2048 would take hours), twice:
  from the init and from the init with every weight nudged by 2^-17 of
  itself, in a random direction. It writes
  ``artifacts/torch_vs_jax_gqa2048.json``: the losses, the seeds, the cuts
  and the limit the card's run is held to (``chip_smoke.py``, phase
  ``jax_trajectory``). Run it with ``python -m pytest
  tests/test_torch_trajectory.py -m slow -k generate``; it takes ~20 GB.
- ``test_artifact_schema_and_seeds``: the artifact has its keys, and its
  seeds reproduce its first batch and the head of its init's stream.
- ``test_generate_bert_base_artifact`` (``slow``, run by hand, ~3 GB):
  the same for bert-base's masked LM at b 1, t 512 (JAX: dense attention,
  full remat, its fixed ``PRNGKey(0)`` mask, recorded by its positions;
  the port on the card: flash non-causal, full remat, that mask), into
  ``artifacts/torch_vs_jax_bert_base.json``; ``-k generate_bert``.
- ``test_bert_artifact_schema_and_mask``: its keys and seeds, and its mask
  is JAX's ``bernoulli(PRNGKey(0), 0.15, (1, 512))``.
- ``test_loader_trajectory_matches_jax``: ``run_lm`` with ``data: stream``
  and ``memmap`` (f32, from the numpy init) against the JAX Trainer over
  the JAX package's loader: 1 + 3 losses within 1e-5.
- ``test_memmap_job_resumed_after_a_fault_ends_bitwise_equal``: a memmap
  job that dies and resumes ends bitwise equal to an uninterrupted one.
"""

import json
import math
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu.parallel import build_mesh  # noqa: E402
from tf_operator_tpu.train import data as jd  # noqa: E402
from tf_operator_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from tf_operator_tpu.train.trainer import TrainState as JaxTrainState  # noqa: E402
from tf_operator_tpu_torch.models.transformer import init_transformer_numpy  # noqa: E402
from tf_operator_tpu_torch.train import trajectory as tj  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
STEPS = 4  # the initial loss and the loss after each of 3 updates
INIT_SEED, BATCH_SEED = 0, 1
# The card's limit: the port runs the same math as JAX in other orders
# (cuBLAS, ~2^-24 relative per sum) and its f32 flash kernels multiply
# split bf16 operands, ~2^-17 relative per product (chip_smoke.py's flash
# notes). The generator measures how far a 2^-17 relative nudge of every
# init weight, each in a random direction, moves the JAX trajectory; the
# port rounds at that size in every attention op of every step, not only
# once in the init, so the limit is LIMIT_X times that spread, and never
# below train_parity's f32 loss limit (LIMIT_FLOOR).
NUDGE_REL, LIMIT_X, LIMIT_FLOOR = 2.0 ** -17, 10.0, 1e-4


def jax_trajectory(name, params, tokens, steps=STEPS):
    """The loss before each of ``steps`` updates of the JAX Trainer (f32,
    dense attention, full remat) from the numpy ``params``."""
    cfg = jt.preset(name, dtype=jnp.float32, attn_impl="dense", remat=True)
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = JaxTrainer(mesh, loss_fn=lambda p, tok, extra: jt.lm_loss(p, tok, cfg),
                         init_fn=lambda k: jt.init_transformer(k, cfg),
                         config=JaxTrainerConfig(optimizer="adamw", learning_rate=tj.LR))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxTrainState(p, jax.jit(trainer.tx.init)(p), jnp.zeros((), jnp.int32), None)
    batch = jnp.asarray(tokens)
    losses = []
    for _ in range(steps):
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def test_tiny_trajectory_matches_jax():
    cfg = tj.trajectory_config("tiny")
    params = init_transformer_numpy(cfg, INIT_SEED)
    tokens = tj.trajectory_tokens(cfg.vocab, 2, 64, BATCH_SEED)
    want = jax_trajectory("tiny", params, tokens)
    got = tj.port_trajectory(cfg, params, tokens, STEPS, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0]


def _stream_head(seed, n=8):
    """The first ``n`` values of the init's stream: the head of ``embed``."""
    return (np.random.default_rng(seed).standard_normal(n, dtype=np.float32)
            * np.float32(0.02)).tolist()


def _init_sums(params):
    sums = {"embed": float(np.sum(params["embed"], dtype=np.float64))}
    sums.update({f"layers.{k}": float(np.sum(v, dtype=np.float64))
                 for k, v in params["layers"].items()})
    return sums


def _generate(name, batch, seq, port, cuts, path, **extra):
    """JAX's losses from the numpy init and batch, and from the init nudged
    by NUDGE_REL (the spread sets the card's limit), written to ``path``
    with the seeds and cuts; ``port`` names the port's side on the card."""
    cfg = tj.trajectory_config(name, **port)
    t0 = time.time()
    params = init_transformer_numpy(cfg, INIT_SEED)
    tokens = tj.trajectory_tokens(cfg.vocab, batch, seq, BATCH_SEED)
    init_sums = _init_sums(params)
    assert np.allclose(params["embed"].reshape(-1)[:8], _stream_head(INIT_SEED))
    losses = jax_trajectory(name, params, tokens)
    signs = np.random.default_rng(INIT_SEED + 1)

    def nudge(a):
        s = signs.integers(0, 2, a.shape, dtype=np.int8).astype(np.float32) * 2 - 1
        return a * (1 + np.float32(NUDGE_REL) * s)

    nudged = jax.tree_util.tree_map(nudge, params)
    del params
    nudged_losses = jax_trajectory(name, nudged, tokens)
    spread = max(abs(a - b) for a, b in zip(losses, nudged_losses))
    artifact = {
        "what": f"JAX package losses of {name} trained in f32 on the CPU from a "
                "numpy-seeded init and batch; the port's card run is held to them",
        "generated_by": f"tests/test_torch_trajectory.py::{extra.pop('generated_by')}",
        "preset": name, "n_params": cfg.n_params(), "dtype": "float32",
        "jax": {"attn_impl": "dense", "remat": "full"},
        "port": {"attn_impl": cfg.attn_impl, "remat": cfg.remat, "tf32": False},
        "optimizer": "chain(clip_by_global_norm(1.0), adamw(lr, b1 0.9, b2 0.95, wd 0))",
        "lr": tj.LR, "batch_size": batch, "seq_len": seq, "steps": STEPS, "cuts": cuts,
        "init_seed": INIT_SEED, "batch_seed": BATCH_SEED,
        "init": "tf_operator_tpu_torch.models.transformer.init_transformer_numpy(cfg, "
                "init_seed): np.random.default_rng(init_seed) f32 normals",
        "batch": "np.random.RandomState(batch_seed).randint(0, vocab, (batch_size, seq_len))",
        "init_stream_head": _stream_head(INIT_SEED), "init_sums": init_sums,
        "first_batch_head": tokens[0, :16].tolist(),
        "first_batch_sum": int(tokens.sum(dtype=np.int64)),
        **extra,
        "jax_losses": losses, "jax_losses_init_nudged": nudged_losses,
        "nudge": f"every init weight times 1 + {NUDGE_REL} s, s = +-1 from "
                 f"np.random.default_rng({INIT_SEED + 1})",
        "nudge_spread": spread,
        "limit_rule": f"max({LIMIT_FLOOR}, {LIMIT_X} x nudge_spread)",
        "card_limit": max(LIMIT_FLOOR, LIMIT_X * spread),
        "generate_s": time.time() - t0,
    }
    (ROOT / path).write_text(json.dumps(artifact, indent=1) + "\n")
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


@pytest.mark.slow
def test_generate_gqa2048_artifact():
    _generate("gqa-2048", 1, 2048, {},
              {"batch_size": "1 of the job's 6", "steps": "1 + 3 updates of the job's 1000",
               "data": "one fixed batch"},
              tj.ARTIFACT, generated_by="test_generate_gqa2048_artifact")


BERT_MASK_RATE = 0.15


def _jax_fixed_mask(shape):
    """JAX's masked-LM mask when its loss is given no key."""
    return np.asarray(jax.random.bernoulli(jax.random.PRNGKey(0), BERT_MASK_RATE, shape))


@pytest.mark.slow
def test_generate_bert_base_artifact():
    batch, seq = 1, 512
    _generate("bert-base", batch, seq, {"remat": "full"},
              {"batch_size": "1 of the H100 job's 32 (examples/bert_base_h100.json)",
               "steps": "1 + 3 updates of the job's 100", "data": "one fixed batch"},
              tj.BERT_ARTIFACT, generated_by="test_generate_bert_base_artifact",
              mask_rate=BERT_MASK_RATE,
              mask="jax.random.bernoulli(PRNGKey(0), mask_rate, (batch_size, seq_len)), "
                   "what JAX's lm_loss draws without a key, by its flat positions",
              mask_positions=np.flatnonzero(_jax_fixed_mask((batch, seq))).tolist())


def test_artifact_schema_and_seeds():
    art = json.loads((ROOT / tj.ARTIFACT).read_text())
    for key in ("preset", "batch_size", "seq_len", "steps", "lr", "init_seed", "batch_seed",
                "init_stream_head", "init_sums", "first_batch_head", "first_batch_sum",
                "jax_losses", "card_limit", "cuts"):
        assert key in art, key
    cfg = tj.trajectory_config(art["preset"])
    assert art["n_params"] == cfg.n_params() and art["lr"] == tj.LR
    assert len(art["jax_losses"]) == art["steps"] == STEPS
    assert all(math.isfinite(x) for x in art["jax_losses"])
    assert art["card_limit"] >= LIMIT_FLOOR
    tokens = tj.trajectory_tokens(cfg.vocab, art["batch_size"], art["seq_len"],
                                  art["batch_seed"])
    assert tokens[0, :16].tolist() == art["first_batch_head"]
    assert int(tokens.sum(dtype=np.int64)) == art["first_batch_sum"]
    assert _stream_head(art["init_seed"]) == art["init_stream_head"]
    head = init_transformer_numpy(tj.trajectory_config("tiny"), art["init_seed"])["embed"]
    assert head.reshape(-1)[:8].tolist() == art["init_stream_head"]


def test_bert_artifact_schema_and_mask():
    art = json.loads((ROOT / tj.BERT_ARTIFACT).read_text())
    cfg = tj.trajectory_config(art["preset"], remat=art["port"]["remat"])
    assert art["preset"] == "bert-base" and not cfg.causal and art["port"]["remat"] == "full"
    assert art["n_params"] == cfg.n_params() and art["lr"] == tj.LR
    assert len(art["jax_losses"]) == art["steps"] == STEPS
    assert all(math.isfinite(x) for x in art["jax_losses"]) and art["card_limit"] >= LIMIT_FLOOR
    shape = (art["batch_size"], art["seq_len"])
    mask = tj.trajectory_mask(shape, art["mask_positions"])
    np.testing.assert_array_equal(mask, _jax_fixed_mask(shape))
    assert art["mask_rate"] == BERT_MASK_RATE and 0.1 < mask.mean() < 0.2
    tokens = tj.trajectory_tokens(cfg.vocab, *shape, art["batch_seed"])
    assert tokens[0, :16].tolist() == art["first_batch_head"]
    assert int(tokens.sum(dtype=np.int64)) == art["first_batch_sum"]
    assert _stream_head(art["init_seed"]) == art["init_stream_head"]


# ---- streamed and memmapped data through the workload ------------------------


def _loader_wl(tmp_path, data):
    wl = {"preset": "tiny", "steps": 3, "batch_size": 2, "seq_len": 32, "attn": "flash",
          "remat": "save_mid", "lr": tj.LR, "data": data, "device": "cpu",
          "checkpoint_async": False}
    if data == "memmap":
        corpus = str(tmp_path / "corpus.bin")
        jd.write_token_corpus(corpus, np.random.default_rng(3).integers(0, 256, 32 * 40))
        wl.update(corpus=corpus, holdout_windows=4)
    return wl


@pytest.mark.parametrize("data", ["stream", "memmap"])
def test_loader_trajectory_matches_jax(tmp_path, monkeypatch, data):
    """``run_lm`` with ``data: stream`` or ``memmap`` (the port's loader, f32)
    from the numpy init, which it resumes from a step-0 checkpoint, against
    the JAX Trainer over the JAX package's own loader: 1 + 3 losses within
    1e-5."""
    from tf_operator_tpu_torch.compat import params_from_numpy
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig
    from tf_operator_tpu_torch.workloads.lm import run_lm

    monkeypatch.setitem(tt.PRESETS, "tiny", replace(tt.PRESETS["tiny"], dtype=torch.float32))
    wl = _loader_wl(tmp_path, data)
    cfg = tj.trajectory_config("tiny")
    params = init_transformer_numpy(cfg, INIT_SEED)
    port = Trainer(loss_fn=None, init_fn=None,
                   config=TrainerConfig(optimizer="adamw", learning_rate=tj.LR), device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).save(
        0, port.state_from_params(params_from_numpy(params, "cpu")), wait=True)
    run = run_lm({**wl, "checkpoint_dir": str(tmp_path / "ckpt")}, device="cpu")

    jcfg = jt.preset("tiny", dtype=jnp.float32, attn_impl="dense", remat=True)
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = JaxTrainer(mesh, loss_fn=lambda p, tok, extra: jt.lm_loss(p, tok, jcfg),
                         init_fn=lambda k: jt.init_transformer(k, jcfg),
                         config=JaxTrainerConfig(optimizer="adamw", learning_rate=tj.LR))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxTrainState(p, jax.jit(trainer.tx.init)(p), jnp.zeros((), jnp.int32), None)
    if data == "memmap":
        loader = jd.DeviceLoader(jd.TokenMemmapDataset(wl["corpus"], 2, 32, holdout=4),
                                 trainer.batch_sharding)
    else:
        loader = jd.local_loader(jd.SyntheticTokens, 2, trainer.batch_sharding, seq_len=32,
                                 vocab=jcfg.vocab)
    want = []
    with loader:
        for _, batch in zip(range(4), loader):
            state, m = trainer.step(state, batch["tokens"])
            want.append(float(m["loss"]))
    assert run.data["delivered"] == 4
    np.testing.assert_allclose(run.losses, want, atol=1e-5, rtol=0)


def test_memmap_job_resumed_after_a_fault_ends_bitwise_equal(tmp_path):
    """A memmap job that dies at step 3 (its last checkpoint at step 2) and
    resumes skips the two batches it consumed and ends with the params of
    an uninterrupted run, bit for bit."""
    from tf_operator_tpu_torch.workloads.lm import run_lm

    wl = {**_loader_wl(tmp_path, "memmap"), "steps": 5, "checkpoint_every": 2}

    def die_at_3(step):
        if step == 3:
            raise RuntimeError("injected fault at step 3")

    faulty = {**wl, "checkpoint_dir": str(tmp_path / "faulty")}
    with pytest.raises(RuntimeError, match="injected fault"):
        run_lm(faulty, device="cpu", on_step=die_at_3)
    resumed = run_lm(faulty, device="cpu")
    whole = run_lm({**wl, "checkpoint_dir": str(tmp_path / "whole")}, device="cpu")
    assert resumed.data["delivered"] == 4 and whole.data["delivered"] == 6
    assert resumed.losses[-3:] == whole.losses[-3:]
    for k, v in whole.state.params["layers"].items():
        assert torch.equal(resumed.state.params["layers"][k], v), k
    assert torch.equal(resumed.state.params["embed"], whole.state.params["embed"])
