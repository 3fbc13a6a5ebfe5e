"""The port's remat policies against the JAX package's, on the CPU at the
``tiny`` preset in f32, inputs from a numpy seed.

- Every policy (none, full, ``dots``, every ``save:`` alias and a
  hand-written ``save:`` set) gives JAX's loss and every param's grad
  within 1e-5, under flash attention (whose inputs carry the flash_q/k/v
  names) and, for a few, dense attention (where those names tag nothing);
  the losses are bitwise equal across policies: only what is stored
  changes.
- What each policy recomputes in the backward, counted on the port: the
  projections (a 2-D product whose second operand is the weight itself,
  seen by a TorchDispatchMode over the backward) and the flash forwards.
  The counts are held to ``JAX_RECOMPUTED``, what XLA's compiled backward
  of the JAX model replays under the same policy; a parametrised test
  recounts that from JAX's compiled HLO (its 2-D dots without batch
  dimensions, against remat none) for three policies whose replays differ
  most (each compile costs ~1.5 s).
"""

import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu_torch import compat  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402
from tf_operator_tpu_torch.ops import flash_attention as fa  # noqa: E402

torch.set_num_threads(1)

B, T = 2, 16
ATOL = 1e-5
POLICIES = ["none", "full", "dots", *tt._REMAT_SAVE_SETS, "save:flash_k,resid_mid,mlp_up",
            "save:mlp_gate"]
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# Per layer, under flash attention: the projections the backward runs
# again. The down projection never runs again (its output is dead in the
# backward), nor does a projection whose output is saved; a saved
# resid_mid spares wo unless the attention half needs it, and a saved
# mlp_gate or mlp_up spares its product.
JAX_RECOMPUTED = {
    "none": (),
    "full": ("wq", "wk", "wv", "wo", "w_gate", "w_up"),
    "dots": (),
    "save_mid": ("wq", "wk", "wv", "w_gate", "w_up"),
    "save_qkv": ("wo", "w_gate", "w_up"),
    "save_qkv_mid": ("w_gate", "w_up"),
    "save_qkv_mid_up": ("w_gate",),
    "save_qkv_mid_mlp": (),
    "save_mlp_mid": ("wq", "wk", "wv"),
    "save:flash_k,resid_mid,mlp_up": ("wq", "wv", "w_gate"),
    # the port keeps resid_mid beside an MLP product (kept_names), so wo
    # does not run again where XLA's backward replays it
    "save:mlp_gate": ("wq", "wk", "wv", "w_up"),
}


@pytest.fixture(scope="module")
def setup():
    """tiny in f32: params (numpy, the JAX package's tree), tokens, and JAX's loss and grads
    under each attention (JAX's policies change no value: its own
    tests/test_remat_policies.py)."""
    params = tt.init_transformer_numpy(tt.preset("tiny"), 0)
    tokens = np.random.RandomState(6).randint(0, 256, (B, T)).astype(np.int32)
    want = {}
    for attn in ("flash", "dense"):
        jcfg = jt.preset("tiny", dtype=jnp.float32, attn_impl=attn)
        want[attn] = jax.jit(jax.value_and_grad(lambda p: jt.lm_loss(p, tokens, jcfg)))(params)
    return params, tokens, want


def _loss_and_grads(params, tokens, cfg):
    p = compat.params_from_numpy(params, "cpu")
    for x in jax.tree_util.tree_leaves(p):
        x.requires_grad_(True)
    loss = tt.lm_loss(p, torch.from_numpy(tokens).long(), cfg)
    loss.backward()
    return loss.detach(), jax.tree_util.tree_map(lambda x: x.grad.numpy(), p)


@pytest.mark.parametrize("attn,remat", [("flash", r) for r in POLICIES] + [
    ("dense", "dots"), ("dense", "save_qkv"), ("dense", "save_qkv_mid_mlp")])
def test_policy_loss_and_grads_match_jax(setup, attn, remat):
    params, tokens, want = setup
    want_loss, want_grads = want[attn]
    loss, grads = _loss_and_grads(
        params, tokens, tt.preset("tiny", dtype=torch.float32, attn_impl=attn, remat=remat))
    assert float(loss) == pytest.approx(float(want_loss), abs=ATOL)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(grads),
                            jax.tree_util.tree_leaves(want_grads)):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0, err_msg=str(path))
    # the forward is the same ops under every policy: the loss, bit for bit
    none_loss, _ = _loss_and_grads(
        params, tokens, tt.preset("tiny", dtype=torch.float32, attn_impl=attn, remat="none"))
    assert float(loss) == float(none_loss)


class _ProjectionCount(TorchDispatchMode):
    """Counts 2-D products whose second operand is one of ``weights`` as
    stored (same storage, shape and strides: the forward's h @ w; the
    backward's products read w transposed)."""

    def __init__(self, weights):
        super().__init__()
        self.weights, self.counts = weights, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            b = args[1]
            for name, w in self.weights.items():
                if (b.data_ptr(), b.shape, b.stride()) == (w.data_ptr(), w.shape, w.stride()):
                    self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", POLICIES)
def test_backward_recomputes_what_jax_recomputes(monkeypatch, remat):
    """One step of tiny (2 layers, flash): the backward runs each layer's
    JAX_RECOMPUTED projections once more and, under every policy but none,
    the flash forward once more (K1's launches on the card)."""
    calls = {"fwd": 0}
    real_fwd = fa.flash_fwd_reference

    def fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    monkeypatch.setattr(fa, "flash_fwd_reference", fwd)
    cfg = tt.preset("tiny", dtype=torch.float32, attn_impl="flash", remat=remat)
    p = tt.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    for x in jax.tree_util.tree_leaves(p):
        x.requires_grad_(True)
    weights = {(i, k): p["layers"][k][i] for k in PROJECTIONS for i in range(cfg.n_layers)}
    loss = tt.lm_loss(p, torch.randint(0, cfg.vocab, (2, 8)), cfg)
    assert calls["fwd"] == cfg.n_layers
    with _ProjectionCount(weights) as mode:
        loss.backward()
    want = {(i, k): 1 for k in JAX_RECOMPUTED[remat] for i in range(cfg.n_layers)}
    assert mode.counts == want, remat
    want_bwd_fwd = 0 if remat == "none" else cfg.n_layers
    assert calls["fwd"] == cfg.n_layers + want_bwd_fwd


@functools.lru_cache(maxsize=None)
def _jax_dots(remat):
    """2-D dots (no batch dimensions) in XLA's compiled backward of a
    one-layer tiny model, flash attention, f32."""
    cfg = jt.preset("tiny", dtype=jnp.float32, attn_impl="flash", remat=remat, n_layers=1)
    params = jt.init_transformer(jax.random.PRNGKey(0), cfg)
    tok = np.zeros((1, 8), np.int32)
    text = jax.jit(jax.grad(lambda p: jt.lm_loss(p, tok, cfg))).lower(params).compile().as_text()
    return sum(1 for ln in text.splitlines()
               if re.search(r"= \S+ dot\(", ln) and "lhs_batch_dims" not in ln)


@pytest.mark.parametrize("remat", ["dots", "save_qkv_mid_up", "save_mlp_mid"])
def test_recompute_table_is_what_xla_replays(remat):
    assert _jax_dots(remat) - _jax_dots("none") == len(JAX_RECOMPUTED[remat])


def test_names_policy_parsing_and_kept_names():
    assert tt.KNOWN_SAVE_NAMES == jt.KNOWN_SAVE_NAMES
    assert tt._REMAT_SAVE_SETS == jt._REMAT_SAVE_SETS
    assert tt.remat_save_names("save:resid_mid, mlp_up") == ("resid_mid", "mlp_up")
    with pytest.raises(ValueError, match="unknown activation"):
        tt.remat_save_names("save:resid_mld")

    def kept(**over):
        return tt.kept_names(tt.preset("tiny", **over))

    assert kept(attn_impl="flash", remat="save_qkv_mid_up") == (
        "flash_q", "flash_k", "flash_v", "resid_mid", "mlp_up")
    # flash_q/k/v are flash's inputs: dense attention tags none of them
    assert kept(attn_impl="dense", remat="save_qkv") == ()
    assert kept(attn_impl="dense", remat="save:mlp_up") == ("resid_mid", "mlp_up")
    # an MoE layer has no mlp_gate/mlp_up
    assert tt.kept_names(tt.preset("tiny-moe", attn_impl="flash", remat="save_qkv_mid_mlp")) \
        == ("flash_q", "flash_k", "flash_v", "resid_mid")
    assert kept(remat="full") == kept(remat="dots") == ()
