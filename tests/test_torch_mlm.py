"""The port's masked-LM (BERT-class, ``causal=False``) loss against the JAX
package's, on the CPU at the ``tiny`` preset in f32, inputs from a numpy
seed.

- With JAX's own mask (``jax.random.bernoulli(PRNGKey(0), 0.15, shape)``,
  what JAX's loss draws when given no key) passed in, the loss, ce_loss
  and every grad within 1e-5, fused and unfused cross entropy (flash
  attention, non-causal: the plain versions here, Pallas's fallback in
  JAX).
- Without a mask the port draws its fixed mask on the host,
  ``RandomState(0).random_sample(shape) < mask_rate``, the same at every
  call, and the loss is the one with that mask passed in.
- The lm workload trains a bidirectional tiny model through the fused
  CE and the non-causal flash path.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu_torch import compat  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402
from tf_operator_tpu_torch.workloads import lm  # noqa: E402

torch.set_num_threads(1)

B, T = 4, 16
ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    params = tt.init_transformer_numpy(tt.preset("tiny"), 0)
    tokens = np.random.RandomState(7).randint(1, 256, (B, T)).astype(np.int32)
    mask = np.array(jax.random.bernoulli(jax.random.PRNGKey(0), 0.15, (B, T)))
    return params, tokens, mask


@pytest.mark.parametrize("fused", [True, False])
def test_mlm_loss_and_grads_match_jax(setup, fused):
    params, tokens, mask = setup
    jcfg = jt.preset("tiny", dtype=jnp.float32, causal=False, attn_impl="flash",
                     fused_xent=fused)
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss_and_metrics(p, tokens, jcfg), has_aux=True))(params)
    cfg = tt.preset("tiny", dtype=torch.float32, causal=False, attn_impl="flash",
                    fused_xent=fused)
    p = compat.params_from_numpy(params, "cpu")
    for x in jax.tree_util.tree_leaves(p):
        x.requires_grad_(True)
    loss, metrics = tt.lm_loss_and_metrics(p, torch.from_numpy(tokens).long(), cfg,
                                           mask=torch.from_numpy(mask))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), abs=ATOL)
    assert float(metrics["ce_loss"].detach()) == pytest.approx(float(want_m["ce_loss"]),
                                                               abs=ATOL)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(p),
                            jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=ATOL, rtol=0,
                                   err_msg=str(path))
    # JAX's loss without a key is the loss with PRNGKey(0)'s mask
    assert 0 < mask.sum() < mask.size


def test_default_mask_is_the_fixed_host_draw(setup, monkeypatch):
    params, tokens, _ = setup
    cfg = tt.preset("tiny", dtype=torch.float32, causal=False)
    want = np.random.RandomState(0).random_sample((B, T)) < 0.15
    got = tt.mlm_mask((B, T), 0.15, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tt.mlm_mask((B, T), 0.15, torch.device("cpu")) is got
    p = compat.params_from_numpy(params, "cpu")
    tok = torch.from_numpy(tokens).long()
    with torch.no_grad():
        default = tt.lm_loss(p, tok, cfg)
        explicit = tt.lm_loss(p, tok, cfg, mask=torch.from_numpy(want))
        other = tt.lm_loss(p, tok, cfg, mask_rate=0.5)
    assert float(default) == float(explicit) and float(other) != float(default)
    # the masked positions read MASK_TOKEN, the others their own token
    seen = {}
    real = tt.transformer_hidden

    def spy(params, inputs, *a, **kw):
        seen["inputs"] = inputs
        return real(params, inputs, *a, **kw)

    monkeypatch.setattr(tt, "transformer_hidden", spy)
    with torch.no_grad():
        tt.lm_loss(p, tok, cfg)
    np.testing.assert_array_equal(seen["inputs"].numpy(),
                                  np.where(want, tt.MASK_TOKEN, tokens))


def test_lm_workload_trains_mlm():
    wl = {"preset": "tiny", "causal": False, "steps": 4, "batch_size": 4, "seq_len": 32,
          "attn": "flash", "remat": "full", "lr": 3e-3, "device": "cpu"}
    run = lm.run_lm(wl, device="cpu")
    assert not run.cfg.causal and np.isfinite(run.losses).all()
    assert run.losses[-1] < run.losses[0]
