"""The port's transformer pieces that serving needs, against the JAX
package's: config and presets, RMSNorm and rotary embedding at absolute
positions (f32, 1e-6), and the shapes and scales of the initial params."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)


def test_presets_match_jax():
    """Every field but dtype equal; dtype is bf16 in both (torch's and jnp's)."""
    assert set(tt.PRESETS) == set(jt.PRESETS)
    for name, jc in jt.PRESETS.items():
        fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
                  if f.name != "dtype"}
        got = dataclasses.asdict(tt.PRESETS[name])
        assert got.pop("dtype") == torch.bfloat16 and jc.dtype == jnp.bfloat16, name
        assert got == fields, name
        assert tt.PRESETS[name].head_dim == jc.head_dim
        assert tt.PRESETS[name].n_params() == jc.n_params()


def test_preset_from_workload_matches_jax():
    assert tt.CONFIG_OVERRIDE_FIELDS == jt.CONFIG_OVERRIDE_FIELDS
    wl = {"preset": "gqa-2048", "n_layers": 2, "max_seq": 512, "attn": "flash",
          "requests": 4}
    got = dataclasses.asdict(tt.preset_from_workload(wl))
    want = dataclasses.asdict(jt.preset_from_workload(wl))
    got.pop("dtype")
    want.pop("dtype")
    assert got == want
    assert tt.preset_from_workload({}) == tt.PRESETS["tiny"]


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 4, 16)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3.0).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    want = np.asarray(jt._rms_norm(jnp.asarray(x), jnp.asarray(gamma), 1e-5))
    got = tt._rms_norm(torch.from_numpy(x), torch.from_numpy(gamma), 1e-5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("d_head", [16, 128])
def test_rope_at_positions_matches_jax(d_head):
    """Absolute positions from 0 to near max_seq, as decode and mid-
    sequence prefill chunks use them."""
    rng = np.random.RandomState(1)
    b, t, h = 3, 4, 2
    x = rng.randn(b, t, h, d_head).astype(np.float32)
    pos = rng.randint(0, 4096, size=(b, t)).astype(np.int32)
    pos[0] = np.arange(t)
    want = np.asarray(jt.rope_at_positions(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tt.rope_at_positions(torch.from_numpy(x), torch.from_numpy(pos).long(),
                               10000.0).numpy()
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_init_keys_shapes_and_scale():
    cfg = tt.preset("tiny", d_model=128, d_ff=256, vocab=512, n_layers=3)
    p = tt.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.eval_shape(
        lambda k: jt.init_transformer(k, jt.preset("tiny", d_model=128, d_ff=256,
                                                   vocab=512, n_layers=3)),
        jax.random.PRNGKey(0))
    jflat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(p)[0])
    assert len(tflat) == len(jflat)
    for path, sd in jflat:
        assert tuple(tflat[path].shape) == sd.shape, path
        assert tflat[path].dtype == torch.float32
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    assert p["embed"].std().item() == pytest.approx(0.02, rel=0.05)
    lp = p["layers"]
    for name, fan_in in (("wq", d), ("wk", d), ("wv", d), ("wo", cfg.n_heads * hd),
                         ("w_gate", d), ("w_up", d), ("w_down", f)):
        assert lp[name].std().item() == pytest.approx(fan_in ** -0.5, rel=0.05), name
        assert abs(lp[name].mean().item()) < 0.1 * fan_in ** -0.5, name
    for name in ("attn_norm", "mlp_norm"):
        assert torch.equal(lp[name], torch.ones(cfg.n_layers, d))
    assert torch.equal(p["final_norm"], torch.ones(d))
    # the seed decides the draw
    again = tt.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["layers"]["wq"], lp["wq"])


def test_init_moe_tree_matches_jax():
    cfg = tt.preset("tiny-moe")
    p = tt.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.eval_shape(lambda k: jt.init_transformer(k, jt.preset("tiny-moe")),
                             jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p["layers"].items()} == {
        k: v.shape for k, v in jshapes["layers"].items()}
