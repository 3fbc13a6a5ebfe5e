"""The port's ResNet pieces (models/resnet.py) against the JAX package's,
on the CPU in f32, inputs from a numpy seed and params converted from
JAX's init: SAME padding (convolutions at stride 2 on even and odd sizes,
the space-to-depth stem, the max pool), batch norm in each mode, and the
bottleneck in its plain and fused forms. On the JAX side the fused form
runs JAX's plain ``_reference`` (what ``fused_linear_stats`` takes off
TPU); on the port's side the CPU path takes its plain version too. The
whole network is in tests/test_torch_resnet_forward.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.models import resnet as jr  # noqa: E402
from tf_operator_tpu_torch import compat  # noqa: E402
from tf_operator_tpu_torch.models import resnet as tr  # noqa: E402

torch.set_num_threads(1)

# Single ops and blocks, f32 on both sides: the same sums in other orders
# (~1e-7 relative); limit 1e-5 of each output's largest magnitude.
OP_REL = 1e-5


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _tree_close(got, want, rel, what):
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        _close(g, w, rel, f"{what} {jax.tree_util.keystr(path)}")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("size,k,stride", [(56, 3, 2), (7, 3, 2), (112, 3, 2), (224, 7, 2),
                                           (9, 1, 2), (8, 3, 1)])
def test_same_pad_is_xla_same(size, k, stride):
    """The padding XLA's SAME gives: stride-2 3x3 at even sizes is (0, 1)."""
    lo, hi = tr._same_pad(size, k, stride)
    out = -(-size // stride)
    assert (size + lo + hi - k) // stride + 1 == out and hi - lo in (0, 1)
    if (size, k, stride) == (56, 3, 2):
        assert (lo, hi) == (0, 1)
    if (size, k, stride) == (224, 7, 2):
        assert (lo, hi) == (2, 3)


@pytest.mark.parametrize("hw,k,stride", [(8, 3, 2), (7, 3, 2), (8, 1, 2), (9, 7, 2), (6, 3, 1)])
def test_conv_matches_jax(hw, k, stride):
    rng = np.random.RandomState(hw * 10 + k)
    x = rng.randn(2, hw, hw, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32)
    want = jr._conv(jnp.asarray(x), jnp.asarray(w), stride)
    _close(tr._conv(_t(x), _t(w), stride), want, OP_REL, "conv")


def test_stem_s2d_matches_jax_and_the_literal_conv():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    w7 = rng.randn(7, 7, 3, 8).astype(np.float32)
    got = tr._stem_s2d(_t(x), _t(w7))
    _close(got, jr._stem_s2d(jnp.asarray(x), jnp.asarray(w7)), OP_REL, "s2d stem")
    _close(got, tr._conv(_t(x), _t(w7), 2).detach().numpy(), OP_REL, "s2d vs 7x7/s2")


@pytest.mark.parametrize("hw", [16, 15])
def test_max_pool_matches_jax_reduce_window(hw):
    rng = np.random.RandomState(hw)
    x = rng.randn(2, hw, hw, 4).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")
    got = tr._max_pool_same(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", [
    dict(train=True), dict(train=True, fused_stats=False), dict(train=True, in_act_dtype=False),
    dict(train=True, ghost=True), dict(train=False)], ids=["fused", "two_pass", "f32_affine",
                                                           "ghost", "eval"])
def test_batch_norm_matches_jax(mode):
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 5, 5, 6) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.rand(6).astype(np.float32) + 0.5, "bias": rng.randn(6).astype(np.float32)}
    s = {"mean": rng.randn(6).astype(np.float32) * 0.1,
         "var": rng.rand(6).astype(np.float32) + 0.5}
    if mode.get("ghost"):
        s.update(bmean=rng.randn(6).astype(np.float32), bvar=rng.rand(6).astype(np.float32) + 1)
    jy, js = jr._batch_norm(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p),
                            jax.tree_util.tree_map(jnp.asarray, s), **mode)
    ty, ts = tr._batch_norm(_t(x), compat.params_from_numpy(p, "cpu"),
                            compat.params_from_numpy(s, "cpu"), **mode)
    _close(ty, jy, OP_REL, "y")
    assert sorted(ts) == sorted(js)
    _tree_close(ts, js, OP_REL, "state")


@pytest.fixture(scope="module")
def two_stage():
    """The params and state of a 2-stage f32 net (the port's init, as
    numpy): stage0 block0 (stride 1, projection 64 -> 64) and stage1 block0
    (stride 2, projection 64 -> 128), the blocks JAX's own fused-bottleneck
    test picks."""
    cfg = tr.ResNetConfig((1, 1), (16, 32), 10, dtype=torch.float32)
    return compat.params_to_numpy(tr.init_resnet(cfg, torch.Generator().manual_seed(0), "cpu"))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_matches_jax(two_stage, stride, fused):
    params, state = two_stage
    si = 0 if stride == 1 else 1
    bp, bs = params[f"stage{si}"][0], state[f"stage{si}"][0]
    x = np.random.RandomState(stride).randn(4, 8, 8, 64).astype(np.float32)
    tbp, tbs = compat.params_from_numpy(bp, "cpu"), compat.params_from_numpy(bs, "cpu")
    if fused:
        jfn = jax.jit(lambda x, p, s: jr._bottleneck_fused(x, p, s, stride, bn_act=True))
        ty, ts = tr._bottleneck_fused(_t(x), tbp, tbs, stride, bn_act=True)
    else:
        jfn = jax.jit(lambda x, p, s: jr._bottleneck(x, p, s, stride, True, True, True))
        ty, ts = tr._bottleneck(_t(x), tbp, tbs, stride, True, True, True)
    jy, js = jfn(x, bp, bs)
    _close(ty, jy, OP_REL, "y")
    assert ty.shape == (4, 8 // stride, 8 // stride, bp["conv3"].shape[-1])
    _tree_close(ts, js, OP_REL, "state")
