"""The port's ``resnet_forward`` (models/resnet.py) against the JAX
package's on ``tiny``, on the CPU in f32, images from a numpy seed and
params converted from JAX's init: train mode (logits, new BN state and
every param's grad, ``fused_1x1`` on and off, each stop-gradient mode) and
eval mode; and, as JAX's own test pins them, the stop-gradient modes'
forward equal and their backward pairwise distinct. On the JAX side the
fused form runs JAX's plain ``_reference`` (what ``fused_linear_stats``
takes off TPU); on the port's side the CPU path takes its plain version.
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

# The whole network (stem, 4 bottlenecks, head) and its backward, f32 on
# both sides with the BN statistics in f32: the per-op differences (other
# sum orders, ~1e-7) pass through 17 batch norms. On JAX's init below,
# measured: logits within 3e-6, state within 4e-6, each param's grad
# within 2.3e-5 of its largest magnitude; the limits are 10x that. The
# comparison's conditioning depends on the draw, and the smallest batch
# variance does not predict it: of six inits tried (JAX's PRNGKey 0 and 1,
# an rbg key, three torch seeds), two put a few grads 5e-2 and 1.2e-1 of
# their leaf's largest apart, with the smallest batch variance at 0.078
# and 0.13 (0.16 here). Those leaves' true values cancel to near zero (a
# BN bias in front of another batch norm), so the f32 rounding of the
# statistics dominates them; with every value and statistic in f64, port
# and JAX agreed to 5e-14 on such a draw. MIN_BATCH_VAR guards the
# gross case only: a channel whose variance nears zero.
NET_LOGITS_ATOL = 3e-5
NET_STATE_ATOL = 4e-5
NET_GRAD_REL = 2e-4
MIN_BATCH_VAR = 1e-2
# b 4 at 64^2: stage 3 sees 2 x 2 pixels, 16 rows a channel
IMAGES = (4, 64, 64, 3)


def _close(got, want, atol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _tiny(fused=False, sg="var"):
    jcfg = jr.ResNetConfig((1, 1, 1, 1), (16, 32, 64, 128), 10, dtype=jnp.float32,
                           fused_1x1=fused, bn_stats_stop_gradient=sg)
    tcfg = tr.ResNetConfig((1, 1, 1, 1), (16, 32, 64, 128), 10, dtype=torch.float32,
                           fused_1x1=fused, bn_stats_stop_gradient=sg)
    return jcfg, tcfg


SG_MODES = (False, "var", True)


@pytest.fixture(scope="module")
def net():
    """JAX's init of tiny (PRNGKey(0)), as numpy; images and labels from a
    numpy seed."""
    jcfg, _ = _tiny()
    params, state = jax.jit(lambda k: jr.init_resnet(k, jcfg))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    images = rng.randn(*IMAGES).astype(np.float32)
    labels = rng.randint(0, 10, IMAGES[0])
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state), images, labels)


@pytest.fixture(scope="module")
def jax_train(net):
    """JAX's (logits, new state, grads) for each stop-gradient mode, one
    compile per fused_1x1 setting (all three modes in one program)."""
    params, state, images, labels = net
    cache = {}

    def get(fused):
        if fused not in cache:
            def loss(p, cfg):
                logits, new_state = jr.resnet_forward(p, state, images, cfg, train=True)
                xent = -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(labels)), labels])
                return xent, (logits, new_state)

            cfgs = [_tiny(fused, sg)[0] for sg in SG_MODES]
            outs = jax.jit(lambda p: [jax.value_and_grad(lambda q: loss(q, c), has_aux=True)(p)
                                      for c in cfgs])(params)
            cache[fused] = {sg: (o[0][1][0], o[0][1][1], o[1]) for sg, o in zip(SG_MODES, outs)}
        return cache[fused]

    return get


def _smallest_batch_var(new_state):
    """The smallest per-channel batch variance of any BN input, read back
    from the running variance: new = 0.9 * 1 + 0.1 * batch_var."""
    return min(float(((np.asarray(v) - 0.9) / 0.1).min())
               for path, v in jax.tree_util.tree_leaves_with_path(new_state)
               if jax.tree_util.keystr(path).endswith("['var']"))


@pytest.mark.parametrize("sg", SG_MODES, ids=["exact", "var", "stop_both"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_1x1"])
def test_resnet_forward_train_matches_jax(net, jax_train, fused, sg):
    """tiny, train mode: logits, new BN state and every param's grad of the
    mean cross-entropy (see NET_* for the limits)."""
    params, state, images, labels = net
    jlogits, jstate, jgrads = jax_train(fused)[sg]
    assert _smallest_batch_var(jstate) > MIN_BATCH_VAR
    tp = compat.tree_map(lambda a: a.requires_grad_(True), compat.params_from_numpy(params, "cpu"))
    logits, new_state = tr.resnet_forward(tp, compat.params_from_numpy(state, "cpu"),
                                          torch.from_numpy(images), _tiny(fused, sg)[1],
                                          train=True)
    loss = -torch.log_softmax(logits, -1)[torch.arange(len(labels)), torch.from_numpy(labels)]
    loss.mean().backward()
    _close(logits, jlogits, NET_LOGITS_ATOL, "logits")
    assert not any(t.requires_grad for t in jax.tree_util.tree_leaves(new_state))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(new_state),
                            jax.tree_util.tree_leaves(jstate)):
        _close(g, w, NET_STATE_ATOL, f"state {jax.tree_util.keystr(path)}")
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(tp),
                            jax.tree_util.tree_leaves(jgrads)):
        _close(g.grad, w, NET_GRAD_REL * np.abs(np.asarray(w)).max(),
               f"grad {jax.tree_util.keystr(path)}")


def test_resnet_forward_eval_matches_jax(net):
    """Eval mode reads the running statistics (here one train step's):
    logits within the network limit; the state comes back unchanged."""
    params, state, images, _ = net
    jcfg, tcfg = _tiny(fused=True)  # eval ignores fused_1x1
    tparams = compat.params_from_numpy(params, "cpu")
    with torch.no_grad():
        _, tstate = tr.resnet_forward(tparams, compat.params_from_numpy(state, "cpu"),
                                      torch.from_numpy(images), tcfg, train=True)
    jlogits, _ = jax.jit(lambda p, s: jr.resnet_forward(p, s, images, jcfg, train=False))(
        params, compat.params_to_numpy(tstate))
    with torch.no_grad():
        logits, same = tr.resnet_forward(tparams, tstate, torch.from_numpy(images), tcfg,
                                         train=False)
    _close(logits, jlogits, NET_LOGITS_ATOL, "eval logits")
    assert all(a is b for a, b in zip(jax.tree_util.tree_leaves(same),
                                      jax.tree_util.tree_leaves(tstate)))


def test_stop_gradient_modes_forward_identical_backward_differs(net):
    """As JAX's test pins it: the forward is the same in every mode, and
    the three backward variants are pairwise distinct."""
    params, state, images, labels = net
    grads, logits = {}, {}
    for sg in SG_MODES:
        _, tcfg = _tiny(sg=sg)
        tp = compat.tree_map(lambda a: a.requires_grad_(True),
                             compat.params_from_numpy(params, "cpu"))
        out, _ = tr.resnet_forward(tp, compat.params_from_numpy(state, "cpu"),
                                   torch.from_numpy(images), tcfg, train=True)
        torch.log_softmax(out, -1)[:, 0].mean().neg().backward()
        logits[sg] = out.detach()
        grads[sg] = torch.cat([a.grad.flatten() for a in jax.tree_util.tree_leaves(tp)])
    assert torch.equal(logits[False], logits["var"]) and torch.equal(logits[False], logits[True])
    for a, b in ((False, "var"), (False, True), ("var", True)):
        assert float((grads[a] - grads[b]).abs().max()) > 1e-6, (a, b)


def test_params_round_trip_bit_for_bit(net):
    """JAX's params and BN state of tiny, stage lists included, convert to
    the port's tensors and back bit for bit; the lists stay lists."""
    params, state, _, _ = net
    for tree in (params, state):
        tp = compat.params_from_numpy(tree, "cpu")
        assert isinstance(tp["stage0"], list) and isinstance(tp["stage0"][0], dict)
        back = compat.params_to_numpy(tp)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
