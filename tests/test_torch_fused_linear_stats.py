"""The port's fused matmul + BN statistics (ops/fused_linear_stats.py)
against the JAX package's, on the CPU, inputs from a numpy seed: the plain
version against JAX's ``_reference`` and against the Pallas kernel in
interpret mode (as tests/test_fused_linear_stats.py runs it), with and
without the prologue; the custom backward against JAX's VJP and against
autograd through the plain version; the kernel wrapper's refusals. The
kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.ops import fused_linear_stats as jfls  # noqa: E402
from tf_operator_tpu_torch.ops import fused_linear_stats as fls  # noqa: E402

torch.set_num_threads(1)

# f32 on both sides, the same products summed in other orders: each output
# within 1e-5 of its largest magnitude (sums of 256 rows can cancel to near
# zero, so a pure relative limit would not rest on anything).
REL = 1e-5


def _inputs(m=256, k=64, n=128, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.1).astype(np.float32)
    a = (np.abs(rng.randn(k)) + 0.5).astype(np.float32)
    b = (rng.randn(k) * 0.1).astype(np.float32)
    return x, w, a, b


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
def test_plain_version_matches_jax_reference_and_pallas(prologue):
    x, w, a, b = _inputs()
    t = [torch.from_numpy(v) for v in (x, w, a, b)]
    got = fls.fused_linear_stats(t[0], t[1], (t[2], t[3]) if prologue else None)
    ref = fls._reference(*t, prologue)
    want_ref = jfls._reference(*(jnp.asarray(v) for v in (x, w, a, b)), prologue)
    want_pallas = jfls.fused_linear_stats(
        jnp.asarray(x), jnp.asarray(w), (jnp.asarray(a), jnp.asarray(b)) if prologue else None,
        interpret=True)
    for name, g, r, wr, wp in zip(("y", "sum", "ssq"), got, ref, want_ref, want_pallas):
        assert g.dtype == torch.float32 and g.shape == tuple(wr.shape)
        _close(g.detach(), wr, f"{name} vs JAX _reference")
        _close(g.detach(), wp, f"{name} vs the Pallas kernel (interpret)")
        _close(r, wr, f"plain {name}")


def test_bf16_plain_version_matches_jax_reference():
    """bf16 x and w: y rounded to bf16 on both sides from the same f32
    product (exact bf16 products, f32 sums in other orders), so y agrees to
    one bf16 rounding; the f32 statistics as in f32."""
    x, w, a, b = _inputs(seed=1)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    y, s, q = fls.fused_linear_stats(xb, wb)
    jy, js, jq = jfls._reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                 jnp.asarray(a), jnp.asarray(b), False)
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), rtol=2.0**-8,
                               atol=2.0**-8 * float(np.abs(np.asarray(jy, np.float32)).max()))
    _close(s, js, "sum")
    _close(q, jq, "ssq")


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
def test_backward_matches_jax_vjp(prologue):
    """The custom backward (statistics' cotangents folded into dy, then
    plain products) against JAX's custom VJP on the same cotangents."""
    x, w, a, b = _inputs(seed=2)
    rng = np.random.RandomState(3)
    dy = rng.randn(256, 128).astype(np.float32)
    dsum = (rng.randn(128) * 0.1).astype(np.float32)
    dssq = (rng.randn(128) * 0.01).astype(np.float32)

    def jfn(x, w, a, b):
        return jfls.fused_linear_stats(x, w, (a, b) if prologue else None, interpret=True)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(v) for v in (x, w, a, b)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dsum), jnp.asarray(dssq)))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, w, a, b)]
    outs = fls.fused_linear_stats(leaves[0], leaves[1], (leaves[2], leaves[3]) if prologue else None)
    torch.autograd.backward(outs, [torch.from_numpy(v) for v in (dy, dsum, dssq)])
    names = ("dx", "dw", "da", "db") if prologue else ("dx", "dw")
    for name, leaf, wv in zip(names, leaves, want):
        _close(leaf.grad, wv, name)
    if not prologue:
        assert leaves[2].grad is None and leaves[3].grad is None


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
def test_backward_matches_autograd_of_plain_version(prologue):
    """An independent oracle: autograd through _reference."""
    x, w, a, b = _inputs(m=96, k=40, n=24, seed=4)
    rng = np.random.RandomState(5)
    cts = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((96, 24), (24,), (24,))]
    grads = []
    for fn in (lambda *t: fls.fused_linear_stats(t[0], t[1], (t[2], t[3]) if prologue else None),
               lambda *t: fls._reference(*t, prologue)):
        leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, w, a, b)]
        torch.autograd.backward(fn(*leaves), cts)
        grads.append([leaf.grad for leaf in leaves])
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            _close(got, want.numpy(), "grad")


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """On the CPU a wrapper runs the plain version; the kernel wrapper
    itself refuses CPU tensors and shapes, types and layouts the kernel
    cannot take, before anything is built."""
    x, w = torch.zeros(16, 64), torch.zeros(64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fls.fused_linear_stats_kernel(x, w)
    with pytest.raises(ValueError, match="multiples of 8"):
        fls.fused_linear_stats_kernel(torch.zeros(16, 12), torch.zeros(12, 32))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fls.fused_linear_stats_kernel(x.half(), w.half())
    with pytest.raises(TypeError, match="w is"):
        fls.fused_linear_stats_kernel(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fls.fused_linear_stats_kernel(torch.zeros(64, 16).t(), w)
    with pytest.raises(ValueError, match="both a and b"):
        fls.fused_linear_stats_kernel(x, w, torch.ones(64))
    with pytest.raises(ValueError, match="float32"):
        fls.fused_linear_stats_kernel(x, w, torch.ones(64).bfloat16(), torch.zeros(64))
    with pytest.raises(ValueError, match="x \\[M, K\\]"):
        fls.fused_linear_stats(x, w[:32])
