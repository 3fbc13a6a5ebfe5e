"""The port's flash attention and fused cross-entropy against the JAX
package's, on the CPU at small sizes, f32, inputs from a numpy seed.

Flash: the plain versions of the three kernels (flash_fwd_reference,
flash_bwd_reference) and the public flash_attention_lse, value and grads
through o and lse, against JAX's reference_attention_lse and jax.vjp of
it, and once against the Pallas kernel itself in interpret mode. Fused
CE: value and both grads against JAX's fused_cross_entropy. Both sides
sum in f32 in other orders, so the tolerance is 1e-5 on O(1) values.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

# the module, not the function of the same name that ops/__init__ exports
jfa = importlib.import_module("tf_operator_tpu.ops.flash_attention")
from tf_operator_tpu.ops.fused_cross_entropy import (  # noqa: E402
    fused_cross_entropy as jax_fused_xent,
)
from tf_operator_tpu_torch.ops import flash_attention as fa  # noqa: E402
from tf_operator_tpu_torch.ops.fused_cross_entropy import fused_cross_entropy  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(seed, b, t, h, h_kv, d):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return f(b, t, h, d), f(b, t, h_kv, d), f(b, t, h_kv, d), f(b, t, h, d), f(b, t, h, scale=0.5)


def _jax_value_and_grads(fn, q, k, v, do, dlse):
    """(o, lse, dq, dk, dv) of fn, one jitted program (op-by-op dispatch of
    the vjp costs several times its compile)."""
    def go(q, k, v, do, dlse):
        out, vjp = jax.vjp(fn, q, k, v)
        return (*out, *vjp((do, dlse)))

    return [np.asarray(x) for x in jax.jit(go)(q, k, v, do, dlse)]


def _close(got, want, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, atol=atol, rtol=0)


@pytest.mark.parametrize("causal,h,h_kv,t", [
    (True, 4, 2, 13), (True, 2, 2, 13), (False, 4, 2, 13), (False, 2, 2, 16),
])
def test_flash_matches_jax_reference(causal, h, h_kv, t):
    """Plain versions and the autograd entry, nonzero lse cotangent."""
    q, k, v, do, dlse = _inputs(0, 2, t, h, h_kv, 16)
    want = _jax_value_and_grads(
        lambda q_, k_, v_: jfa.reference_attention_lse(q_, k_, v_, causal=causal),
        q, k, v, do, dlse)
    tq, tk, tv, tdo, tdl = (torch.from_numpy(x) for x in (q, k, v, do, dlse))

    o, lse = fa.flash_fwd_reference(tq, tk, tv, causal)
    _close([o, lse, *fa.flash_bwd_reference(tq, tk, tv, o, lse, tdo, tdl, causal)], want)

    o, lse = fa.reference_attention_lse(tq, tk, tv, causal)
    _close([o, lse], want[:2])

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    o, lse = fa.flash_attention_lse(*leaves, causal=causal)
    torch.autograd.backward((o, lse), (tdo, tdl))
    _close([o.detach(), lse.detach(), *[x.grad for x in leaves]], want)


def test_flash_matches_pallas_kernel_interpret():
    """The Pallas kernels themselves (interpret mode) on one small GQA case."""
    q, k, v, do, dlse = _inputs(1, 1, 16, 4, 2, 16)
    want = _jax_value_and_grads(
        lambda q_, k_, v_: jfa.flash_attention_lse(q_, k_, v_, causal=True, interpret=True),
        q, k, v, do, dlse)
    tq, tk, tv, tdo, tdl = (torch.from_numpy(x) for x in (q, k, v, do, dlse))
    o, lse = fa.flash_fwd_reference(tq, tk, tv, True)
    _close([o, lse, *fa.flash_bwd_reference(tq, tk, tv, o, lse, tdo, tdl, True)], want)


def test_flash_wrapper_checks_refuse_bad_arguments(monkeypatch):
    """The kernel wrappers' checks run before any launch, so CPU tensors
    reach them: wrong dtype or layout raises; valid CPU tensors raise for
    want of a card."""
    q, k, v, do, _ = (torch.from_numpy(x) for x in _inputs(2, 1, 8, 4, 2, 16))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_fwd_kernel(q.half(), k.half(), v.half(), True)
    with pytest.raises(TypeError, match="k is torch.bfloat16"):
        fa.flash_fwd_kernel(q, k.bfloat16(), v, True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_kernel(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, True)
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_fwd_kernel(q[..., :8].contiguous(), k[..., :8].contiguous(),
                            v[..., :8].contiguous(), True)
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_fwd_kernel(q[:, :, :3].contiguous(), k, v, True)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match=r"\[b, h, t\]"):
        fa.flash_bwd_dq_kernel(q, k, v, do, lse.transpose(1, 2), lse, True)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_bwd_dkv_kernel(q, k, v, do, lse.double(), lse, True)
    big = torch.zeros(1, 8, 2, 256)
    for dt in (torch.bfloat16, torch.float32):
        kv = big[:, :, :1].contiguous().to(dt)
        with pytest.raises(ValueError, match="register tiles"):
            fa.flash_bwd_dkv_kernel(big.to(dt), kv, kv, big.to(dt), lse[:, :2], lse[:, :2], True)
    # every supported head dim fits every kernel in both types, so the
    # shared-memory check shows only under a lower limit
    for kind in ("fwd", "dq", "dkv"):
        for dt in (torch.bfloat16, torch.float32):
            assert fa.flash_smem_bytes(kind, dt, fa.FLASH_MAX_D) <= fa.FLASH_MAX_SMEM
    # the backward: slots of one landed 64 x 64 box (8 KB bf16; 16 KB f32,
    # split in place into hi and lo planes), two a row at d 128. dq: Q and
    # dO of 2 x 64 rows in one buffer, K and V of 64 keys in four stages,
    # 10 mbarriers; f32 one stage, 4 mbarriers. dkv: K and V of 2 x 64 keys,
    # Q and dO of 64 queries in two stages, two buffers of 64 lse and 64
    # delta for each of 8 consumer warps, 6 mbarriers; f32 64 keys, one
    # stage, 4 consumer warps, 4 mbarriers
    assert fa.flash_smem_bytes("dq", torch.bfloat16, 128) == (
        4 * 2 * 8192 + 4 * (2 * 2 * 8192) + 10 * 8 + 1024)
    assert fa.flash_smem_bytes("dq", torch.float32, 128) == (
        4 * 2 * 16384 + 2 * 2 * 16384 + 4 * 8 + 1024)
    assert fa.flash_smem_bytes("dkv", torch.bfloat16, 128) == (
        4 * 2 * 8192 + 2 * (2 * 2 * 8192) + 8 * 2 * 2 * 64 * 4 + 6 * 8 + 1024)
    assert fa.flash_smem_bytes("dkv", torch.float32, 16) == (
        2 * 16384 + 2 * 16384 + 4 * 2 * 2 * 64 * 4 + 4 * 8 + 1024)
    # the forward: 256-byte rows at d 128 (two 64-column boxes), Q's 2 x 64
    # rows in two buffers, K's and V's 64 keys in five stages, 14
    # mbarriers, 1024 to align; f32 keeps one Q in hi and lo planes, lands
    # one f32 stage and splits it into K/V planes, 4 mbarriers
    assert fa.flash_smem_bytes("fwd", torch.bfloat16, 128) == (
        2 * (2 * 64 * 256) + 5 * (2 * 64 * 256) + 14 * 8 + 1024)
    assert fa.flash_smem_bytes("fwd", torch.float32, 128) == (
        2 * (2 * 64 * 256) + 2 * (2 * 64 * 256) + 2 * (2 * 64 * 256) + 4 * 8 + 1024)
    assert fa.flash_smem_bytes("fwd", torch.bfloat16, 16) == (
        2 * (2 * 64 * 128) + 5 * (2 * 64 * 128) + 14 * 8 + 1024)
    monkeypatch.setattr(fa, "FLASH_MAX_SMEM", fa.flash_smem_bytes("fwd", torch.float32, 16) - 1)
    with pytest.raises(ValueError, match="shared memory"):
        fa.flash_fwd_kernel(q, k, v, True)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="needs CUDA"):
        fa.flash_fwd_kernel(q, k, v, True)


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_cross_entropy_matches_jax(weighted):
    """n = 37 rows in blocks of 16 (three pad rows), vocab 50."""
    rng = np.random.RandomState(3)
    n, d, vocab = 37, 16, 50
    x = rng.randn(n, d).astype(np.float32)
    embed = (rng.randn(vocab, d) * 0.3).astype(np.float32)
    tgt = rng.randint(0, vocab, n).astype(np.int32)
    w = (rng.rand(n) > 0.3).astype(np.float32) if weighted else None

    def jloss(x_, e_):
        return jax_fused_xent(x_, e_, jnp.asarray(tgt),
                              None if w is None else jnp.asarray(w), row_block=16)

    want, (gx, ge) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(embed))
    tx = torch.from_numpy(x).requires_grad_(True)
    te = torch.from_numpy(embed).requires_grad_(True)
    got = fused_cross_entropy(tx, te, torch.from_numpy(tgt),
                              None if w is None else torch.from_numpy(w), row_block=16)
    got.backward()
    _close([got.detach(), tx.grad, te.grad], [np.asarray(want), np.asarray(gx), np.asarray(ge)])


def test_fused_cross_entropy_refuses_empty():
    with pytest.raises(ValueError, match="at least one row"):
        fused_cross_entropy(torch.zeros(0, 4), torch.zeros(5, 4), torch.zeros(0, dtype=torch.long))
