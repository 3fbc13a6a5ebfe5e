"""The port's grouped matmul against the JAX package's, on the CPU in f32,
inputs from a numpy seed: values and grads (x, w, row_scale) of
``gmm`` and ``gmm(row_scale=...)`` against JAX's ``gmm(..., interpret=True)``
(the Pallas kernels run by the interpreter) on sentinel blocks, experts
without blocks and interleaved blocks of one expert; the per-expert block
lists of the dw walk; and the argument checks of the CUDA kernel wrappers,
which run without a card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.ops import grouped_matmul as jgm  # noqa: E402
from tf_operator_tpu_torch.ops import grouped_matmul as gm  # noqa: E402

torch.set_num_threads(1)

B = 8  # a small row block, so experts span several blocks cheaply
R, K, N, E = 64, 16, 32, 4
# f32 on both sides; only the order of the sums differs (products of
# O(1) inputs over k <= 32 and 64 rows): ~1e-6 at most.
ATOL = 1e-5

BLOCK_MAPS = {
    "sentinel": [0, 0, 1, -1, 2, 2, -1, 3],
    "zero_token_experts": [0, 0, 0, 2, 2, 0, 2, 2],  # experts 1 and 3 own no block
    "interleaved": [0, 1, 0, 1, 0, 1, 0, 1],
}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(R, K).astype(np.float32)
    w = (rng.randn(E, K, N) * 0.1).astype(np.float32)
    s = (1.0 / (1.0 + np.exp(-rng.randn(R)))).astype(np.float32)
    g = rng.randn(R, N).astype(np.float32)  # the cotangent of y
    return x, w, s, g


@pytest.fixture(scope="module")
def jax_vjp():
    """Jitted (y, dx, dw, ds) of JAX's gmm, unscaled and scaled, with the
    block map an argument: one compile each for every case."""
    def make(scaled):
        def f(x, w, s, be, g):
            def fwd(x, w, s):
                return jgm.gmm(x, w, be, row_scale=s if scaled else None, block_rows=B,
                               interpret=True)
            y, vjp = jax.vjp(fwd, x, w, s)
            return (y, *vjp(g))
        return jax.jit(f)
    return {False: make(False), True: make(True)}


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("case", sorted(BLOCK_MAPS))
def test_gmm_values_and_grads_match_jax(jax_vjp, case, scaled):
    x, w, s, g = _inputs()
    be = np.asarray(BLOCK_MAPS[case], np.int32)
    want = [np.asarray(a) for a in jax_vjp[scaled](x, w, s, be, g)]

    xt, wt, st = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, s))
    y = gm.gmm(xt, wt, torch.from_numpy(be), row_scale=st if scaled else None, block_rows=B)
    y.backward(torch.from_numpy(g))
    got = [y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()]
    names = ["y", "dx", "dw"]
    if scaled:
        got.append(st.grad.numpy())
        names.append("ds")
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f"{case} {name}")
    for i in np.flatnonzero(be < 0):  # sentinel rows and their cotangents: exact zeros
        rows = slice(i * B, (i + 1) * B)
        assert (got[0][rows] == 0).all() and (got[1][rows] == 0).all()
        if scaled:
            assert (got[3][rows] == 0).all()
    for e in sorted(set(range(E)) - set(be.tolist())):  # no block: exact-zero dw
        assert (got[2][e] == 0).all(), (case, e)
    assert all(np.abs(got[2][e]).sum() > 0 for e in set(be.tolist()) - {-1})


def test_row_count_must_divide_block_rows():
    x = torch.zeros(60, K)
    w = torch.zeros(E, K, N)
    with pytest.raises(ValueError, match="divisible"):
        gm.gmm(x, w, torch.zeros(8, dtype=torch.int32), block_rows=B)
    with pytest.raises(ValueError, match="divisible"):
        jgm.gmm(jnp.zeros((60, K)), jnp.zeros((E, K, N)), jnp.zeros((8,), jnp.int32),
                block_rows=B, interpret=True)


@pytest.fixture(scope="module")
def jax_block_lists():
    """JAX's _expert_block_lists, jitted once for 8 blocks."""
    return jax.jit(jgm._expert_block_lists, static_argnums=(1, 2))


@pytest.mark.parametrize("be", [
    [0, 0, 1, -1, 2, 2, -1, 3], [0, 0, 0, 2, 2, 0, 2, 2], [3, 1, 3, 1, 0, 0, 3, 2],
    [-1] * 8, [2] * 8,
])
def test_expert_block_lists_match_jax(jax_block_lists, be):
    be = np.asarray(be, np.int32)
    want_n, want_l = jax_block_lists(jnp.asarray(be), E, len(be))
    got_n, got_l = gm._expert_block_lists(torch.from_numpy(be), E, len(be))
    assert got_n.dtype == got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers check shapes, types, contiguity and block size
    before any launch, and refuse CPU tensors (the kernels have no CPU
    mode); none of this needs a card."""
    x = torch.zeros(256, 32, dtype=torch.bfloat16)
    w = torch.zeros(E, 32, 64, dtype=torch.bfloat16)
    be = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA"):
        gm.gmm_fwd_kernel(x, w, be, block_rows=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        gm.gmm_fwd_kernel(x, w, torch.zeros(32, dtype=torch.int32), block_rows=8)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        gm.gmm_fwd_kernel(x.half(), w.half(), be, block_rows=128)
    with pytest.raises(TypeError, match="operands"):
        gm.gmm_fwd_kernel(x, w.float(), be, block_rows=128)
    with pytest.raises(TypeError, match="int32"):
        gm.gmm_fwd_kernel(x, w, be.long(), block_rows=128)
    with pytest.raises(ValueError, match="contiguous"):
        gm.gmm_fwd_kernel(x, w.transpose(1, 2), be, block_rows=128, trans_w=False)
    with pytest.raises(ValueError, match="contraction"):
        gm.gmm_fwd_kernel(x, w, be, block_rows=128, trans_w=True)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.gmm_fwd_kernel(x[:, :12].contiguous(), w[:, :12].contiguous(), be, block_rows=128)
    with pytest.raises(TypeError, match="row_scale must be float32"):
        gm.gmm_fwd_kernel(x, w, be, torch.zeros(256, dtype=torch.bfloat16), block_rows=128)
    with pytest.raises(ValueError, match="no transposed-weight form"):
        gm.gmm_fwd_kernel(x, w.transpose(1, 2).contiguous(), be, torch.zeros(256),
                          block_rows=128, trans_w=True)
    dy = torch.zeros(256, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA"):
        gm.gmm_dw_kernel(x, dy, be, E, block_rows=128)
    with pytest.raises(ValueError, match="dy must be"):
        gm.gmm_dw_kernel(x, dy[:128], be, E, block_rows=128)
