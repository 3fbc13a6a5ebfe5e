"""The port's MNIST workload (``workloads/mnist.py``) against the JAX
package's, on the CPU in f32.

- From JAX's ``init_params`` (carried over by ``params_from_jax``): the
  forward, the loss and the gradients within 1e-5.
- Five SGD-momentum steps (the port's Trainer, ``optimizer: sgd``) on the
  same batches track the JAX workload's ``train_step`` (optax's
  ``sgd(lr, momentum=0.9)`` on its ``loss_fn``) within 1e-5, loss by loss
  and in the final params.
- ``_np_accuracy`` equal on the same params and images.
- ``run_mnist`` in both modes, in process: the synthetic blobs' loss
  falls; an idx fixture of sklearn's digits (as the JAX e2e test writes
  it) trains to JAX's 0.95 target.

The two-process gangs through the operator are in
``tests/test_torch_operator.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from tf_operator_tpu.workloads import mnist as JM  # noqa: E402
from tf_operator_tpu_torch.train.data import write_idx  # noqa: E402
from tf_operator_tpu_torch.workloads import mnist as TM  # noqa: E402

torch.set_num_threads(1)

SIZES = [64, 32, 10]
B, LR, STEPS = 16, 0.1, 5
TOL = 1e-5


def _batches(n=STEPS, dim=SIZES[0], seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, dim)).astype(np.float32),
             rng.integers(0, 10, B).astype(np.int32)) for _ in range(n)]


def _jax_params():
    return jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(0), SIZES))


def test_forward_loss_and_grads_match_jax():
    jp = _jax_params()
    tp = TM.params_from_jax(jp, "cpu")
    for (w, b), (tw, tb) in zip(jp, tp):
        assert tw.numpy().tobytes() == w.tobytes() and tb.numpy().tobytes() == b.tobytes()
    x, y = _batches(1)[0]
    jlogits = np.asarray(JM.forward(jp, jnp.asarray(x)))
    np.testing.assert_allclose(TM.forward(tp, torch.from_numpy(x)).numpy(), jlogits,
                               atol=TOL, rtol=0)
    jloss, jgrads = jax.value_and_grad(JM.loss_fn)(jp, jnp.asarray(x), jnp.asarray(y))
    leaves = [t.requires_grad_(True) for pair in tp for t in pair]
    loss = TM.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL
    for t, g in zip(leaves, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=TOL, rtol=0)


def test_sgd_momentum_steps_track_jax():
    jp = _jax_params()
    tx = optax.sgd(LR, momentum=0.9)

    @jax.jit
    def train_step(params, opt_state, x, y):  # the JAX workload's step
        loss, grads = jax.value_and_grad(JM.loss_fn)(params, x, y)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    trainer = TM.mnist_trainer({"lr": LR}, SIZES, torch.device("cpu"))
    state = trainer.state_from_params(TM.params_from_jax(jp, "cpu"))
    params, opt = jp, tx.init(jp)
    for x, y in _batches():
        params, opt, jloss = train_step(params, opt, jnp.asarray(x), jnp.asarray(y))
        state, m = trainer.step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(float(m["loss"]) - float(jloss)) <= TOL
    for t, j in zip([t for pair in state.params for t in pair], jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=TOL, rtol=0)


def test_np_accuracy_matches_jax():
    jp = _jax_params()
    rng = np.random.default_rng(3)
    images = rng.random((200, 8, 8)).astype(np.float32)
    labels = rng.integers(0, 10, 200)
    tp = [tuple(t.numpy() for t in pair) for pair in TM.params_from_jax(jp, "cpu")]
    assert TM._np_accuracy(tp, images, labels) == JM._np_accuracy(jp, images, labels)


def test_synthetic_blobs_are_seeded():
    c = TM.synthetic_centroids()
    x0, y0 = TM.synthetic_batch(c, 0, 8)
    x1, y1 = TM.synthetic_batch(c, 0, 8)
    x2, _ = TM.synthetic_batch(c, 1, 8)
    assert x0.dtype == np.float32 and x0.shape == (8, TM.SYNTHETIC_DIM)
    assert np.array_equal(x0, x1) and np.array_equal(y0, y1) and not np.array_equal(x0, x2)
    # each row sits by its class's centroid
    assert np.abs(x0 - c[y0]).max() < 1.0


def test_run_mnist_synthetic_loss_falls():
    run = TM.run_mnist({"steps": 12, "batch_size": 64, "hidden": 32}, device="cpu")
    assert run.steps == 12 and len(run.losses) == 12
    assert all(np.isfinite(run.losses)) and run.losses[-1] < run.losses[0]


def write_digits_fixture(data_dir):
    """sklearn's UCI digits in the idx wire format, as the JAX e2e test
    writes them (1,500 train, 297 test)."""
    from sklearn.datasets import load_digits

    digits = load_digits()
    order = np.random.default_rng(0).permutation(len(digits.target))
    images = (digits.images * (255.0 / 16.0)).astype(np.uint8)[order]
    labels = digits.target.astype(np.uint8)[order]
    data_dir.mkdir(parents=True, exist_ok=True)
    write_idx(str(data_dir / "train-images-idx3-ubyte.gz"), images[:1500])
    write_idx(str(data_dir / "train-labels-idx1-ubyte.gz"), labels[:1500])
    write_idx(str(data_dir / "t10k-images-idx3-ubyte"), images[1500:])
    write_idx(str(data_dir / "t10k-labels-idx1-ubyte"), labels[1500:])
    return data_dir


def test_run_mnist_idx_reaches_jax_target(tmp_path):
    pytest.importorskip("sklearn.datasets")
    d = write_digits_fixture(tmp_path / "digits")
    reported = []

    class Ctx:
        process_id = 0

        def report_eval_metrics(self, step, metrics):
            reported.append((step, metrics))

    run = TM.run_mnist({"data_dir": str(d), "epochs": 30, "batch_size": 128, "hidden": 128,
                        "lr": 0.1, "target_accuracy": 0.95}, device="cpu", ctx=Ctx())
    assert run.steps == 30 * (1500 // 128) and run.test_n == 297
    assert run.accuracy > 0.95
    assert reported == [(run.steps, {"accuracy": run.accuracy})]
