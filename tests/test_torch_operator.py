"""The port's workloads launched by the real operator on the CPU.

Each job goes through the whole control plane: submit to the store, the
controller reconciles it, the local process backend launches the real
harness (``python -m tf_operator_tpu.rendezvous.harness``), which resolves
the port's entrypoint and calls it; the job must reach Succeeded. The jobs
are tiny and run with ``device: cpu``: the LM trainer, the ResNet trainer,
the serving workload, and a phoenix job that checkpoints every 2 steps,
dies retryably (exit 138) at step 4 of its first incarnation, is
gang-restarted by the controller and resumes from its checkpoint. All four
are submitted at once to one operator (a module fixture); each test waits
for its own.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.e2e

from tf_operator_tpu.api.types import (  # noqa: E402
    ConditionType,
    ObjectMeta,
    ProcessTemplate,
    ReplicaSpec,
    ReplicaType,
    TPUJob,
    TPUJobSpec,
)
from tf_operator_tpu.controller import TPUJobController  # noqa: E402
from tf_operator_tpu.controller.status import has_condition  # noqa: E402
from conftest import wait_for  # noqa: E402
from tf_operator_tpu.runtime import LocalProcessControl, Store  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ENV = {
    "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
    "OMP_NUM_THREADS": "2",
}
LM = {"preset": "tiny", "steps": 3, "batch_size": 2, "seq_len": 16, "device": "cpu"}
JOBS = {
    "port-lm": ("tf_operator_tpu_torch.workloads.lm:main", LM),
    "port-resnet": ("tf_operator_tpu_torch.workloads.resnet:main",
                    {"variant": "tiny", "num_classes": 10, "steps": 3, "batch_size": 2,
                     "image_size": 32, "lr": 0.05, "device": "cpu"}),
    "port-serve": ("tf_operator_tpu_torch.workloads.serve:main",
                   {"preset": "tiny", "requests": 3, "prompt_len": 5, "max_new_tokens": 3,
                    "arrival_rate": 0, "kv_page_size": 8, "kv_pool_pages": 32,
                    "max_slots": 2, "prefill_chunk": 8, "seed": 1, "device": "cpu"}),
    "port-phoenix": ("tf_operator_tpu_torch.workloads.lm:main",
                     {**LM, "steps": 6, "checkpoint_every": 2, "fail_at_step": 4}),
}


@pytest.fixture(scope="module")
def operator(tmp_path_factory):
    """One operator with the local backend; every job submitted at once.
    Yields (store, log dir, phoenix checkpoint dir, phoenix marker)."""
    tmp = tmp_path_factory.mktemp("port-operator")
    store = Store()
    pc = LocalProcessControl(store, log_dir=str(tmp / "logs"))
    ctl = TPUJobController(store, pc, resync_period=0.5)
    ctl.run(workers=4)
    ckpt, marker = str(tmp / "ckpt"), str(tmp / "died-once")
    try:
        for name, (entry, wl) in JOBS.items():
            job = TPUJob(
                metadata=ObjectMeta(name=name),
                spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: ReplicaSpec(
                    replicas=1,
                    template=ProcessTemplate(entrypoint=entry, env=dict(PORT_ENV)))}),
            )
            job.spec.workload = dict(wl)
            if name == "port-phoenix":
                job.spec.workload.update(checkpoint_dir=ckpt, fail_marker=marker)
            store.create(job)
        yield store, tmp / "logs", ckpt, marker
    finally:
        ctl.stop()
        pc.shutdown()


def _succeeded(store, name, logs):
    ok = wait_for(lambda: has_condition(store.get("TPUJob", "default", name).status,
                                        ConditionType.SUCCEEDED), timeout=180)
    st = store.get("TPUJob", "default", name).status
    log_path = logs / f"default_{name}-worker-0.log"
    text = log_path.read_text() if log_path.exists() else ""
    assert ok, (f"conditions: {[(c.type.value, c.reason, c.message) for c in st.conditions]}"
                f"\n{text[-3000:]}")
    assert not has_condition(st, ConditionType.FAILED)
    return st, text


@pytest.mark.parametrize("name,done", [("port-lm", "lm done: preset=tiny"),
                                       ("port-resnet", "resnet done: loss="),
                                       ("port-serve", "requests=3/3")])
def test_port_job_succeeds_through_operator(operator, name, done):
    store, logs, _, _ = operator
    st, text = _succeeded(store, name, logs)
    assert st.restart_count == 0
    assert done in text


def test_port_phoenix_job_resumes_warm_after_gang_restart(operator):
    """Exit 138 at step 4, a gang restart, a resume from step 4, the budget
    finished (6 timed steps and the warmup: step 7), as the JAX package's
    own reader sees it; and the JAX CheckpointManager restores the port's
    last step into a JAX template, leaf for leaf the port's restore."""
    jax = pytest.importorskip("jax")
    torch = pytest.importorskip("torch")
    from tf_operator_tpu.models import transformer as jt
    from tf_operator_tpu.parallel import build_mesh
    from tf_operator_tpu.train.checkpoint import CheckpointManager as JaxManager
    from tf_operator_tpu.train.checkpoint import latest_checkpoint_step
    from tf_operator_tpu.train.trainer import Trainer as JaxTrainer
    from tf_operator_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager, _flatten, _to_tree
    from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig

    store, logs, ckpt, marker = operator
    st, text = _succeeded(store, "port-phoenix", logs)
    assert os.path.exists(marker) and st.restart_count >= 1
    assert "fault injection: requesting retry at step 4" in text
    assert "resumed from checkpoint at step 4" in text
    assert latest_checkpoint_step(ckpt) == 7
    mesh = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jcfg = jt.preset("tiny")
    jtr = JaxTrainer(mesh, loss_fn=None, init_fn=lambda k: jt.init_transformer(k, jcfg),
                     config=JaxTrainerConfig(learning_rate=3e-4))
    js = JaxManager(ckpt, backend="npy").restore(jtr.state_template())
    assert int(js.step) == 7
    tcfg = tt.preset("tiny")
    port = Trainer(loss_fn=None, init_fn=lambda g: tt.init_transformer(tcfg, g, "cpu"),
                   config=TrainerConfig(), device="cpu")
    ps = CheckpointManager(ckpt, readonly=True).restore(port.state_template(), device="cpu")
    want = [x for _, x in _flatten(_to_tree(ps))]
    got = jax.tree_util.tree_leaves({"params": js.params, "opt_state": js.opt_state,
                                     "step": js.step, "extra": js.extra})
    assert len(got) == len(want)
    for w, g in zip(want, got):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert np.array_equal(w, np.asarray(g))
