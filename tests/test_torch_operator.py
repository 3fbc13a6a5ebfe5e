"""The port's workloads launched by the real operator on the CPU.

Each job goes through the whole control plane: submit to the store, the
controller reconciles it, the local process backend launches the real
harness (``python -m tf_operator_tpu.rendezvous.harness``), which resolves
the port's entrypoint and calls it; the job must reach Succeeded. The jobs
are tiny and run with ``device: cpu``: the LM trainer, the ResNet trainer,
the serving workload, and a phoenix job that checkpoints every 2 steps,
dies retryably (exit 138) at step 4 of its first incarnation, is
gang-restarted by the controller and resumes from its checkpoint. Three
two-process gangs over gloo: the port's smoke job as
``examples/smoke_local_cpu_torch.json`` ships it, a tiny LM under
``{"fsdp": 2}``, and a tiny LM under ``{"dp": 2}`` whose rank 1 dies at
step 3 of its first incarnation, after its gang's step-2 checkpoint:
rank 0 sees the lost peer and exits 138, the controller restarts the
gang, which resumes warm from step 2 and trains to the end; and a tiny
LM pipelined under ``{"pp": 2}`` (1f1b, 2 microbatches) that
checkpoints every 2 steps; and the port's MNIST as two-process dp gangs:
``examples/mnist_dp_h100.json`` on the CPU (a coordinator and a worker,
synthetic blobs) and two workers on an idx fixture of sklearn's digits,
trained to the JAX e2e test's 0.95 accuracy target. All are
submitted at once to one operator (a module fixture); each test waits
for its own.
"""

import json
import os
import sys

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
    "OMP_NUM_THREADS": "1",
}
# The harness as the local backend launches it, at nice 10: on a loaded
# host the jobs yield the cores to the other test files.
NICE_HARNESS = ("import os, runpy, sys\nos.nice(10)\nsys.argv[1:] = sys.argv[2:]\n"
                "runpy.run_module('tf_operator_tpu.rendezvous.harness', run_name='__main__', "
                "alter_sys=True)\n")


def _niced_command(process):
    return [sys.executable, "-c", NICE_HARNESS, "--", *process.spec.args]
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
    # the evaluator needs a few seconds to start; the trainer's 800 steps
    # (~10-15 ms each) keep the chief alive long after its first checkpoint,
    # and keeping all 8 checkpoints leaves step 100 on disk however late
    # the evaluator's first scan comes
    "port-lm-eval": ("tf_operator_tpu_torch.workloads.lm:main",
                     {**LM, "steps": 800, "seq_len": 32, "data": "memmap",
                      "holdout_windows": 8, "checkpoint_every": 100, "checkpoint_keep": 8,
                      "train_steps": 100,
                      "eval_batch_size": 2, "eval_seq_len": 32, "eval_batches": 2,
                      "poll_interval_s": 0.2, "max_wait_s": 120}),
    "port-eval-only": ("tf_operator_tpu_torch.workloads.eval:main",
                       {"preset": "tiny", "eval_batch_size": 2, "eval_seq_len": 16,
                        "eval_batches": 1, "poll_interval_s": 0.1, "max_wait_s": 60,
                        "device": "cpu"}),
}
EVAL_ENTRY = "tf_operator_tpu_torch.workloads.eval:main"
# two-process gangs: (entrypoint, workload, mesh axes)
GANG_LM = {**LM, "batch_size": 4}
GANGS = {
    "port-lm-fsdp2": ("tf_operator_tpu_torch.workloads.lm:main", GANG_LM, {"fsdp": 2}),
    "port-lm-peer-loss": ("tf_operator_tpu_torch.workloads.lm:main",
                          {**GANG_LM, "steps": 6, "fail_at_step": 3, "fail_rank": 1,
                           "checkpoint_every": 2},
                          {"dp": 2}),
    "port-lm-pp": ("tf_operator_tpu_torch.workloads.lm:main",
                   {**GANG_LM, "pp_microbatches": 2, "checkpoint_every": 2}, {"pp": 2}),
}


MNIST_ENTRY = "tf_operator_tpu_torch.workloads.mnist:main"
# the JAX e2e test's real-data job (tests/test_e2e_local.py)
MNIST_IDX_WL = {"epochs": 30, "batch_size": 128, "hidden": 128, "lr": 0.1,
                "target_accuracy": 0.95, "device": "cpu"}


def _digits(d):
    """sklearn's digits as idx files, as the JAX e2e test writes them."""
    from test_torch_mnist import write_digits_fixture

    return write_digits_fixture(d)


def _prepare(tmp):
    """The memmapped corpus and the eval-only job's checkpoints (the port's
    tiny LM after 2 steps)."""
    import torch

    from tf_operator_tpu_torch.models import transformer as tt
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.data import write_token_corpus
    from tf_operator_tpu_torch.train.trainer import Trainer, TrainerConfig

    write_token_corpus(str(tmp / "corpus.bin"),
                       np.random.default_rng(0).integers(0, 256, 64 * 32))
    cfg = tt.preset("tiny")
    trainer = Trainer(loss_fn=lambda p, tok, e: tt.lm_loss(p, tok, cfg),
                      init_fn=lambda g: tt.init_transformer(cfg, g, "cpu"),
                      config=TrainerConfig(), device="cpu")
    state = trainer.init(0)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 16)))
    for _ in range(2):
        state, _ = trainer.step(state, tokens)
    CheckpointManager(str(tmp / "eval-only-ckpt")).save(2, state, wait=True)


@pytest.fixture(scope="module")
def operator(tmp_path_factory):
    """One operator with the local backend; every job submitted at once.
    Yields (store, log dir, phoenix checkpoint dir, phoenix marker)."""
    tmp = tmp_path_factory.mktemp("port-operator")
    store = Store()
    pc = LocalProcessControl(store, log_dir=str(tmp / "logs"), command_builder=_niced_command)
    ctl = TPUJobController(store, pc, resync_period=0.5)
    ctl.run(workers=4)
    ckpt, marker = str(tmp / "ckpt"), str(tmp / "died-once")
    _prepare(tmp)
    try:
        for name, (entry, wl) in JOBS.items():
            env = PORT_ENV
            replicas = {ReplicaType.WORKER: ReplicaSpec(
                replicas=1, template=ProcessTemplate(entrypoint=entry, env=dict(env)))}
            if name == "port-lm-eval":
                replicas[ReplicaType.EVALUATOR] = ReplicaSpec(
                    replicas=1, template=ProcessTemplate(entrypoint=EVAL_ENTRY, env=dict(env)))
            job = TPUJob(metadata=ObjectMeta(name=name),
                         spec=TPUJobSpec(replica_specs=replicas))
            job.spec.workload = dict(wl)
            if name == "port-phoenix":
                job.spec.workload.update(checkpoint_dir=ckpt, fail_marker=marker)
            elif name == "port-lm-eval":
                job.spec.workload.update(checkpoint_dir=str(tmp / "lm-eval-ckpt"),
                                         corpus=str(tmp / "corpus.bin"),
                                         eval_report=str(tmp / "lm-eval-report.json"))
            elif name == "port-eval-only":
                job.spec.workload.update(checkpoint_dir=str(tmp / "eval-only-ckpt"),
                                         eval_report=str(tmp / "eval-only-report.json"))
            store.create(job)
        with open(os.path.join(ROOT, "examples", "smoke_local_cpu_torch.json")) as f:
            smoke = TPUJob.from_dict(json.load(f))
        smoke.spec.replica_specs[ReplicaType.WORKER].template.env.update(PORT_ENV)
        store.create(smoke)
        for name, (entry, wl, axes) in GANGS.items():
            job = TPUJob(metadata=ObjectMeta(name=name), spec=TPUJobSpec(replica_specs={
                ReplicaType.WORKER: ReplicaSpec(replicas=2, template=ProcessTemplate(
                    entrypoint=entry, env=dict(PORT_ENV)))}))
            job.spec.workload = dict(wl)
            if "fail_at_step" in wl:
                job.spec.workload["fail_marker"] = str(tmp / f"{name}-died-once")
            if "checkpoint_every" in wl:
                job.spec.workload["checkpoint_dir"] = str(tmp / f"{name}-ckpt")
            job.spec.topology.mesh_axes = dict(axes)
            store.create(job)
        with open(os.path.join(ROOT, "examples", "mnist_dp_h100.json")) as f:
            mnist = TPUJob.from_dict(json.load(f))
        mnist.metadata.name = "port-mnist-dp"
        mnist.spec.workload["device"] = "cpu"  # the CPU variant of the card's twin
        for spec in mnist.spec.replica_specs.values():
            spec.template.env.update(PORT_ENV)
        store.create(mnist)
        job = TPUJob(metadata=ObjectMeta(name="port-mnist-idx"), spec=TPUJobSpec(
            replica_specs={ReplicaType.WORKER: ReplicaSpec(replicas=2, template=ProcessTemplate(
                entrypoint=MNIST_ENTRY, env=dict(PORT_ENV)))}))
        job.spec.workload = {**MNIST_IDX_WL, "data_dir": str(_digits(tmp / "digits"))}
        store.create(job)
        yield store, tmp / "logs", ckpt, marker, tmp
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
    store, logs = operator[:2]
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

    store, logs, ckpt, marker, _ = operator
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


def test_port_lm_job_with_evaluator_replica(operator):
    """The Worker trains on the memmapped corpus and checkpoints every 100
    steps; the Evaluator replica, outside the gang, scores the first
    checkpoint on the corpus's holdout while the trainer runs on, and the
    job reaches Succeeded (the chief's success)."""
    store, logs, _, _, tmp = operator
    st, text = _succeeded(store, "port-lm-eval", logs)
    assert "lm done: preset=tiny" in text
    eval_log = (logs / "default_port-lm-eval-evaluator-0.log").read_text()
    assert "eval: checkpoint step=100 loss=" in eval_log, eval_log[-3000:]
    scored = json.loads((tmp / "lm-eval-report.json").read_text())
    assert list(scored)[0] == "100" and all(np.isfinite(v) for v in scored.values())


def test_port_eval_only_job_scores_existing_checkpoints(operator):
    store, logs, _, _, tmp = operator
    st, text = _succeeded(store, "port-eval-only", logs)
    assert "eval done: 1 checkpoints scored" in text
    scored = json.loads((tmp / "eval-only-report.json").read_text())
    assert list(scored) == ["2"] and np.isfinite(scored["2"])


def test_port_smoke_example_gang_succeeds(operator):
    """examples/smoke_local_cpu_torch.json: two workers over gloo; the
    chief's checksum is 2 * 64^3, so both ranks' blocks were summed. (The
    job succeeds with its chief and the controller then deletes rank 1,
    which may not have logged its own line yet: its log is read for the
    gang it joined.)"""
    store, logs = operator[:2]
    st, text = _succeeded(store, "smoke-torch", logs)
    assert st.restart_count == 0
    assert "smoke ok: 2 devices, checksum 524288 (rank 0" in text
    rank1 = (logs / "default_smoke-torch-worker-1.log").read_text()
    assert "joined the gang: rank 1 of 2, backend gloo on cpu" in rank1


def test_port_two_process_fsdp_lm_succeeds(operator):
    """A tiny LM gang under {"fsdp": 2}: rank 0 logs the lm done line with
    the mesh, every rank its lm rank line, each with the same losses."""
    store, logs = operator[:2]
    st, text = _succeeded(store, "port-lm-fsdp2", logs)
    assert st.restart_count == 0
    assert "lm done: preset=tiny" in text and "mesh={'fsdp': 2}" in text
    rank1 = (logs / "default_port-lm-fsdp2-worker-1.log").read_text()
    assert "lm done" not in rank1
    lines = [json.loads(t.split("lm rank: ", 1)[1].splitlines()[0]) for t in (text, rank1)]
    assert [x["rank"] for x in lines] == [0, 1]
    assert lines[0]["losses"] == lines[1]["losses"] and len(lines[0]["losses"]) == 4
    assert all(np.isfinite(lines[0]["losses"])) and lines[0]["collective_calls"] > 0


def test_port_pipelined_lm_gang_succeeds(operator):
    """A tiny LM pipelined over {"pp": 2} (one layer a stage): both ranks
    log the same losses and the pipeline's figures (1f1b, 2 microbatches,
    2·(2 + 2 - 1) ticks a step), and its checkpoints commit (steps 2 and
    the final 4), each rank writing its stage's layer blocks."""
    store, logs = operator[:2]
    tmp = operator[4]
    st, text = _succeeded(store, "port-lm-pp", logs)
    assert st.restart_count == 0
    assert "lm done: preset=tiny" in text and "mesh={'pp': 2}" in text
    rank1 = (logs / "default_port-lm-pp-worker-1.log").read_text()
    lines = [json.loads(t.split("lm rank: ", 1)[1].splitlines()[0]) for t in (text, rank1)]
    assert lines[0]["losses"] == lines[1]["losses"] and all(np.isfinite(lines[0]["losses"]))
    for x in lines:
        assert x["pipeline"] == {"schedule": "1f1b", "microbatches": 2, "chunks": 1,
                                 "stages": 2, "ticks_per_step": 6,
                                 "bubble_fraction": 1 / 3}, x["pipeline"]
    ckpt = tmp / "port-lm-pp-ckpt"
    assert sorted(n for n in os.listdir(ckpt) if n.startswith("step_")) == ["step_2", "step_4"]
    manifest = json.loads((ckpt / "step_4" / "manifest.json").read_text())
    wq = next(r for r in manifest["leaves"] if r["path"] == "['params']['layers']['wq']")
    assert wq["placement"][0] == "pp" and sorted(b["rank"] for b in wq["blocks"]) == [0, 1]


def test_port_gang_survives_a_lost_peer(operator):
    """Rank 1 dies at step 3 of the first incarnation, after the gang's
    step-2 save committed; rank 0's next collective finds the peer gone and
    it exits 138 (not a hang, not a permanent failure); the controller
    restarts the gang with the step it finds on disk stamped into
    TPUJOB_RESUME_STEP, both ranks resume warm from that step, and the
    gang trains to the end (step 7), its last step a sharded step of a
    world of 2 as the JAX package's readers see it."""
    from tf_operator_tpu.train.checkpoint import checkpoint_world_size, latest_checkpoint_step

    store, logs, _, _, tmp = operator
    st, text = _succeeded(store, "port-lm-peer-loss", logs)
    assert st.restart_count >= 1
    rank1 = (logs / "default_port-lm-peer-loss-worker-1.log").read_text()
    assert "fault injection: requesting retry at step 3" in rank1
    assert "lost a peer of the gang (retryable)" in text
    for log_text in (text, rank1):
        assert "warm restart: controller-declared resume step 2" in log_text
        assert "resumed from checkpoint at step 2" in log_text
    assert "lm done: preset=tiny" in text
    ckpt = str(tmp / "port-lm-peer-loss-ckpt")
    assert latest_checkpoint_step(ckpt) == 7 and checkpoint_world_size(ckpt, 7) == 2


def test_port_mnist_example_gang_succeeds(operator):
    """examples/mnist_dp_h100.json on the CPU: the coordinator and the
    worker over gloo, 30 synthetic steps at batch 256, the loss falling
    (the workload raises otherwise), both ranks in one gang."""
    store, logs = operator[:2]
    ok = wait_for(lambda: has_condition(store.get("TPUJob", "default", "port-mnist-dp").status,
                                        ConditionType.SUCCEEDED), timeout=180)
    st = store.get("TPUJob", "default", "port-mnist-dp").status
    coord = logs / "default_port-mnist-dp-coordinator-0.log"
    text = coord.read_text() if coord.exists() else ""
    assert ok, f"{[(c.type.value, c.reason, c.message) for c in st.conditions]}\n{text[-3000:]}"
    assert st.restart_count == 0
    assert "mnist done (synthetic): loss" in text and "over 30 steps" in text
    assert "joined the gang: rank 0 of 2, backend gloo on cpu" in text


def test_port_mnist_idx_gang_reaches_accuracy(operator):
    """Two workers read disjoint strides of the digits' idx files, train
    data-parallel and reach the JAX e2e test's 0.95 test accuracy (the
    workload's own gate fails the job below it)."""
    store, logs = operator[:2]
    st, text = _succeeded(store, "port-mnist-idx", logs)
    acc = float(text.split("mnist done (real data): test accuracy ")[1].split()[0])
    assert acc > 0.95 and "over 297 examples (30 epochs" in text
    rank1 = (logs / "default_port-mnist-idx-worker-1.log").read_text()
    assert "joined the gang: rank 1 of 2, backend gloo on cpu" in rank1
