"""The port's elastic seams on the CPU: ``Trainer.reshard_state`` on a
two-rank gloo gang, and the elastic workload in one process.

- ``reshard_state``: a tiny LM steps twice under fsdp 2, then its state
  (params and AdamW moments) is re-laid onto tp 2 and onto dp 2 over the
  same process group. The re-laid leaves, gathered, equal the fsdp 2
  leaves gathered, bit for bit; the next step's loss and pre-clip grad
  norm equal those of a trainer built on the new mesh from the gathered
  state (within the mesh limit of ``tests/test_torch_distributed.py``,
  1e-5; they come out equal). Run as ``python tests/test_torch_elastic.py
  RANK PORT DIR`` the file is one rank of that gang (it imports no jax
  then); the test spawns both ranks at nice 10.
- The elastic workload with a one-member stub context (no resize
  directive): it consumes every window, writes the eval digest of the
  uninterrupted order and, with ``device_state``, the params digest of
  JAX's ``expected_params``; its rows live on the requested device, and a
  member asked for ``cuda`` without a card raises.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
B, T = 4, 16
ATOL = 1e-5
TARGETS = {"tp2": {"tp": 2}, "dp2": {"dp": 2}}


# ---------------------------------------------------------------------------
# one rank of the gang (no jax)
# ---------------------------------------------------------------------------


def _blocks_to_numpy(tree):
    from tf_operator_tpu_torch.compat import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _whole(trainer, tree, mesh):
    """The whole tree (numpy) from every rank's blocks of ``tree``."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.compat import gather_params
    from tf_operator_tpu_torch.models.transformer import transformer_logical_axes

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, _blocks_to_numpy(tree))
    return gather_params(dict(enumerate(got)), mesh, transformer_logical_axes(trainer.cfg))


def _flat(tree) -> list:
    from tf_operator_tpu_torch.train.trainer import _leaves

    return _leaves(tree)


def run_rank(rank: int, port: int, out: Path) -> None:
    import torch.distributed as dist

    from tf_operator_tpu_torch.compat import tree_map
    from tf_operator_tpu_torch.models.transformer import preset
    from tf_operator_tpu_torch.parallel.mesh import build_mesh
    from tf_operator_tpu_torch.train.trainer import OptState, TrainState
    from tf_operator_tpu_torch.workloads.lm import fixed_tokens, lm_trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=timedelta(seconds=120))
    cfg = preset("tiny")
    dev = torch.device("cpu")
    tokens = fixed_tokens(B, T, cfg.vocab, dev)

    def trainer_on(axes):
        mesh = build_mesh(axes, ranks=[0, 1], device_type="cpu")
        tr = lm_trainer({"lr": 3e-3}, cfg, dev, mesh)
        tr.cfg = cfg
        return tr, mesh

    src, src_mesh = trainer_on({"fsdp": 2})
    state = src.init(0)
    for _ in range(2):
        state, _ = src.step(state, src.plan.local_batch(tokens))
    whole_params = _whole(src, state.params, src_mesh)
    whole_mu = _whole(src, state.opt_state["mu"], src_mesh)
    whole_nu = _whole(src, state.opt_state["nu"], src_mesh)
    results = {}
    for name, axes in TARGETS.items():
        dst, dst_mesh = trainer_on(axes)
        moved = dst.reshard_state(state, src.plan)
        leaves_equal = all(
            a.tobytes() == b.tobytes()
            for got, want in ((moved.params, whole_params), (moved.opt_state["mu"], whole_mu),
                              (moved.opt_state["nu"], whole_nu))
            for a, b in zip(_flat(_whole(dst, got, dst_mesh)), _flat(want)))
        # the yardstick: a trainer on the new mesh fed the gathered state
        def shard(tree):
            return dst.shard(tree_map(lambda a: torch.from_numpy(np.array(a)), tree))

        ref = TrainState(
            tree_map(lambda p: p.requires_grad_(True), shard(whole_params)),
            OptState({"count": state.opt_state["count"], "mu": shard(whole_mu),
                      "nu": shard(whole_nu)}, chain=state.opt_state.chain),
            state.step, state.extra)
        batch = dst.plan.local_batch(tokens)
        moved, m = dst.step(moved, batch)
        ref, mr = dst.step(ref, batch)
        results[name] = {"leaves_equal": leaves_equal, "loss": float(m["loss"]),
                         "ref_loss": float(mr["loss"]), "grad_norm": float(m["grad_norm"]),
                         "ref_grad_norm": float(mr["grad_norm"]),
                         "count": moved.opt_state["count"], "step": moved.step,
                         "on_device": all(p.device == dev for p in _flat(moved.params))}
    (out / f"rank{rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_reshard_state_fsdp2_to_tp2_and_dp2(tmp_path):
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import os, runpy, sys; os.nice(10); sys.argv = sys.argv[1:]; "
         "runpy.run_path(sys.argv[0], run_name='__main__')", __file__, str(r), str(port),
         str(tmp_path)], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{text[-4000:]}"
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0] == ranks[1]
    for name, x in ranks[0].items():
        assert x["leaves_equal"], name
        assert x["on_device"] and x["count"] == 3 and x["step"] == 3, x
        assert abs(x["loss"] - x["ref_loss"]) <= ATOL, (name, x)
        assert abs(x["grad_norm"] - x["ref_grad_norm"]) <= ATOL * x["ref_grad_norm"], (name, x)
        assert np.isfinite(x["loss"])


def test_reshard_state_refuses_other_ranks_and_no_mesh():
    from tf_operator_tpu_torch.models.transformer import preset
    from tf_operator_tpu_torch.parallel.mesh import device_mesh
    from tf_operator_tpu_torch.parallel.sharding import MeshPlan
    from tf_operator_tpu_torch.workloads.lm import lm_trainer

    cfg = preset("tiny")
    dev = torch.device("cpu")
    with pytest.raises(ValueError, match="needs a trainer on a mesh"):
        lm_trainer({}, cfg, dev).reshard_state(None, None)
    # layout-only meshes (no process group): one rank here, two there
    tr = lm_trainer({}, cfg, dev, device_mesh(("dp",), np.array([0]), "cpu"))
    there = MeshPlan(device_mesh(("fsdp",), np.array([0, 1]), "cpu"), rank=0)
    with pytest.raises(ValueError, match="not this trainer's"):
        tr.reshard_state(None, there)


class StubCtx:
    """A one-member elastic context: no operator, so no resize directive."""

    def __init__(self, wl: dict) -> None:
        self.workload = wl
        self.job_name, self.namespace = "el", "default"
        self.replica_type, self.replica_index = "Worker", 0
        self.num_processes, self.process_id = 1, 0
        self.resize_epoch = 0
        self.peer_depot, self.restore_peers = "", []
        self.first = []

    def poll_resize_directive(self):
        return None

    def publish_resize_barrier(self, epoch, fields):
        return False

    def record_resize(self, *a):
        pass

    def record_restore(self, *a):
        pass

    def mark_first_step(self, step):
        self.first.append(step)


def test_elastic_workload_one_member_device_state(tmp_path):
    jax_reshard = pytest.importorskip("tf_operator_tpu.train.reshard")
    from tf_operator_tpu.train.data import elastic_global_order as jax_order
    from tf_operator_tpu.workloads.elastic import _digest as jax_digest
    from tf_operator_tpu_torch.workloads import elastic

    total, seed = 24, 5
    wl = {"workdir": str(tmp_path / "gang"), "total_windows": total, "step_sleep_s": 0.0,
          "data_seed": seed, "checkpoint_dir": str(tmp_path / "ckpt"), "checkpoint_every": 8,
          "device_state": True, "device": "cpu", "elastic": True}
    ctx = StubCtx(wl)
    elastic.main(ctx)
    done = json.loads((tmp_path / "gang" / "done.json").read_text())
    order = jax_order(total, seed=seed)
    assert done["digest"] == jax_digest([{"p": p, "w": int(order[p])} for p in range(total)],
                                        total)
    assert done["params_digest"] == jax_reshard.params_digest(
        jax_reshard.expected_params(total, jax_reshard.PARAM_DIM, seed, order))
    assert done["reshard"] == {"relaid": 0, "refetched": 0, "inited": total, "epochs": [0]}
    assert done["device"] == "cpu" and ctx.first == [1]
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path / "ckpt")
                   if n.startswith("step_"))
    assert steps[-1] == total


def test_elastic_member_asked_for_cuda_without_a_card_raises(tmp_path, monkeypatch):
    from tf_operator_tpu_torch.workloads import elastic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = {"workdir": str(tmp_path), "total_windows": 4, "device_state": True}
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic.main(StubCtx(wl))
    assert not (tmp_path / "done.json").exists()


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
