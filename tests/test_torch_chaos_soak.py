"""The chaos soak's light data plane on the port.

``tf_operator_tpu.chaos.soak.run_soak(data_plane="light")`` (unmodified)
runs a two-worker job on three hosts and injects a crash after the first
checkpoint, then a preemption notice to the restarted gang; it gates warm,
monotonic resumes, the applied fault sequence, the preemption's recovery
window, no duplicate gang-member creates and the restart's goodput
accounting. The soak module's ``ProcessTemplate``, ``Store`` and
``LocalProcessControl`` are swapped for the test as in
``tests/test_torch_elastic_soak.py``: the members run the port's
``tf_operator_tpu_torch.workloads.soak:main`` on the CPU at nice 10.

One case is sized for tier-1 (shorter steps); the settings of
``tests/test_chaos_soak.py`` run as a second case, marked ``slow`` and
``chaos`` as the JAX package's are.
"""

import pytest

from test_torch_elastic_soak import port_soak  # noqa: F401 (fixture)

pytestmark = pytest.mark.e2e

SEED = 7


def _check(r):
    errors = r.check()
    assert not errors, (f"{errors}\nresult: restarts={r.restart_count} "
                        f"preemptions={r.preemption_count} resume={r.resume_steps} "
                        f"applied={r.applied} conditions={r.conditions}")
    assert r.restart_count >= 1 and r.preemption_count >= 1
    assert max(r.resume_steps) > 0


def _port_logs(workdir) -> str:
    return "".join(p.read_text() for p in (workdir / "logs").glob("*.log"))


def test_port_light_soak_recovers_warm(port_soak, tmp_path):  # noqa: F811
    r = port_soak.run_soak(seed=SEED, steps=8, checkpoint_every=2, backoff_limit=2,
                           step_sleep_s=0.4, workdir=str(tmp_path), timeout=240.0)
    _check(r)
    logs = _port_logs(tmp_path)
    assert "resumed from checkpoint at step" in logs
    assert "soak workload done: steps=8" in logs


@pytest.mark.slow
@pytest.mark.chaos
def test_port_light_soak_at_chaos_soak_settings(port_soak, tmp_path):  # noqa: F811
    r = port_soak.run_soak(seed=SEED, steps=8, checkpoint_every=2, backoff_limit=2,
                           workdir=str(tmp_path), timeout=420.0)
    _check(r)
    assert r.restart_count <= 2
