"""The operator's own elastic soaks, run on the port's data plane.

``tf_operator_tpu.chaos.soak.run_elastic_soak`` (unmodified) launches an
elastic job of three one-member hosts, kills and returns members on a
seeded schedule, and gates the result: the job succeeds with no full
gang restart, every kill shrinks and every return re-grows, the eval
digest and (``device_state``) the final params are bit-identical to the
uninterrupted run's (JAX's ``expected_params``), the re-shard both
re-laid and re-fetched rows, and a re-grown member restored from a
peer's shard depot. Here three names in the soak module are swapped for
the test (``monkeypatch``; the JAX file stays as it is):

- ``ProcessTemplate``: the JAX workloads' entrypoints map to the port's
  (``tf_operator_tpu_torch.workloads.elastic:main``), one thread a member;
- ``Store``: ``create`` adds ``"device": "cpu"`` to a TPUJob's workload;
- ``LocalProcessControl``: members run at nice 10, as in
  ``tests/test_torch_operator.py``, so a loaded host gives the other
  test files the cores.

The default soak runs in tier-1; ``run_elastic_general_soak`` (a drain
during a shrink under a queue quota, and growth beyond spec) is the same
at full size, marked ``slow``.
"""

import dataclasses
import functools
import sys

import pytest

from tf_operator_tpu.api.types import ProcessTemplate
from tf_operator_tpu.chaos import soak as chaos_soak
from tf_operator_tpu.runtime import LocalProcessControl, Store

pytestmark = pytest.mark.e2e

PORT_ENTRYPOINTS = {
    "tf_operator_tpu.workloads.elastic:main": "tf_operator_tpu_torch.workloads.elastic:main",
    "tf_operator_tpu.workloads.soak:main": "tf_operator_tpu_torch.workloads.soak:main",
}
NICE_HARNESS = ("import os, runpy, sys\nos.nice(10)\nsys.argv[1:] = sys.argv[2:]\n"
                "runpy.run_module('tf_operator_tpu.rendezvous.harness', run_name='__main__', "
                "alter_sys=True)\n")


def port_template(**kwargs):
    """The soak's ProcessTemplate with the port's entrypoint in place of
    the JAX workload's."""
    tmpl = ProcessTemplate(**kwargs)
    if tmpl.entrypoint in PORT_ENTRYPOINTS:
        tmpl = dataclasses.replace(tmpl, entrypoint=PORT_ENTRYPOINTS[tmpl.entrypoint],
                                   env={**tmpl.env, "OMP_NUM_THREADS": "1"})
    return tmpl


class CpuStore(Store):
    """A Store whose TPUJobs run their workloads on the CPU."""

    def create(self, obj):
        if type(obj).__name__ == "TPUJob" and obj.spec.workload is not None:
            obj.spec.workload = {**obj.spec.workload, "device": "cpu"}
        return super().create(obj)


def _niced_command(process):
    return [sys.executable, "-c", NICE_HARNESS, "--", *process.spec.args]


@pytest.fixture
def port_soak(monkeypatch):
    """tf_operator_tpu.chaos.soak with the port's data plane swapped in."""
    monkeypatch.setattr(chaos_soak, "ProcessTemplate", port_template)
    monkeypatch.setattr(chaos_soak, "Store", CpuStore)
    monkeypatch.setattr(chaos_soak, "LocalProcessControl",
                        functools.partial(LocalProcessControl, command_builder=_niced_command))
    return chaos_soak


def _summary(r) -> str:
    return (f"restarts={r.restart_count} preemptions={r.preemption_count} "
            f"resizes={r.resize_count} history={r.resize_history} "
            f"restores={r.restore_sources} plan={r.reshard_plan} applied={r.applied} "
            f"conditions={r.conditions}")


def _check_port_run(r, workdir):
    errors = r.check()
    assert not errors, f"{errors}\n{_summary(r)}"
    assert r.params_digest == r.expected_params_digest
    # the members ran the port's entrypoint, with their rows on the CPU
    logs = "".join(p.read_text() for p in (workdir / "logs").glob("*.log"))
    assert '"device_state": true, "device": "cpu"' in logs, logs[-3000:]


def test_port_elastic_soak_device_state(port_soak, tmp_path):
    """run_elastic_soak(device_state=True) at its defaults on the port."""
    r = port_soak.run_elastic_soak(device_state=True, workdir=str(tmp_path))
    _check_port_run(r, tmp_path)
    assert int(r.reshard_plan["relaid"]) >= 1 and int(r.reshard_plan["refetched"]) >= 1
    assert r.peer_restores >= 1 and r.restart_count == 0


@pytest.mark.slow
def test_port_elastic_general_soak(port_soak, tmp_path):
    """The elastic-general gate on the port: the device-state soak, a drain
    during a shrink under a queue quota, and growth beyond spec."""
    device, drain, grow = port_soak.run_elastic_general_soak(workdir=str(tmp_path))
    for r in (device, drain):
        assert not r.check(), f"{r.check()}\n{_summary(r)}"
    assert not grow.check(), grow.check()
