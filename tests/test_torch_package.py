"""The PyTorch port as a package: it stands alone (no JAX, nothing of the
JAX package), its entry points default to the card and refuse to run
without one, and parameters cross between the two packages bit for bit."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tf_operator_tpu.models.transformer import (  # noqa: E402
    init_transformer as jax_init,
    preset as jax_preset,
)
from tf_operator_tpu_torch import compat  # noqa: E402
from tf_operator_tpu_torch.device import resolve_device  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tf_operator_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_and_chip_smoke_import_no_jax():
    """Every port module, and chip_smoke.py with all it imports, load in a
    fresh interpreter without pulling in jax or tf_operator_tpu."""
    mods = _port_modules()
    assert "tf_operator_tpu_torch.serve.engine" in mods
    for m in ("train.reshard", "workloads.elastic", "workloads.soak", "workloads.mnist"):
        assert f"tf_operator_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax')\n"
        "             or m == 'tf_operator_tpu' or m.startswith('tf_operator_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_no_jax_import():
    """No port source has an import statement for jax or the JAX package,
    not even one that a test run would not reach."""
    offenders = []
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                if mod == "jax" or mod.startswith("jax.") or mod == "tf_operator_tpu" \
                        or mod.startswith("tf_operator_tpu."):
                    offenders.append(f"{path.relative_to(ROOT)}:{n}: {s}")
    assert offenders == []


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    from tf_operator_tpu_torch.workloads.serve import run_serve

    # the workload's device key defaults to cuda: no quiet CPU run
    with pytest.raises(RuntimeError, match="CUDA"):
        run_serve({"preset": "tiny", "requests": 1})
    from tf_operator_tpu_torch.workloads.mnist import run_mnist

    with pytest.raises(RuntimeError, match="CUDA"):
        run_mnist({"steps": 2})


def test_cpu_device_and_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_params_round_trip_bit_for_bit():
    cfg = jax_preset("tiny")
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))
    tp = compat.params_from_numpy(jp, "cpu")
    assert set(tp) == {"embed", "final_norm", "layers"}
    assert set(tp["layers"]) == {
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down",
    }
    back = compat.params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b) == 11
    for path, a in flat_j:
        b = flat_b[path]
        assert b.dtype == a.dtype and b.shape == a.shape
        assert a.tobytes() == b.tobytes(), path
    # the copy never aliases the caller's arrays
    tp["embed"].zero_()
    assert np.abs(jp["embed"]).sum() > 0
