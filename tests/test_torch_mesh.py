"""The port's mesh layer against the JAX package's, with no process started.

- ``MeshSpec`` raises the JAX package's errors; the rank arrays of
  ``build_mesh`` (canonical order), of the job context's mesh (the spec's
  insertion order) and of ``build_hybrid_mesh`` are the device ids of the
  JAX package's ``Mesh`` over its eight CPU devices (tests/conftest.py).
- Each leaf's placement under ``DEFAULT_RULES`` is JAX's ``PartitionSpec``
  for every leaf of ``transformer_logical_axes(tiny)``, and the batch's;
  every leaf of ``resnet_logical_axes`` is replicated, as in JAX.
- ``shard_params`` then ``gather_params`` gives the input back bitwise.
- The rendezvous helpers: backend choice, the one-card-a-process rule,
  the peer-loss mapping to exit 138, and the raises that remain.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tf_operator_tpu.models import transformer as jt  # noqa: E402
from tf_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from tf_operator_tpu.parallel import sharding as jsharding  # noqa: E402
from tf_operator_tpu.rendezvous.context import JobContext  # noqa: E402
from tf_operator_tpu_torch import compat  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tt  # noqa: E402
from tf_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from tf_operator_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from tf_operator_tpu_torch.rendezvous import context as rdv  # noqa: E402

N = 8


def _ids(jax_mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(jax_mesh.devices)


@pytest.mark.parametrize("axes,n", [({"dp": -1, "tp": -1}, 8), ({"dp": 3, "tp": -1}, 8),
                                    ({"dp": 2, "tp": 2}, 8), ({"fsdp": 16}, 8)])
def test_mesh_spec_errors_match_jax(axes, n):
    with pytest.raises(ValueError) as want:
        jmesh.MeshSpec(axes).resolve(n)
    with pytest.raises(ValueError) as got:
        tmesh.MeshSpec(axes).resolve(n)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axes", [{}, {"dp": 8}, {"tp": 2, "dp": 2, "fsdp": 2},
                                  {"fsdp": -1, "tp": 2}, {"tp": 4, "pp": 2},
                                  {"ep": 2, "cp": 2, "dp": 2}, {"replica": 2, "tp": 4}])
def test_build_mesh_ranks_match_jax_devices(axes):
    want = jmesh.build_mesh(axes, devices=jax.devices())
    names, ranks = tmesh.mesh_ranks(axes, range(N))
    assert names == tuple(want.axis_names)
    np.testing.assert_array_equal(ranks, _ids(want))
    got = tmesh.build_mesh(axes, ranks=range(N))
    assert tuple(got.mesh_dim_names) == names
    np.testing.assert_array_equal(got.mesh.numpy(), _ids(want))
    assert tmesh.mesh_shape(got) == dict(want.shape)


@pytest.mark.parametrize("ici,dcn", [({"fsdp": 2, "tp": 2}, {"dp": 2}),
                                     ({"dp": 2, "tp": 2}, {"dp": 2}),
                                     ({"dp": 2, "fsdp": 2}, {"fsdp": 2}),
                                     ({"tp": 4}, {"pp": 2})])
def test_hybrid_mesh_ranks_match_jax_devices(ici, dcn):
    want = jmesh.build_hybrid_mesh(ici, dcn, devices=jax.devices())
    got = tmesh.build_hybrid_mesh(ici, dcn, ranks=range(N))
    assert tuple(got.mesh_dim_names) == tuple(want.axis_names)
    np.testing.assert_array_equal(got.mesh.numpy(), _ids(want))
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        tmesh.hybrid_mesh_ranks({**ici, "cp": 2}, dcn, range(N))


@pytest.mark.parametrize("axes,dcn", [({"tp": 2, "dp": 4}, {}), ({"fsdp": 2, "dp": 2, "tp": 2}, {}),
                                      ({}, {}), ({"fsdp": 2, "tp": 2}, {"dp": 2})])
def test_context_mesh_keeps_the_spec_order(axes, dcn):
    """The job context's mesh: the spec's insertion order (not canonical),
    or the hybrid mesh with dcn axes, as the JAX JobContext builds it."""
    want = JobContext(num_processes=N, mesh_axes=axes, dcn_mesh_axes=dcn).build_mesh()
    ctx = type("Ctx", (), {"num_processes": N, "mesh_axes": axes, "dcn_mesh_axes": dcn})()
    got = rdv.build_mesh(ctx, "cpu")
    assert tuple(got.mesh_dim_names) == tuple(want.axis_names)
    np.testing.assert_array_equal(got.mesh.numpy(), _ids(want))


MESHES = [{"dp": 2, "fsdp": 2, "tp": 2}, {"fsdp": 4, "tp": 2}, {"dp": 8}, {"tp": 8},
          {"fsdp": 2, "cp": 2, "tp": 2}]


@pytest.mark.parametrize("axes", MESHES)
def test_placements_match_jax_partition_specs(axes):
    """Every leaf of transformer_logical_axes(tiny) and the batch: the
    port's placement is JAX's PartitionSpec under DEFAULT_RULES (axes the
    mesh lacks dropped)."""
    jm = jmesh.build_mesh(axes, devices=jax.devices())
    tm = tmesh.build_mesh(axes, ranks=range(N))
    cfg_j, cfg_t = jt.preset("tiny"), tt.preset("tiny")
    assert tt.transformer_logical_axes(cfg_t) == jt.transformer_logical_axes(cfg_j)
    want = jax.tree_util.tree_map(
        lambda la: tuple(jsharding.DEFAULT_RULES.sharding(jm, list(la)).spec),
        jt.transformer_logical_axes(cfg_j), is_leaf=lambda x: isinstance(x, tuple))
    got = tsharding.placements(tm, tt.transformer_logical_axes(cfg_t))
    assert got == want
    assert tsharding.batch_sharding(tm) == tuple(jsharding.batch_sharding(jm).spec)
    for k in ("embed", "heads", "mlp", "layers", "seq", "expert", None, "nope"):
        assert tsharding.DEFAULT_RULES.mesh_axes_for(k) == jsharding.DEFAULT_RULES.mesh_axes_for(k)


@pytest.mark.parametrize("axes", [{"dp": 8}, {"dp": 2, "fsdp": 2, "tp": 2}])
def test_resnet_placements_are_replicated_as_in_jax(axes):
    """resnet_logical_axes over the test ResNet's params: every leaf's
    placement is JAX's PartitionSpec for its table (all None), the
    placement the Trainer gives a leaf without logical axes."""
    from tf_operator_tpu.models import resnet as jr
    from tf_operator_tpu_torch.models import resnet as tr

    stages, widths = (1, 1, 1, 1), (16, 32, 64, 128)
    jm = jmesh.build_mesh(axes, devices=jax.devices())
    tm = tmesh.build_mesh(axes, ranks=range(N))
    jparams, _ = jax.eval_shape(lambda: jr.init_resnet(jax.random.PRNGKey(0),
                                                        jr.ResNetConfig(stages, widths, 10)))
    tparams, _ = tr.init_resnet(tr.ResNetConfig(stages, widths, 10),
                                torch.Generator().manual_seed(0), "cpu")
    want = jax.tree_util.tree_map(
        lambda la: tuple(jsharding.DEFAULT_RULES.sharding(jm, list(la)).spec),
        jr.resnet_logical_axes(jparams), is_leaf=lambda x: isinstance(x, tuple))
    got = tsharding.placements(tm, tr.resnet_logical_axes(tparams))
    assert got == want
    assert all(part is None for leaf in jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, tuple)) for part in leaf)


@pytest.mark.parametrize("axes", MESHES + [{"dp": 2, "tp": 4}])
def test_shard_then_gather_is_the_identity(axes):
    """shard_params on every rank, then gather_params: the tree bitwise;
    each rank's block is the JAX package's addressable shard of the same
    array on the same mesh."""
    cfg = tt.preset("tiny")
    full = tt.init_transformer_numpy(cfg, 3)
    mesh = tmesh.build_mesh(axes, ranks=range(N))
    logical = tt.transformer_logical_axes(cfg)
    blocks = {r: compat.shard_params(full, mesh, logical, r) for r in range(N)}
    back = compat.gather_params(blocks, mesh, logical)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(full)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jm = jmesh.build_mesh(axes, devices=jax.devices())
    wq = jax.device_put(full["layers"]["wq"], jsharding.DEFAULT_RULES.sharding(
        jm, ["layers", "embed", "heads"]))
    for shard in wq.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      blocks[shard.device.id]["layers"]["wq"])
    # torch leaves shard the same way
    tblock = compat.shard_params(compat.params_from_numpy(full, "cpu"), mesh, logical, 1)
    np.testing.assert_array_equal(tblock["embed"].numpy(), blocks[1]["embed"])


def test_rendezvous_helpers(monkeypatch):
    ctx = type("Ctx", (), {"num_processes": 1, "process_id": 0, "chips": 0,
                           "workload": {}})()
    assert rdv.initialize_distributed(ctx, "cpu") is None  # one process: a no-op
    assert rdv.local_device(ctx, "cpu") == torch.device("cpu")
    assert rdv.dist_backend(torch.device("cpu")) == "gloo"
    monkeypatch.setenv(rdv.ENV_DIST_BACKEND, "nccl")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        rdv.dist_backend(torch.device("cpu"))
    monkeypatch.setenv(rdv.ENV_DIST_BACKEND, "mpi")
    with pytest.raises(ValueError, match="use gloo or nccl"):
        rdv.dist_backend(torch.device("cpu"))
    ctx.chips = 4
    with pytest.raises(NotImplementedError, match="one process drives one card"):
        rdv.local_device(ctx, "cpu")

    import torch.distributed as dist

    def boom(exc):
        def entry(c):
            raise exc
        return rdv.retry_on_peer_loss(entry)

    for exc in (dist.DistBackendError("NCCL communicator was aborted"),
                dist.DistStoreError("store timeout"), dist.DistNetworkError("refused"),
                RuntimeError("[pair.cc:547] Connection closed by peer [127.0.0.1]:4"),
                RuntimeError("Connection reset by peer"),
                RuntimeError("[pair.cc:598] Timed out waiting 120000ms for recv")):
        with pytest.raises(SystemExit) as out:
            boom(exc)(ctx)
        assert out.value.code == 138
    with pytest.raises(ValueError, match="a workload bug"):
        boom(ValueError("a workload bug"))(ctx)
    with pytest.raises(RuntimeError, match="CUDA error"):
        boom(RuntimeError("CUDA error: an illegal memory access"))(ctx)
