"""The port's mesh layer against the JAX package's, with no process started.

- ``MeshSpec`` raises the JAX package's errors; the rank arrays of
  ``build_mesh`` (canonical order), of the job context's mesh (the spec's
  insertion order) and of ``build_hybrid_mesh`` are the device ids of the
  JAX package's ``Mesh`` over its eight CPU devices (tests/conftest.py).
- Each leaf's placement under ``DEFAULT_RULES`` is JAX's ``PartitionSpec``
  for every leaf of ``transformer_logical_axes(tiny)``, and the batch's;
  every leaf of ``resnet_logical_axes`` is replicated, as in JAX.
- tiny-moe's placements under meshes with ep and cp are JAX's, and a
  [batch, seq] array's rank blocks (``MeshPlan.local_batch``) are JAX's
  ``NamedSharding`` index blocks.
- ``_moe_local_gmm`` on a simulated ep axis of 2 and 4 shards (threads,
  the exchanges by hand) gives JAX's ``_moe_local_gmm`` under ``jax.vmap``
  over an "ep" axis, and its receiver's block map is the counts' layout.
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


EP_CP_MESHES = [{"dp": 2, "fsdp": 2, "ep": 2}, {"ep": 4, "tp": 2}, {"fsdp": 2, "ep": 2, "cp": 2},
                {"dp": 2, "cp": 4}]


@pytest.mark.parametrize("axes", EP_CP_MESHES)
def test_expert_and_seq_placements_match_jax(axes):
    """tiny-moe's leaves (the experts split over ep, w_router over fsdp and
    ep) are JAX's PartitionSpecs under DEFAULT_RULES, and a [batch, seq]
    array's rank blocks (MeshPlan.local_batch: rows over dp and fsdp, the
    sequence over cp) are the index blocks of JAX's NamedSharding of
    ("batch", "seq") on every device."""
    jm = jmesh.build_mesh(axes, devices=jax.devices())
    tm = tmesh.build_mesh(axes, ranks=range(N))
    cfg_j, cfg_t = jt.preset("tiny-moe"), tt.preset("tiny-moe")
    want = jax.tree_util.tree_map(
        lambda la: tuple(jsharding.DEFAULT_RULES.sharding(jm, list(la)).spec),
        jt.transformer_logical_axes(cfg_j), is_leaf=lambda x: isinstance(x, tuple))
    assert tsharding.placements(tm, tt.transformer_logical_axes(cfg_t)) == want
    full = np.arange(8 * 16).reshape(8, 16)
    index = jsharding.DEFAULT_RULES.sharding(jm, ["batch", "seq"]).devices_indices_map(full.shape)
    for device, idx in index.items():
        plan = tsharding.MeshPlan(tm, rank=device.id)
        np.testing.assert_array_equal(plan.local_batch(full), full[idx])
        assert plan.loss_size == plan.data_size * plan.seq_size
        assert set(plan.loss_axes) == {a for a in ("dp", "fsdp", "cp") if axes.get(a, 1) > 1}


class _ThreadEp:
    """Shard ``s`` of a simulated ep axis of ``n`` shards, one thread each:
    what moe.py reads of a DeviceMesh, and all_to_all and the count
    exchange through a barrier (row j of each shard's [n, ...] to shard j)."""

    def __init__(self, s: int, n: int, board: dict, barrier) -> None:
        self.s, self.n, self.board, self.barrier = s, n, board, barrier
        self.mesh_dim_names, self.mesh = ("ep",), torch.zeros(n)

    def get_local_rank(self, axis):
        return self.s

    def exchange(self, x):
        self.board[self.s] = x
        self.barrier.wait()
        out = torch.stack([self.board[j][self.s] for j in range(self.n)])
        self.barrier.wait()
        return out


@pytest.mark.parametrize("n,k_top", [(2, 1), (4, 2)])
def test_moe_local_gmm_layout_matches_jax(monkeypatch, n, k_top):
    """_moe_local_gmm on n simulated ep shards (threads, the exchanges done
    by hand): each shard's output equals JAX's _moe_local_gmm run under
    jax.vmap over an "ep" axis of n (its all_to_all, its send slots and
    its receiver map; gmm in interpret mode), f32, row block 8; and the
    receiver's block map holds each source's local experts at
    ceil(count / B) blocks each, in expert order, the rest -1."""
    import threading

    from tf_operator_tpu.parallel import moe as jmoe
    from tf_operator_tpu_torch.parallel import collectives as coll
    from tf_operator_tpu_torch.parallel import moe as tmoe

    T, d, f, E, B = 24, 16, 8, 8, 8
    rng = np.random.RandomState(n)
    x = rng.randn(n, T, d).astype(np.float32)
    g = rng.randn(n, T, E).astype(np.float32)
    g[:, :, 0] -= 10.0  # expert 0 wins no choice: empty regions on every source
    w = {k: rng.randn(n, E // n, *s).astype(np.float32) * 0.3
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    want = jax.jit(jax.vmap(lambda x, g, w: jmoe._moe_local_gmm(x, g, w, "ep", k_top, B)[0],
                            axis_name="ep"))(x, g, w)

    board, barrier = {}, threading.Barrier(n)
    meshes = [_ThreadEp(s, n, board, barrier) for s in range(n)]
    monkeypatch.setattr(coll, "all_to_all", lambda t, mesh, axis: mesh.exchange(t))
    monkeypatch.setattr(coll, "exchange_counts", lambda t, mesh, axis: mesh.exchange(t))
    maps, outs, sound = {}, {}, tmoe.receiver_block_expert

    def record(counts_rcv, block_rows, seg_blocks):
        be = sound(counts_rcv, block_rows, seg_blocks)
        maps[threading.current_thread().name] = (counts_rcv, seg_blocks, be)
        return be

    monkeypatch.setattr(tmoe, "receiver_block_expert", record)

    def shard(s):
        with torch.no_grad():
            outs[s] = tmoe._moe_local_gmm(
                torch.from_numpy(x[s]), torch.from_numpy(g[s]),
                {k: torch.from_numpy(v[s]) for k, v in w.items()}, meshes[s], "ep", k_top, B)[0]

    threads = [threading.Thread(target=shard, args=(s,), name=str(s)) for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s in range(n):
        np.testing.assert_allclose(outs[s].numpy(), np.asarray(want[s]), rtol=0, atol=1e-5)
        counts_rcv, seg_blocks, be = maps[str(s)]
        for src in range(n):
            blocks = [-(-int(c) // B) for c in counts_rcv[src]]
            expect = [e for e, nb in enumerate(blocks) for _ in range(nb)]
            expect += [-1] * (seg_blocks - len(expect))
            assert be[src * seg_blocks:(src + 1) * seg_blocks].tolist() == expect
        assert (be == -1).any() and int(counts_rcv.sum()) > 0
