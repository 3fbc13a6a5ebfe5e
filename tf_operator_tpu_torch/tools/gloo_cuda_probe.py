"""Which torch.distributed collectives gloo carries for CUDA tensors.

Two ranks share card 0 over gloo; each collective runs once on a CUDA
tensor and its value is checked. Then an NCCL group of one. Prints one
JSON line per rank-0 finding. Run on a host with a CUDA card:

    python -m tf_operator_tpu_torch.tools.gloo_cuda_probe
"""

from __future__ import annotations

import json
import socket
import sys
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _try(name, fn, out):
    try:
        ok = bool(fn())
        out[name] = "ok" if ok else "wrong value"
    except Exception as exc:  # noqa: BLE001 - the finding is the error
        out[name] = f"{type(exc).__name__}: {str(exc)[:200]}"


def _gloo_ops(rank: int, dev: torch.device) -> dict:
    """name -> a check of one collective on CUDA tensors of rank ``rank``."""
    x = torch.full((4,), float(rank + 1), device=dev)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return torch.equal(y.cpu(), torch.full((4,), 3.0))

    def all_gather_into_tensor():
        y = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(y, x)
        return torch.equal(y.cpu(), torch.tensor([1.0] * 4 + [2.0] * 4))

    def all_gather_list():
        ys = [torch.empty(4, device=dev) for _ in range(2)]
        dist.all_gather(ys, x)
        return float(ys[1][0]) == 2.0

    def reduce_scatter_tensor():
        src = torch.arange(8, dtype=torch.float32, device=dev) * (rank + 1)
        y = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(y, src)
        return torch.equal(y.cpu(), torch.arange(8.0)[rank * 4:(rank + 1) * 4] * 3)

    def all_to_all_single():
        src = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
        y = torch.empty(4, device=dev)
        dist.all_to_all_single(y, src)
        return torch.equal(y.cpu(), torch.tensor([0.0, 1.0, 10.0, 11.0]) + 2 * rank)

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return float(y[0]) == 1.0

    def send_recv():
        y = torch.empty(4, device=dev)
        ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, y, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return float(y[0]) == float(2 - rank)

    def device_mesh():
        from torch.distributed.device_mesh import DeviceMesh

        m = DeviceMesh("cuda", [[0, 1]], mesh_dim_names=("dp", "tp"))
        y = x.clone()
        dist.all_reduce(y, group=m.get_group("tp"))
        return float(y[0]) == 3.0 and list(m.get_coordinate()) == [0, rank]

    return {f.__name__: f for f in (all_reduce, all_gather_into_tensor, all_gather_list,
                                    reduce_scatter_tensor, all_to_all_single, broadcast,
                                    send_recv, device_mesh)}


GLOO_OPS = ("all_reduce", "all_gather_into_tensor", "all_gather_list", "reduce_scatter_tensor",
            "all_to_all_single", "broadcast", "send_recv", "device_mesh")


def _gloo(rank: int, port: int, op: str, q) -> None:
    """One collective in a fresh pair of processes: a gloo fault that kills
    the process (it may write from a device pointer) loses only this op."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}
    _try(op, _gloo_ops(rank, dev)[op], out)
    if rank == 0:
        q.put(out)
    dist.destroy_process_group()


def _nccl_one(port: int, q) -> None:
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60),
                            device_id=torch.device("cuda", 0))
    x = torch.ones(4, device="cuda")

    def all_reduce():
        dist.all_reduce(x)
        return float(x[0]) == 1.0

    def reduce_scatter_tensor():
        y = torch.empty(4, device="cuda")
        dist.reduce_scatter_tensor(y, torch.arange(4.0, device="cuda"))
        return float(y[3]) == 3.0

    def device_mesh():
        from torch.distributed.device_mesh import DeviceMesh

        m = DeviceMesh("cuda", [[0]], mesh_dim_names=("fsdp", "tp"))
        return m.get_group("fsdp").size() == 1

    for fn in (all_reduce, reduce_scatter_tensor, device_mesh):
        _try(fn.__name__, fn, out)
    q.put(out)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    gloo = {}
    for op in GLOO_OPS:
        port = _free_port()
        procs = [ctx.Process(target=_gloo, args=(r, port, op, q)) for r in range(2)]
        for p in procs:
            p.start()
        try:
            gloo.update(q.get(timeout=90))
        except Exception:  # noqa: BLE001 - a crashed or hung op is the finding
            gloo[op] = "no result: " + ", ".join(f"exit {p.exitcode}" for p in procs)
        for p in procs:
            p.join(20)
            if p.is_alive():
                p.kill()
                p.join()
        print(json.dumps({op: gloo[op]}), flush=True)
    p = ctx.Process(target=_nccl_one, args=(_free_port(), q))
    p.start()
    nccl = q.get(timeout=300)
    p.join(60)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "gloo_cuda": gloo, "nccl_world1": nccl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
