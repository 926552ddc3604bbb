"""Which collectives gloo carries on CUDA tensors when two ranks share
one card (NCCL refuses two ranks on one GPU, so that layout is gloo's).

Each collective runs in a gang of two ranks of its own, started as a
subprocess, so one that kills its gang (gloo aborts the process on some
transport errors rather than raising) cannot hide the others: the
all-reduce, reduce-scatter, all-gather, all-to-all, broadcast and the
send/recv pair under the port's ``ppermute``. Each result is checked
against the values the ranks' inputs give. Prints a line an op and, last,
``GLOO_CUDA {op: ok | wrong | crash ... | hang}``; needs a card:

    python tools/gloo_cuda_probe.py

``analytics_zoo_tpu_torch/parallel/collectives.py`` routes the ops this
finds refused (``GLOO_HOST_ROUTED``) through pinned host memory.
"""

import json
import socket
import subprocess
import sys

OPS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all",
       "ppermute", "broadcast")
OP_TIMEOUT_S = 60


def _rank(rank, world, port, op):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    x = (torch.arange(8.0) + rank).to(dev)
    base = [torch.arange(8.0) + r for r in range(world)]
    if op == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        want = sum(base)
    elif op == "reduce_scatter":
        y = torch.empty(8 // world, device=dev)
        dist.reduce_scatter_tensor(y, x.clone())
        want = sum(base).chunk(world)[rank]
    elif op == "all_gather":
        y = torch.empty(8 * world, device=dev)
        dist.all_gather_into_tensor(y, x.clone())
        want = torch.cat(base)
    elif op == "all_to_all":
        y = torch.empty(8, device=dev)
        dist.all_to_all_single(y, x.clone())
        want = torch.cat([b.chunk(world)[rank] for b in base])
    elif op == "ppermute":
        y = torch.empty(8, device=dev)
        ops = [dist.P2POp(dist.isend, x.clone(), (rank + 1) % world),
               dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        want = base[(rank - 1) % world]
    else:
        y = x.clone()
        dist.broadcast(y, 0)
        want = base[0]
    torch.cuda.synchronize()
    if rank == 0:
        print(json.dumps({"op": op, "ok": bool(torch.equal(y.cpu(), want))}),
              flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main() -> int:
    if len(sys.argv) == 3:          # one gang: python gloo_cuda_probe.py OP PORT
        import torch.multiprocessing as mp
        mp.spawn(_rank, args=(2, int(sys.argv[2]), sys.argv[1]), nprocs=2,
                 join=True)
        return 0
    import torch
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    res = {}
    for op in OPS:
        try:
            p = subprocess.run([sys.executable, __file__, op,
                                str(_free_port())], capture_output=True,
                               text=True, timeout=OP_TIMEOUT_S)
            if '"ok": true' in p.stdout:
                res[op] = "ok"
            elif '"ok": false' in p.stdout:
                res[op] = "wrong"
            else:
                last = (p.stderr.strip().splitlines() or [""])[-1]
                res[op] = f"crash rc={p.returncode}: {last[:150]}"
        except subprocess.TimeoutExpired:
            res[op] = "hang"
        print(op, res[op], flush=True)
    print("GLOO_CUDA", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
