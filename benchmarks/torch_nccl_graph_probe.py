"""Does a CUDA graph capture the sharded transport's NCCL calls?

One rank of a probe of the three collectives ``wafer.router``'s sharded
transport issues, each captured alone in a ``torch.cuda.graph`` and
replayed: the ring's coalesced ``batch_isend_irecv`` + ``wait`` (``p2p``),
``all_gather_into_tensor`` (``allgather``) and ``all_reduce``
(``allreduce``). The body first runs eagerly on a side stream, as
``core.graph.LoopGraph``'s warm-up does (NCCL sets its communicator up
there), then is captured under ``set_sync_debug_mode("error")`` in the
given capture mode, and replayed four times on new inputs: with an eager
all-gather between two replays (eager and captured work on one
communicator) and after a one-second pause (the process group's watchdog
polls meanwhile). Each replay's output must equal the collective's.
Last, the process group is destroyed with the graph alive, or with
``--free`` after the graph was collected; a rank that does not come back
from ``destroy_process_group`` shows no ``DESTROY done`` line.

Start one process a card, all with the same arguments but the rank::

    for r in 0 1; do
      timeout 60 python benchmarks/torch_nccl_graph_probe.py $r 2 \\
          /tmp/store p2p global &
    done; wait

Each rank prints ``PROBE op=... mode=... world=... rank=... OK`` (or
``FAIL`` and the error), then ``DESTROY start`` and ``DESTROY done``.
"""
import argparse
import gc
import time
import traceback

import torch
import torch.distributed as dist

T, R = 32, 64


def body(op, x, group, rank, world):
    y = x * 1.0
    if op == "p2p":
        nxt = dist.get_global_rank(group, (rank + 1) % world)
        prv = dist.get_global_rank(group, (rank - 1) % world)
        recv = torch.empty_like(y)
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, y, nxt, group),
                 dist.P2POp(dist.irecv, recv, prv, group)]):
            req.wait()
        return recv
    if op == "allgather":
        full = torch.empty((world * T, R), device=x.device)
        dist.all_gather_into_tensor(full, y, group=group)
        return full
    dist.all_reduce(y, group=group)
    return y


def want(op, v, rank, world, dev):
    xs = [torch.full((T, R), float(r * 10 + v), device=dev)
          for r in range(world)]
    if op == "p2p":
        return xs[(rank - 1) % world]
    if op == "allgather":
        return torch.cat(xs)
    return sum(xs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("store", help="file store path (absent beforehand)")
    ap.add_argument("op", choices=("p2p", "allgather", "allreduce"))
    ap.add_argument("mode", choices=("global", "thread_local"),
                    help="torch.cuda.graph capture_error_mode")
    ap.add_argument("--free", action="store_true",
                    help="collect the graph before destroying the group")
    a = ap.parse_args()
    dev = torch.device("cuda", a.rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{a.store}",
                            rank=a.rank, world_size=a.world)
    g = dist.group.WORLD
    x = torch.zeros(T, R, device=dev)
    t0 = time.time()
    status = "OK"
    graph = None
    try:
        x.fill_(a.rank * 10)
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = body(a.op, x, g, a.rank, a.world).clone()
        cur.wait_stream(side)
        torch.cuda.synchronize()
        assert torch.equal(out, want(a.op, 0, a.rank, a.world, dev)), \
            "eager"
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode=a.mode):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out.copy_(body(a.op, x, g, a.rank, a.world))
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        for v in (1, 2, 3, 4):
            if v == 4:
                time.sleep(1.0)
            x.fill_(a.rank * 10 + v)
            graph.replay()
            if v == 2:
                e = torch.empty((a.world,), device=dev)
                dist.all_gather_into_tensor(
                    e, torch.full((1,), float(a.rank), device=dev), group=g)
                assert e.tolist() == list(range(a.world)), e
            torch.cuda.synchronize()
            assert torch.equal(out, want(a.op, v, a.rank, a.world, dev)), \
                f"replay {v}"
    except Exception:
        status = "FAIL " + traceback.format_exc()[-1500:]
    print(f"PROBE op={a.op} mode={a.mode} world={a.world} rank={a.rank} "
          f"{time.time() - t0:.2f}s {status}", flush=True)
    if a.free:
        del graph
        gc.collect()
        torch.cuda.synchronize()
    print(f"DESTROY start free={a.free}", flush=True)
    dist.destroy_process_group()
    print("DESTROY done", flush=True)


if __name__ == "__main__":
    main()
