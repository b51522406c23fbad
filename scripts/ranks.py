"""Ranks of one host for the port's sharded tests and chip_smoke.py:
spawn_ranks starts a function in fresh processes, each a rank of one
process group, and collects their results; digest compares the ranks'
copies of a set of tensors bit for bit.

    from scripts.ranks import digest, spawn_ranks

(with the repo's root on sys.path). The library
(trx2dy_torch.parallel.mesh) takes whatever group its caller made: this is
one way of making it, torchrun is another
(scripts/dryrun_multichip.py).
"""
from __future__ import annotations

import hashlib
import multiprocessing
import os
import pickle
import queue as queue_module
import socket
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist


def digest(tensors: Sequence[torch.Tensor]) -> str:
    """SHA-256 of the tensors' bytes, in order (bitwise comparison of
    ranks' copies)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_main(rank, world_size, port, backend, work, results):
    # one host: gloo's pairs connect over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    fn, args = pickle.loads(work.recv_bytes())
    work.close()
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world_size)
    try:
        # pickled to bytes here: the queue's own pickler would send a
        # tensor as a shared-memory handle, which dies with this process
        out = pickle.dumps(fn(*args))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    else:
        results.put((rank, True, out))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo",
                timeout: float = 900.0) -> list:
    """fn(*args) in world_size fresh processes (the spawn method), each a
    rank of one process group of `backend` on tcp://localhost:<a free
    port>, one torch thread each; their return values in rank order. fn
    and its arguments and results are pickled: fn lives in a module the
    children can import. A rank that raises, or dies, fails the call: its
    traceback is raised here as RuntimeError and every rank is stopped."""
    ctx = multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    results = ctx.Queue()
    pipes = [ctx.Pipe(duplex=False) for _ in range(world_size)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, port, backend, pipes[r][0],
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    done, failed = {}, {}
    deadline = time.monotonic() + timeout
    try:
        # fn and its arguments go through a pipe once every rank has
        # started: a process started with them would hold the parent in
        # start() until it had imported its modules, one rank after another
        work = pickle.dumps((fn, args))
        for recv, send in pipes:
            recv.close()
            send.send_bytes(work)
            send.close()
        while len(done) < world_size and not failed:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_module.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in done}
                if dead:
                    raise RuntimeError(f"ranks died without a result "
                                       f"(rank: exit code) {dead}")
                if time.monotonic() > deadline:
                    late = sorted(set(range(world_size)) - set(done))
                    raise TimeoutError(f"ranks {late} gave no result in "
                                       f"{timeout} s")
                continue
            (done if ok else failed)[rank] = value
        if failed:
            rank = min(failed)
            raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                               f"{failed[rank]}")
        for p in procs:
            p.join(timeout=60)
        return [pickle.loads(done[r]) for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
