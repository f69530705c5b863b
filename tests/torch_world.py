"""Run a function on every rank of a Gloo world of spawned processes on
the CPU, for the tests of uno_tpu_torch.parallel.

`run_world(fn, world, *args)` starts `world` processes, each joins a Gloo
group on a local TCP port, calls fn(group, *args) with the rank's
parallel.group.Group and sends back what it returns; the list comes back
in rank order.  A rank that raises fails the call with its traceback, and
a world that has not finished within `timeout` seconds is killed and fails
the call, so that a test never hangs.  The children import this module and
fn's module by name: neither may import JAX at module level.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, results, args):
    try:
        import torch
        import torch.distributed as dist
        from uno_tpu_torch.parallel.group import make_group
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        try:
            out = fn(make_group("cpu"), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, world: int, *args, timeout: float = 120.0):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    env = {"GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        procs = [ctx.Process(target=_entry, args=(fn, r, world, port, results, args),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + timeout
    out = {}
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise AssertionError(f"the world of {world} did not finish in {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"a rank died with exit code {dead[0]}")
                continue
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
