"""Start the ranks of a mesh as processes, with a deadline.

``spawn(fn, world_size, *args)`` runs ``fn(rank, world_size, init_method,
*args)`` in ``world_size`` fresh processes (the ``spawn`` start method) on
one host, ``init_method`` being ``tcp://localhost:<a free port>``, and
returns the ranks' results in rank order.  ``fn`` is found in the child by
its source file and qualified name, so it may live in a script or a test
module; its arguments and result must pickle.  The first rank that raises
ends the run: the others are killed and its traceback is raised in the
parent.  A run past its deadline is killed and raises ``TimeoutError``;
each child also ends itself at the deadline, should the parent be gone.
"""
from __future__ import annotations

import importlib.util
import inspect
import os
import queue as queue_mod
import socket
import threading
import time
import traceback
from typing import Any, Callable, List


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _load(path: str, qualname: str) -> Callable:
    spec = importlib.util.spec_from_file_location(
        "_rank_program_" + os.path.basename(path).split(".")[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _watchdog(deadline: float) -> None:
    time.sleep(max(deadline - time.time(), 0.0))
    os._exit(124)


def _rank_main(path, qualname, rank, world_size, init_method, args, results,
               deadline) -> None:
    import torch
    threading.Thread(target=_watchdog, args=(deadline,), daemon=True).start()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        out = _load(path, qualname)(rank, world_size, init_method, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args: Any,
          timeout: float = 120.0) -> List[Any]:
    """Run ``fn(rank, world_size, init_method, *args)`` on ``world_size``
    ranks; returns their results in rank order."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    deadline = time.time() + timeout
    path = inspect.getsourcefile(fn)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        path, fn.__qualname__, r, world_size, init_method, args, results,
        deadline)) for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    done = False
    try:
        while len(out) < world_size:
            left = deadline - time.time()
            if left <= 0:
                late = sorted(set(range(world_size)) - set(out))
                raise TimeoutError(f"{fn.__qualname__}: ranks {late} had not "
                                   f"finished after {timeout:.0f} s")
            try:
                rank, fine, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode not in (None, 0):
                        raise RuntimeError(f"{fn.__qualname__}: rank {r} "
                                           f"exited with code {p.exitcode}")
                continue
            if not fine:
                raise RuntimeError(f"{fn.__qualname__}: rank {rank} "
                                   f"failed:\n{payload}")
            out[rank] = payload
        done = True
    finally:
        for p in procs:
            if done:
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
