"""Run a function on several ranks of one machine, each its own process.

``run_ranks(fn, world, *args)`` starts `world` processes (the ``spawn``
start method), joins them into one process group through a file in a
temporary directory (no port to pick, so concurrent runs never collide),
calls ``fn(rank, world, *args)`` in each and returns the ranks' results in
rank order. A rank that raises, or dies, fails the call and every other
rank is stopped; so does a run that outlasts `timeout`. `fn` must be
importable by name (a module-level function) and its results picklable.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, backend: str, workdir: str, threads: int,
               fn: Callable, args: tuple) -> None:
    out = Path(workdir) / f"rank{rank}.pkl"
    try:
        torch.set_num_threads(threads)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        dist.init_process_group(backend, init_method=f"file://{workdir}/rendezvous",
                                rank=rank, world_size=world)
        try:
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - handed to the parent with its traceback
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if result[0] != "ok":
        raise SystemExit(1)


def run_ranks(fn: Callable, world: int, *args: Any, backend: str = "gloo",
              timeout: float = 600.0, threads: int = 1) -> List[Any]:
    """fn(rank, world, *args) on `world` new processes; their results."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as workdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, workdir, threads, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        found = {}
        for r in range(world):
            path = Path(workdir) / f"rank{r}.pkl"
            if path.exists():
                found[r] = pickle.loads(path.read_bytes())
        for r, (status, value) in found.items():
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
        missing = [r for r in range(world) if r not in found]
        if missing:
            raise RuntimeError(f"ranks {missing} exited with codes "
                               f"{[procs[r].exitcode for r in missing]} and no result")
        return [found[r][1] for r in range(world)]
