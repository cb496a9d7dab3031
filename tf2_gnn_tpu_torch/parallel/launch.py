"""Start one process a rank and collect what each returns.

``run_ranks(fn, world_size, args)`` spawns ``world_size`` processes
(``spawn``: each imports the port afresh); each joins one
``torch.distributed`` group through a rendezvous file in a temporary
directory (``initialize_multiprocess``), pins its torch threads, runs
``fn(rank, world_size, *args)`` and sends back the result, which must
pickle. Results come back by rank. A rank that raises fails the call
with its traceback; ranks that do not finish within ``TIMEOUT`` seconds
fail it too. Either way every process is ended before the call returns.

The ranks run on ``device``, by default the card (every rank on the
current one), and join a gloo group (``BACKEND``): NCCL refuses two
ranks on one card, and gloo also serves CPU ranks.

``fn`` must be importable by name (a module-level function).
"""
import multiprocessing
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Sequence

from ..utils.device import resolve_device

BACKEND = "gloo"
TIMEOUT = 600.0  # seconds the ranks may take together
THREADS = 1      # torch threads a rank

def _rank_main(fn, rank: int, world_size: int, args, init_url: str,
               device: str, results) -> None:
    import torch
    import torch.distributed as dist

    from .multiprocess import initialize_multiprocess

    torch.set_num_threads(THREADS)
    try:
        initialize_multiprocess(init_url, world_size, rank, backend=BACKEND,
                                device=device)
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              device: str = "cuda") -> List[Any]:
    """``[fn(0, world_size, *args), ..., fn(world_size - 1, ...)]``, each
    run in a process of its own on ``device``."""
    device = str(resolve_device(device))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = Path(tempfile.mkdtemp(prefix="ranks_"))
    init_url = f"file://{tmp / 'rendezvous'}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world_size, tuple(args), init_url,
                               device, results))
             for rank in range(world_size)]
    try:
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + TIMEOUT
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(got))} of "
                    f"{world_size} did not finish within {TIMEOUT:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died (exit code "
                        f"{procs[dead[0]].exitcode}) without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 10.0))
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
