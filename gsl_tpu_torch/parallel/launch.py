"""Start the ranks of a distributed run on this host, or join a world that
a launcher started.

- `spawn`: `world_size` processes by ``torch.multiprocessing`` with the
  ``spawn`` start method, which meet through a file store in a fresh
  directory (no network). Rank r runs ``fn(*args)`` in its process group
  and its return value comes back in the list `spawn` returns. A rank that
  raises ends the others and `spawn` raises, naming it; nothing catches
  that. Where the others fail in turn (their peer is gone), the rank
  named is the one that failed first. `fn` must be importable by the
  children: a module-level function.
- `join_env`: under ``torchrun`` or ``tools/launch_multihost.py``
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), join by
  ``env://``.

Each rank picks its backend by `gaussian_sharded.choose_backend` and
prints it. A CPU rank takes ``cpu_count // world_size`` intra-op threads
unless ``OMP_NUM_THREADS`` says otherwise.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from .gaussian_sharded import init_process_group

RESULT_FILE = "result_{rank}.pt"
FAILURE_FILE = "failure_{rank}.txt"      # when the rank raised, its error


def _cpu_threads(device, world_size: int):
    if torch.device(device).type == "cpu" \
            and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))


def _rank_entry(rank: int, world_size: int, store: str, device, fn, args,
                result_dir: str):
    _cpu_threads(device, world_size)
    init_process_group(rank, world_size, f"file://{store}", device)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(result_dir,
                                        RESULT_FILE.format(rank=rank)))
        dist.barrier()
    except BaseException:
        with open(os.path.join(result_dir, FAILURE_FILE.format(rank=rank)),
                  "w") as f:
            f.write(f"{time.time_ns()}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, device, args=(), workdir=None) -> list:
    """Run ``fn(*args)`` on `world_size` ranks of this host (see the module
    docstring); returns the ranks' return values in rank order. `workdir`:
    where the store and the results live while the ranks run (a new
    directory under it, removed after)."""
    tmp = tempfile.mkdtemp(prefix="gsl_dist_", dir=workdir)
    try:
        try:
            mp.spawn(_rank_entry, nprocs=world_size, join=True, args=(
                world_size, os.path.join(tmp, "store"), device, fn, args,
                tmp))
        except ProcessException as e:
            first = _first_failure(tmp, world_size)
            if first is None or first[0] == e.error_index:
                raise
            raise RuntimeError(
                f"\n\n-- Process {first[0]} terminated with the following "
                f"error (the first rank to fail):\n{first[1]}") from e
        return [torch.load(os.path.join(tmp, RESULT_FILE.format(rank=r)),
                           weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _first_failure(result_dir: str, world_size: int):
    """(rank, traceback) of the rank whose error was recorded first, or
    None where no rank recorded one (a rank killed by a signal)."""
    found = []
    for r in range(world_size):
        path = os.path.join(result_dir, FAILURE_FILE.format(rank=r))
        if os.path.isfile(path):
            with open(path) as f:
                stamp, _, tb = f.read().partition("\n")
            found.append((int(stamp), r, tb))
    if not found:
        return None
    _, rank, tb = min(found)
    return rank, tb


def under_launcher() -> bool:
    """Whether a launcher set this process's rank and world."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_env(device) -> int:
    """Join the launcher's world by ``env://``; returns its size."""
    world_size = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    _cpu_threads(device, local_world)
    init_process_group(int(os.environ["RANK"]), world_size, "env://",
                       device, local_world_size=local_world)
    return world_size
