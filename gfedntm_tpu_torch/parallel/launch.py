"""Run one function on every rank of a fresh process group.

:func:`run_ranks` starts ``world_size`` processes with the ``spawn`` start
method (``fork`` is unsafe once the parent has initialized CUDA), joins them
into a default process group over a ``file://`` rendezvous in a fresh
temporary directory (so concurrent callers never collide on a port), calls
``fn(rank, device, *args)`` in each and returns the ranks' results in rank
order. ``fn`` must be importable by a fresh interpreter (a module-level
function of a module that imports no JAX), and its result picklable.

Every wait is bounded by ``timeout_s``: when it passes, or when a rank fails,
the remaining ranks are killed and the call raises with the failing rank's
traceback.
"""

from __future__ import annotations

import multiprocessing
import queue
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist


def _rank_main(fn, rank, world_size, backend, device, init_method, args, results):
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # W ranks on one host: no oversubscription
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
        try:
            results.put((rank, True, fn(rank, dev, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def gpu_layout(world_size: int) -> tuple[str, list[str]]:
    """A ``(backend, devices)`` for :func:`run_ranks` on this host's GPUs:
    NCCL with one GPU per rank when there are enough GPUs, else gloo with
    every rank on ``cuda:0`` (gloo stages CUDA collectives through the host;
    the kernels still run on the card)."""
    if torch.cuda.device_count() >= world_size:
        return "nccl", [f"cuda:{r}" for r in range(world_size)]
    return "gloo", ["cuda:0"] * world_size


def run_ranks(fn, world_size: int, backend: str, devices, timeout_s: float,
              args: tuple = ()) -> list:
    """``[fn(0, devices[0], *args), ..., fn(W-1, devices[W-1], *args)]``,
    each in its own process of a ``world_size``-rank group on ``backend``."""
    devices = list(devices)
    if len(devices) != world_size:
        raise ValueError(f"{world_size} ranks need {world_size} devices, got {devices}")
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="gfedntm_ranks_") as tmp:
        init_method = (Path(tmp) / "rendezvous").as_uri()
        results = ctx.Queue()
        procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                fn, rank, world_size, backend, str(devices[rank]), init_method, args,
                results))
            for rank in range(world_size)
        ]
        try:
            for proc in procs:
                proc.start()
            done = _collect(procs, results, deadline, timeout_s)
            for proc in procs:
                proc.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join(5.0)
            results.close()
    return [done[rank] for rank in range(world_size)]


def _collect(procs, results, deadline, timeout_s) -> dict:
    done: dict = {}
    while len(done) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(len(procs))) - set(done))
            raise TimeoutError(f"ranks {missing} did not finish within {timeout_s} s")
        try:
            rank, ok, payload = results.get(timeout=min(left, 0.5))
        except queue.Empty:
            # A rank that reports exits 0 after its result is in the pipe;
            # any other exit without a result is a crash.
            for rank, proc in enumerate(procs):
                if rank not in done and proc.exitcode not in (None, 0):
                    raise RuntimeError(
                        f"rank {rank} exited with code {proc.exitcode} and no result"
                    ) from None
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        done[rank] = payload
    return done
