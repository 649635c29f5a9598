"""Start a world of ranks on one host and collect what each returns.

    results = run_world(fn, world_size, backend=None, device="cuda", args=(...))

The device defaults to the card, and asking for the card where there is
none raises (config.resolve_device).  The backend defaults to NCCL where
every rank can have a card of its own (world_size <= the cards), else gloo
(ranks sharing one card, or the CPU).

Each rank is a process started by torch.multiprocessing in spawn mode.  It
joins the process group through a file in a fresh temporary directory (no
port to race for, so several test workers can start worlds at once), takes
its device (cuda:<rank> under NCCL, one card per rank; the device as given
under gloo, so several ranks may share one card), calls fn(rank, device,
*args) and sends back the result (torch tensors as numpy arrays) or its
traceback.  fn must be importable by name (a module-level function): a
spawned rank starts from a fresh interpreter.

No hang: the process group has a timeout of timeout_s, and the parent
waits for all results until a deadline timeout_s away, kills every rank
past it and raises TimeoutError.  A rank that fails, or dies without a
result, makes run_world kill the others and raise RankError: a rank left
waiting in a collective for a dead peer would otherwise wait forever.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import resolve_device

class RankError(RuntimeError):
    """A rank raised or died; the message holds its traceback or exit code."""


def resolve_backend(backend: str | None, world_size: int, device) -> str:
    """The backend as given, or by default NCCL where each of world_size
    ranks can have a card of its own, else gloo."""
    if backend is not None:
        return backend
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    return "nccl" if world_size <= cards else "gloo"


def _rank_device(device, backend: str, rank: int) -> torch.device:
    """The device rank `rank` computes on: under NCCL one card a rank
    (cuda:<rank>), under gloo the device as given (cuda means cuda:0)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", dev.index or 0)


def _to_host(obj):
    """Results cross as numpy: tensors (on any device) become arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world_size, backend, device, init_method, timeout_s, args, results):
    try:
        dev = _rank_device(device, backend, rank)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout_s),
                                device_id=dev if backend == "nccl" else None)
        try:
            out = _to_host(fn(rank, dev, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the traceback goes to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def _failures(results, rank: int, tb: str, pending: int, grace_s: float = 2.0) -> str:
    """The first failure and those that follow it within grace_s (or until
    every one of the `pending` ranks without a result has reported): the
    first to arrive may be a peer's, failing in a collective because the
    rank at fault has gone."""
    out = [f"run_world: rank {rank} failed:\n{tb}"]
    end = time.monotonic() + grace_s
    while pending > 1 and (left := end - time.monotonic()) > 0:
        try:
            r, ok, msg = results.get(timeout=left)
        except queue.Empty:
            break
        pending -= 1
        if not ok:
            out.append(f"rank {r} failed:\n{msg}")
    return "\n".join(out)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def run_world(fn, world_size: int, backend: str | None = None, device="cuda", args=(),
              timeout_s: float = 300.0):
    """Run fn(rank, device, *args) on world_size spawned ranks; return the
    list of their results in rank order.  Raises RankError if a rank fails
    or dies, TimeoutError past timeout_s; no rank outlives the call."""
    device = resolve_device(device)
    backend = resolve_backend(backend, world_size, device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="run_world_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, world_size, backend, device, init_method,
                                   timeout_s, args, results))
                 for rank in range(world_size)]
        deadline = time.monotonic() + timeout_s
        got: dict = {}
        try:
            for p in procs:
                p.start()
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world_size)) - set(got))
                    raise TimeoutError(f"run_world: ranks {missing} gave no result within "
                                       f"{timeout_s} s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead and results.empty():
                        raise RankError(f"run_world: rank {dead[0]} exited with code "
                                        f"{procs[dead[0]].exitcode} and no result") from None
                    continue
                if not ok:
                    raise RankError(_failures(results, rank, out, world_size - len(got)))
                got[rank] = out
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            _stop(procs)
            results.close()
    return [got[r] for r in range(world_size)]
