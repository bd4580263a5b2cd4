"""Run a function on ``world`` torch.distributed ranks, one process each.

``run_ranks(world, fn, *args)`` spawns the ranks (the ``spawn`` start
method: CUDA cannot be forked), each joins the scenario mesh
(``sharding.scenario_mesh``) at a ``file://`` rendezvous in a fresh
temporary directory (so that concurrent launches cannot collide) and runs
``fn(mesh, *args)``; the caller gets each rank's return value, in rank
order. ``fn`` and ``args`` reach the ranks pickled (``fn`` by its import
path: a module-level function), and so do the results: return CPU
tensors or plain data.

On the card the parent builds the kernel library before it spawns, so the
ranks load it instead of each running nvcc on every source. CPU ranks run
one intra-op thread each (a PyTorch thread pool per rank oversubscribes the
cores otherwise), CUDA ranks share the cores between them.

Failures end the run: a rank that raises reports its traceback and exits
1; every collective has a timeout (``collective_timeout`` seconds), so the
ranks left waiting on the failed one raise too instead of hanging; the
parent raises ``RuntimeError`` with the first rank's traceback (or on a
rank that exits without a report, or once ``timeout`` seconds pass) and
kills what is left.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch

from treeqp_tpu_torch.parallel import sharding

__all__ = ["run_ranks"]


def _rank_main(rank, world, init_method, device, collective_timeout, payload, results):
    try:
        torch.set_num_threads(1 if device == "cpu" else max(1, (os.cpu_count() or 1) // world))
        fn, args = pickle.loads(payload)
        mesh = sharding.scenario_mesh(rank, world, init_method, device=device,
                                      timeout=collective_timeout)
        try:
            out = fn(mesh, *args)
        finally:
            sharding.release_mesh(mesh.axis)
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # the rank's boundary: report it, then fail the process
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)


def run_ranks(world: int, fn, *args, device="cuda", timeout: float = 1800.0,
              collective_timeout: float = 300.0) -> list:
    """``fn(mesh, *args)`` on ranks 0 .. world-1 (``mesh`` the rank's
    ``sharding.ScenarioMesh``); returns their results in rank order.
    ``device``: "cuda" (every rank on a card, the default) or "cpu"."""
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks: no CUDA device (pass device='cpu' for CPU ranks)")
        from treeqp_tpu_torch.ops import _build
        _build.build()
    ctx = mp.get_context("spawn")
    rdzv = tempfile.mkdtemp(prefix="treeqp_rdzv_")
    results = ctx.Queue()
    payload = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_rank_main, name=f"treeqp-rank-{r}",
                         args=(r, world, f"file://{os.path.join(rdzv, 'store')}", device,
                               collective_timeout, payload, results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"run_ranks: ranks {sorted(set(range(world)) - set(out))} "
                                   f"did not finish within {timeout} s")
            try:
                rank, ok, body = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode is not None:
                        raise RuntimeError(f"run_ranks: rank {r} exited with code "
                                           f"{p.exitcode} without a result") from None
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {world} failed:\n{body}")
            out[rank] = pickle.loads(body)
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise RuntimeError(f"run_ranks: {p.name} exited with code {p.exitcode}")
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(timeout=30)
        results.close()
        shutil.rmtree(rdzv, ignore_errors=True)
