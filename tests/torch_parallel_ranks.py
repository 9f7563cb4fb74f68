"""Spawned gloo ranks for the tests of the port's multi-device path.

``run_ranks(tmp_path, world, job, payload)`` starts ``world`` processes
(``spawn``), each of which joins a gloo process group through a file in
``tmp_path`` (so parallel test workers never share a port), runs
``job(mesh, payload)`` and saves what it returns; the parent joins them
with a time limit, kills them on expiry and returns the ranks' results
in rank order. A job is a module-level function of a module that does
not import JAX, so the children never import it. The parent never
joins a process group.
"""

from __future__ import annotations

import datetime
import os
import traceback

import torch
import torch.multiprocessing as mp

# a rank waits at most this long in a collective; the parent a bit more
COLLECTIVE_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 150


def _rank_main(rank: int, world: int, root: str, job, payload,
               env: dict) -> None:
    import torch.distributed as dist
    from spades_for_blackbird_tpu_torch.parallel import mesh as mesh_mod

    os.environ.update({k: v.format(rank=rank) for k, v in env.items()})
    torch.set_num_threads(1)
    out = os.path.join(root, f"rank{rank}.pt")
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(root, 'init')}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            result = job(mesh_mod.make_mesh(), payload)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": result}, out)
    except BaseException:  # reported to the parent, which fails the test
        torch.save({"error": traceback.format_exc()}, out)
        raise


def run_ranks(root, world: int, job, payload=None, env=None) -> list:
    """The results of ``job`` on ``world`` gloo ranks, in rank order.
    ``env`` sets environment variables in each rank (``{rank}`` in a
    value is the rank)."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, root, job, payload, env or {}))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise AssertionError(f"ranks {hung} did not finish within "
                                 f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r in range(world):
        path = os.path.join(root, f"rank{r}.pt")
        if not os.path.exists(path):
            raise AssertionError(f"rank {r} exited with "
                                 f"{procs[r].exitcode} and no result")
        got = torch.load(path, weights_only=False)
        if "error" in got:
            raise AssertionError(f"rank {r} failed:\n{got['error']}")
        results.append(got["ok"])
    return results
