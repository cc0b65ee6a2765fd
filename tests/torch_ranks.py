"""Gloo process groups on the CPU for the port's multi-rank tests.

``spawn`` runs each {world size: cases} as its own process group, all at
once, and returns rank 0's results.  A case is (name, function name,
arguments): each rank imports the calling test module (spawned processes
start fresh) and calls the function there, so JAX, which only the test
process's own functions import, never reaches a rank.  Each process group
has a 60 s timeout and the spawn a wall-clock limit, so a rank that raises
cannot hang the suite; rank 0 pickles its results to a file.
"""

import datetime
import importlib
import pickle
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WALL_S = 150


def _rank_main(rank, world, port, out_path, module, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        mod = importlib.import_module(module)
        results = {name: getattr(mod, fn)(*args) for name, fn, args in cases}
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def spawn(worlds, tmp_path, module):
    """{world size: rank 0's results} of each {world size: cases} of
    ``module``'s functions."""
    runs = {}
    for world, cases in worlds.items():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        out = str(tmp_path / f"world{world}.pkl")
        runs[world] = (out, mp.start_processes(
            _rank_main, args=(world, port, out, module, cases), nprocs=world, join=False,
            start_method="spawn"))
    deadline = time.monotonic() + WALL_S
    try:
        for world, (_, ctx) in runs.items():
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {world}-rank group ran past {WALL_S} s")
    finally:
        for _, ctx in runs.values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    results = {}
    for world, (out, _) in runs.items():
        with open(out, "rb") as f:
            results[world] = pickle.load(f)  # written by the test module's own ranks
    return results
