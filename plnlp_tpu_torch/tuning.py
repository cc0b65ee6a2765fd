"""Autotuning: blocked-SpMM block sizes and hyperparameter search (port of
plnlp_tpu/tuning.py).

* :func:`autotune_block` times the blocked SpMM forward and backward (the
  scatter-matmul kernel K1 over the graph and its transpose) in the compute
  dtype on the real graph for a few row-block sizes R, with the caller's
  ``block_edges``, and returns the fastest (R, B).  The CLI's
  ``--block_rows 0`` calls it.  On the card each candidate is timed with
  CUDA events around a run that ends in a synchronize; on the CPU (tests)
  with the host clock, where the choice says nothing about the card.
* :func:`grid_search` and :func:`random_search` run the full experiment
  (``cli.run_experiment``) once per point and select by mean best-validation
  score.
"""

from __future__ import annotations

import copy
import itertools
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["autotune_block", "grid_search", "random_search"]

_CANDIDATES: Tuple[Tuple[int, int], ...] = ((256, 512), (512, 512), (1024, 512))


def _fwd_bwd_seconds(g, gt, x: torch.Tensor, iters: int) -> float:
    """Median over ``iters`` of one blocked SpMM forward and backward, after
    one warm-up run (which also builds the kernel on first use)."""
    from plnlp_tpu_torch.ops.spmm import spmm_blocked

    def run():
        xr = x.detach().requires_grad_(True)
        spmm_blocked(g, gt, xr, "sum").float().square().sum().backward()

    run()
    times = []
    for _ in range(iters):
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(x.device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def autotune_block(
    src: np.ndarray,
    dst: np.ndarray,
    weight: Optional[np.ndarray],
    *,
    num_nodes: int,
    dim: int,
    symmetrize: bool = False,
    candidates: Optional[Sequence[Tuple[int, int]]] = None,
    block_edges: int = 512,
    iters: int = 3,
    dtype="float32",
    log=None,
    device=None,
) -> Tuple[int, int]:
    """Time the blocked SpMM forward and backward per candidate (R, B) on
    this graph in ``dtype``; return the fastest.  Candidates with R above
    ``num_nodes`` are skipped; one that runs out of device memory is logged
    and skipped.  Any other error (a kernel that does not build or launch)
    propagates.  When nothing could be measured: the smallest candidate
    with R <= num_nodes, else the largest power of two <= num_nodes (at
    most 512) with ``block_edges``, as the JAX package returns."""
    from plnlp_tpu_torch import default_device
    from plnlp_tpu_torch.graph import prepare_graph
    from plnlp_tpu_torch.nn import COMPUTE_DTYPES

    device = default_device(device)
    if candidates is None:
        # sweep R only, with the caller's --block_edges
        candidates = tuple((r, block_edges) for r, _ in _CANDIDATES)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(num_nodes, dim, generator=gen, device=device).to(COMPUTE_DTYPES[dtype])
    best, best_dt = None, float("inf")
    for r, b in candidates:
        if r > max(num_nodes, 1):
            continue
        g, gt = prepare_graph(
            src, dst, weight, num_nodes=num_nodes, symmetrize=symmetrize,
            block=(r, b), device=device,
        )
        try:
            dt = _fwd_bwd_seconds(g, gt, x, iters)
        except torch.cuda.OutOfMemoryError as e:
            if log:
                log(f"autotune: (R={r}, B={b}) out of device memory: {e!r:.120}")
            continue
        finally:
            del g, gt
        if log:
            log(f"autotune: (R={r}, B={b}) spmm fwd+bwd {dt * 1e3:.3f} ms ({dtype})")
        if dt < best_dt:
            best, best_dt = (r, b), dt
    if best is None:
        valid = [(r, b) for r, b in sorted(candidates) if r <= max(num_nodes, 1)]
        if valid:
            return valid[0]
        r = 1 << max(0, max(num_nodes, 1).bit_length() - 1)  # pow2 <= N
        return min(r, 512), block_edges
    return best


def grid_search(
    base_args,
    grid: Dict[str, Sequence],
    metric: Optional[str] = None,
    log=print,
    device=None,
    _announce_best: bool = True,
) -> Tuple[Dict, List[Dict]]:
    """Exhaustive search over CLI flag values: ``cli.run_experiment`` (runs x
    epochs, sampling, eval points, model selection) once per grid point on
    ``device``, selected by mean best-validation score.

    ``base_args`` is an ``argparse.Namespace`` from ``cli.argument``; each
    point deep-copies it and overrides the swept keys, which must be
    existing flags.  ``metric`` defaults to ``MRR`` for ``--eval_metric
    mrr``, else ``Hits@50``.  Returns ``(best, results)``: the winning
    overrides with ``valid``/``test`` means and stds, and one such dict per
    point in sweep order."""
    from plnlp_tpu_torch.cli import run_experiment

    for k in grid:
        if not hasattr(base_args, k):
            raise ValueError(f"unknown CLI flag in grid: --{k}")
    if metric is None:
        metric = "MRR" if getattr(base_args, "eval_metric", "hits") == "mrr" else "Hits@50"
    emit = log if log is not None else (lambda *a: None)

    keys = list(grid)
    results: List[Dict] = []
    best: Optional[Dict] = None
    for combo in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        args = copy.deepcopy(base_args)
        for k, v in overrides.items():
            setattr(args, k, v)
        loggers = run_experiment(args, log=lambda *a: None, device=device)
        if metric not in loggers:
            raise ValueError(f"metric {metric!r} not produced; available: {sorted(loggers)}")
        vm, vs, tm, ts = loggers[metric].summary()
        if np.isnan(vm):
            # no eval point (epochs < eval_steps): a NaN would lose every
            # comparison and return the first point as the best
            raise ValueError(
                f"grid point {overrides} recorded no eval points (valid mean is NaN): "
                f"epochs={args.epochs} < eval_steps={args.eval_steps}?"
            )
        entry = {
            **overrides, "valid": float(vm), "valid_std": float(vs),
            "test": float(tm), "test_std": float(ts),
        }
        results.append(entry)
        emit(f"grid_search: {overrides} -> {metric} valid {vm:.2f} ± {vs:.2f}, test {tm:.2f}")
        if best is None or entry["valid"] > best["valid"]:
            best = entry
    if best is None:
        raise ValueError("empty grid")
    if _announce_best:
        emit(f"grid_search: best {best}")
    return best, results


def random_search(
    base_args,
    space: Dict[str, Sequence],
    num_trials: int,
    metric: Optional[str] = None,
    seed: int = 0,
    log=print,
    device=None,
) -> Tuple[Dict, List[Dict]]:
    """``num_trials`` uniform draws of one value per flag from ``space``,
    each run as in :func:`grid_search`; a repeated draw is skipped, so a
    small space gives fewer results than trials."""
    rng = np.random.default_rng(seed)
    keys = list(space)
    for k in keys:
        if not hasattr(base_args, k):
            raise ValueError(f"unknown CLI flag in space: --{k}")
        if not len(space[k]):
            raise ValueError(f"empty value list for --{k}")
    seen = set()
    combos = []
    for _ in range(num_trials):
        combo = tuple(space[k][rng.integers(len(space[k]))] for k in keys)
        if combo not in seen:
            seen.add(combo)
            combos.append(combo)
    results: List[Dict] = []
    best: Optional[Dict] = None
    for combo in combos:
        b, r = grid_search(
            base_args, {k: [v] for k, v in zip(keys, combo)}, metric=metric, log=log,
            device=device, _announce_best=False,
        )
        results.extend(r)
        if best is None or b["valid"] > best["valid"]:
            best = b
    if best is None:
        raise ValueError("num_trials must be >= 1")
    if log is not None:
        log(f"random_search: best {best}")
    return best, results
