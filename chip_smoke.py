#!/usr/bin/env python3
"""Drive the plnlp_tpu_torch serving and training paths (SAGE and
TRANSFORMER, float32 and bfloat16, over the hybrid operand and blocked
CSR), the partitioned multi-device path and the training CLI on NVIDIA
GPUs (one card, or up to four) and check them.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. build every CUDA kernel of the port from ``plnlp_tpu_torch/csrc``;
2. print the card's name and power limit;
3. build ogbl-collab-sized synthetic data (235,868 nodes, 1,179,052 drawn
   edges, symmetrized) and the blocked CSR graph and its transpose with the
   CLI's default block (512, 512);
4. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (x of shape (N, 256) over the graph and
   its transpose), gradient included, and require a second launch to give
   the same bits;
5. drive the serving path through the library entry points at full collab
   width (2-layer SAGE, width 256, DOT predictor): ``Scorer.score``,
   ``rank_candidates_batch(exclude_edges=True)`` and ``Model.test``, then
   ``score`` again with the MLP predictor; the kernel launch counts must
   show ``gnn_num_layers`` launches per encode, and the encode must agree
   with the same model run on the CPU (the plain path);
6. time K1, its plain version, one PyTorch library call computing the same
   function, the encode and the scoring rate;
7. training data as the CLI builds it for a community-structured graph of
   collab's size (800-community SBM, symmetrized): the label-prop estimate
   at T = 256, min_fill = 96 (coverage must reach the 0.35 at which
   ``--adj_backend=auto`` picks hybrid), the id-space relabel, the hybrid
   operand (dense tiles + blocked residual) and the plain CSR twin the
   negative sampler excludes;
8. hold the tile kernel K2 against its plain version on the forward and
   the transposed tile sets, and ``hybrid_spmm`` (mean) and its gradient
   against autograd through the plain versions, with x at num_nodes rows
   and at the padded-carry n_pad rows the epoch launches with;
9. train SAGE + MLP + AUC (width 256, 2 layers, batch 65,536, global
   sampler) for one ``train_epoch`` and run ``Model.test`` over the hybrid
   operand; the counts must show 4 K2 and 4 K1 launches per step and 2 of
   each per encode, and the epoch's loss must be finite;
10. one train step on the card against the same step on the CPU, on the
   same recipe at a tenth of the size with the CE loss and SGD: loss,
   gradients, parameters;
11. time K2 (both directions), its plain version, ``torch.sparse.mm`` on
   the dense-tile edges, a train step and the epoch, and reckon K2's bound
   from the tiles' nonzeros and bytes;
12. hold the flash attention kernels K3 (forward), K4 (dq) and K5 (dk/dv)
   against their plain versions on the SBM operand's tile sets, with q, k,
   v, g at the padded-carry n_pad rows (random pad rows, as after layer 1),
   and require a second launch of K3, of K4 and of K5 to give the same bits;
13. hold ``hybrid_transformer_conv`` (padded-carry) and its input and
   parameter gradients against autograd through the per-edge TRANSFORMER
   path over the plain CSR twin of the same edges;
14. train TRANSFORMER + MLP + AUC (width 256, 2 layers, batch 65,536, Adam)
   for one ``train_epoch`` over the hybrid operand, then ``Model.test`` and
   ``Scorer.score`` on 65,536 pairs; the counts must show 2 launches each
   of K3, K4 and K5 per step, 2 of K3 per encode, and none of K1 or K2;
   ``rank_candidates_batch(exclude_edges=True)`` for 300 sources over the
   hybrid operand with ``exclude_graph`` its CSR twin must return no known
   neighbor and finite scores, and without ``exclude_graph`` it must raise
   the ValueError that names it;
15. the card-against-CPU step of phase 10 with the TRANSFORMER encoder;
16. time K3, K4, K5, their plain versions, a TRANSFORMER train step and a
   TRANSFORMER encode, and reckon each kernel's bound from the tiles'
   nonzeros and bytes, with the row gather each adds and the dense tile
   products each skips printed beside it;
17. the training CLI, ``plnlp_tpu_torch.cli.main`` in-process, on the
   reference README's ogbl-collab command over blocked CSR at collab's
   size (235,868 nodes, 1,179,052 drawn edges with weights and years,
   ``--year 2010 --use_valedges_as_input True``): 2 epochs with a
   checkpoint each, JSON-lines metrics and a profiler trace of epoch 2
   whose top 10 device ops it logs; K1 must launch 4 times a step and 2
   times a ``Model.test``.  Then ``--epochs 3 --resume True``: one epoch,
   from parameters with the checkpoint's bits.  Then ``--score_pairs`` on
   65,536 pairs (2 K1 launches), equal to ``Scorer.from_checkpoint``;
18. the CLI on the README's ogbl-ddi command (width 512, 3 negatives) at
   ddi's size (4,267 nodes, 1,067,911 drawn edges): ``auto`` takes the
   dense backend, one epoch with a finite loss and no K1-K5 launch;
19. the CLI with TRANSFORMER on a 200-community SBM (60,000 nodes,
   300,000 edges): ``auto`` must choose hybrid (id space relabeled), K3,
   K4 and K5 launch 2 times a step (K3 2 more per ``Model.test``); then
   ``--score_pairs`` over the hybrid operand with pairs in original ids,
   equal to the restored Scorer's scores on the relabeled ids;
20. K1 in bf16 (x and out bfloat16) against its plain version over the
   collab graph and its transpose (N = 235,868, D = 256) and over the SBM
   operand's residual, each element within the f32 sums' tolerance plus one
   bf16 ulp, a second launch bitwise equal; its time, the plain version's,
   ``torch.sparse.mm`` on a bf16 CSR (or the error PyTorch raises) and its
   bound;
21. K2 with bf16 x on the SBM operand's int8 tiles and on bf16 tiles (the
   SBM with non-integer edge weights, ``build_hybrid(dtype="bfloat16")``
   through the estimate's cached order, no second label-prop sweep), both
   directions, with the same checks, times and bound;
22. SAGE + MLP + AUC in bf16 (width 256, 2 layers, batch 65,536, Adam) for
   one epoch over the SBM's hybrid operand and one over the collab graph's
   blocked CSR, then ``Model.test``, ``Scorer.score`` and
   ``rank_candidates_batch(exclude_edges=True)``: only the bf16 entry
   points launch (K2 4 and K1 4 a step on hybrid, K1 4 on CSR, 2 each an
   encode), the parameters and Adam's state stay float32, the scores are
   float32; step, epoch and encode times;
23. the card-against-CPU step of phase 10 in bf16, at bf16 tolerances;
24. the CLI's collab command with ``--compute_dtype bfloat16 --block_rows
   0``: the autotune's candidates (their forward+backward times) and its
   choice, 2 epochs with only K1 bf16 launching, and a profiler trace of
   epoch 2 whose GEMM kernels and their time a step it logs;
25. the CLI's ddi command with ``--compute_dtype bfloat16`` on the dense
   backend (no kernel launch);
27. K3, K4 and K5's bf16 entry points against their bf16 plain versions
   at the SBM training shape (q, k, v, g bf16 at n_pad rows), on the int8
   tiles and on the same tiles stored in bf16: the f32 sums' tolerance plus
   2**-7 of the terms' magnitudes, a second launch bitwise equal, no f32
   launch; their times, the plain versions' and the bound;
28. TRANSFORMER + MLP + AUC in bf16 (width 256, 2 layers, batch 65,536,
   Adam) for one epoch over the SBM's hybrid operand, ``Model.test`` and
   ``Scorer.score``: only the bf16 K3-K5 launch (2 each a step, K3 2 an
   encode), parameters and Adam's state f32; step, epoch and encode times
   beside phase 16's; then the card-against-CPU step in bf16;
29. TRANSFORMER over the collab graph's blocked CSR with ``tconv_map``
   (``ops/transformer.py`` on K1): the layer and its gradients against
   autograd through the per-edge path on the card in f32 and bf16, K1 1
   launch forward and 3 backward; one epoch in each dtype (K1 8 a step in
   x's dtype only) with step and epoch times, and the per-edge path's
   step; a small graph with single-in-edge rows, self loops and duplicate
   edges through K1 on the card against its plain version on the CPU;
30. the CLI: the collab command with ``--encoder TRANSFORMER`` over csr for
   one epoch in f32 and one in bf16 (only K1-bf16), phase 19's SBM command
   in bf16 (``auto`` -> hybrid, only the bf16 K3-K5) and its
   ``--score_pairs`` against the restored Scorer;
31. the native host library (``csrc/graphcore.cpp``, built in phase 1 with
   g++; a NumPy fallback fails): ``coalesce_add``, ``blocks_build``,
   ``label_prop`` and ``bfs_order`` bit for bit against their NumPy plain
   versions on a 20,000-node graph, with both times; the label-prop order
   on phase 7's SBM, natively (phase 7's estimate runs natively too, and at
   seed 0 its coverage and tile count must stay 0.9442 and 2,658);
31b. K1 over a real 4-shard partition of the collab graph on this card, in
   one process with no collective: ``partition_graph(num_shards=4,
   reorder='bfs')`` with its halo plan, every shard's blocks placed by
   ``GraphParallel.place``, K1 run per shard over the gathered buffer (the
   all_gather body: global source slots, per-shard ``blk_rowptr``) and
   over the shard's own rows plus the halo buffer as the exchange would
   fill it (local and remote blocks), forward and backward (the
   source-sharded structure); the shards' rows, reassembled through the
   slot permutation, against K1 over the single operand (1e-5 + 1e-6
   sum|terms|), with the per-shard K1 times beside the single operand's;
32. the partitioned path (``parallel/``) on W = min(cards, 4) ranks, one
   process and one card each over NCCL (W = 1 on a one-card machine), at
   collab's shape (2-layer SAGE, width 256, batch 65,536) over
   ``make_graph_parallel`` with reorder bfs and comm all_gather, then halo:
   the partitioned encode against the single operand's under the same
   parameters (1e-5 + 1e-6 sum|terms|), K1 2 launches an encode and 4 a
   step on every rank (halo: twice that, local and remote), one
   ``train_epoch(mesh=)`` with a finite loss, ``Model.test(mesh=)``,
   ``Scorer(mesh=).score`` on 65,536 pairs (DOT and MLP); one epoch in
   bf16 (only K1-bf16); the build, step and epoch times beside the single
   operand's on the same card; with W = 4 also (data, node) = (2, 2);
33. the collab command through ``torchrun --nproc_per_node=W -m
   plnlp_tpu_torch --num_shards W`` for one epoch;
34. print the card's name and power limit, the ``{"kernels": [...]}`` line
   (K1 to K5, the bf16 K1 and K2, and the bf16 K3, K4 and K5), and
   ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_NODES = 235_868  # ogbl-collab
N_EDGES = 1_179_052
BLOCK = (512, 512)  # cli.py --block_rows/--block_edges defaults
WIDTH = 256
# The training graph: an SBM of collab's size whose communities (~295
# nodes) the label-prop reorder recovers; the CLI's hybrid defaults.
N_COMMUNITIES = 800
TILE = 256  # --tile_size
MIN_FILL = 96  # --tile_min_fill
AUTO_COVERAGE = 0.35  # --tile_auto_coverage
BATCH = 65_536  # --batch_size
SMALL = 10  # the card-vs-CPU step runs at 1/SMALL of the size
# The CLI phases: ogbl-ddi's size for the dense backend; a 200-community
# SBM (300 nodes a community, as collab's 800-community SBM) for
# TRANSFORMER over hybrid; pairs scored by --score_pairs.
DDI_NODES, DDI_EDGES = 4_267, 1_067_911
SBM_NODES, SBM_EDGES, SBM_COMMUNITIES = 60_000, 300_000, 200
CLI_PAIRS = 65_536
# Phase 7's label-prop estimate on the SBM at seed 0 (coverage, tiles), as
# the NumPy sweep made it; the native sweep must give the same.
PHASE7_ESTIMATE = (0.9442, 2658)
# The partitioned path: at most this many ranks, one card each, and how
# long they may take in all.
MAX_RANKS = 4
PARALLEL_TIMEOUT_S = 900
TOL = 1e-4  # rtol = atol for values that are not long sums (h, scores)
# A kernel output is a sum of up to max_degree (26k here) f32 terms, added in
# another order than the plain version adds them (K1's runs and carries, K2's
# compacted nonzeros, vs index_add_ and bmm), so its rounding error scales
# with the sum of the terms' magnitudes, not with the result (hub rows cancel
# to small values while carrying ~1e-3 of rounding).  Kernel checks therefore
# require
#   |kernel - plain| <= SUM_ATOL + SUM_RTOL * sum_e |w_e * x_e|
# where SUM_RTOL is ~16 float32 unit roundoffs; a dropped or doubled edge
# moves a row by |w * x| ~ 1, far outside it.
SUM_ATOL = 1e-5
SUM_RTOL = 1e-6
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) and
# dense bf16 (tensor core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# A bf16 kernel output and its plain version each round an f32 sum once:
# beyond the f32 sums' tolerance they may differ by one bf16 ulp, at most
# 2**-7 of the value.
BF16_RTOL = 2.0 ** -7


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, runs: int) -> float:
    """Median over ``runs`` of the mean per-call time of ``reps`` calls,
    timed with CUDA events after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def errors(got, want):
    """(max abs error, max error relative to max(|want|, 1), allclose)."""
    import torch

    diff = (got - want).abs()
    rel = diff / want.abs().clamp(min=1.0)
    ok = torch.allclose(got, want, rtol=TOL, atol=TOL)
    return float(diff.max()), float(rel.max()), ok


def sum_errors(got, want, abs_sum, ulp_rtol=0.0, sum_rtol=SUM_RTOL):
    """(max abs error, max of error / tolerance, within tolerance) for a
    kernel output against its plain version; ``abs_sum`` is the same sum
    over the terms' magnitudes.  A bf16 output passes ``ulp_rtol`` =
    BF16_RTOL: kernel and plain version each round an f32 sum once to
    bf16, so they may differ by one bf16 ulp beyond the sums' tolerance.
    An f32 sum of terms that were each rounded to bf16 passes ``sum_rtol``
    = SUM_RTOL + BF16_RTOL: a term may round one bf16 ulp apart."""
    diff = (got.float() - want.float()).abs()
    tol = SUM_ATOL + sum_rtol * abs_sum + ulp_rtol * want.float().abs()
    ratio = float((diff / tol).max())
    return float(diff.max()), ratio, ratio <= 1.0


# ---------------------------------------------------------------------------
# The training path over the hybrid operand
# ---------------------------------------------------------------------------


def hybrid_data(num_nodes: int, num_edges: int, num_communities: int, seed: int, dev):
    """Training data as the CLI builds it for ``--adj_backend=auto`` on a
    community-structured graph: the label-prop estimate, the id-space
    relabel (no per-call permutations), the perm-free hybrid operand and
    the plain CSR twin for the negative sampler."""
    from plnlp_tpu_torch import prepare_graph
    from plnlp_tpu_torch.data import make_synthetic_dataset
    from plnlp_tpu_torch.graph import to_undirected_edges
    from plnlp_tpu_torch.ops.tile_spmm import build_hybrid, estimate_hybrid

    t0 = time.perf_counter()
    ds = make_synthetic_dataset(
        "hits-sbm", num_nodes=num_nodes, num_edges=num_edges,
        num_communities=num_communities, seed=seed,
    )
    src, dst, _ = to_undirected_edges(*ds["edge_index"], None, num_nodes)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = estimate_hybrid(
        src, dst, num_nodes=num_nodes, tile=TILE, min_fill=MIN_FILL, reorder="labelprop"
    )
    t_est = time.perf_counter() - t0
    relabel = np.empty(num_nodes, np.int64)
    relabel[est["order"]] = np.arange(num_nodes)
    edges = (src, dst)  # original ids: with est["order"] the bf16 build needs no sweep
    src, dst = relabel[src], relabel[dst]
    t0 = time.perf_counter()
    hg = build_hybrid(
        src, dst, None, num_nodes=num_nodes, tile=TILE, min_fill=MIN_FILL, block=BLOCK,
        reorder=None, device=dev,
    )
    sample_graph, _ = prepare_graph(src, dst, None, num_nodes=num_nodes, block=None, device=dev)
    t_build = time.perf_counter() - t0
    split = {
        s: {k: relabel[ds["split_edge"][s][e]] for k, e in (("pos", "edge"), ("neg", "edge_neg"))}
        for s in ("valid", "test")
    }
    return {
        "hg": hg, "sample_graph": sample_graph, "split": split, "est": est,
        "pos": relabel[ds["split_edge"]["train"]["edge"]],
        "seconds": (t_gen, t_est, t_build), "edges": edges,
    }


def plain_hybrid_mean(hg, x):
    """``hybrid_spmm(hg, x, "mean")`` through the kernels' plain versions,
    so autograd gives the reference gradient (perm-free operand; x at
    num_nodes rows, or at n_pad rows under padded-carry, whose output rows
    past num_nodes are zero)."""
    import torch

    from plnlp_tpu_torch.ops.scatter_matmul import scatter_matmul_reference
    from plnlp_tpu_torch.ops.tile_matmul import tile_matmul_reference

    n, rows = hg.num_nodes, x.shape[0]
    out = tile_matmul_reference(
        hg.tile_vals, hg.tile_row, hg.tile_col, x, hg.tile_rowptr.shape[0] - 1, rows
    )
    r = hg.res_graph
    if r is not None:
        res = scatter_matmul_reference(
            x, r.blk_src, r.blk_local, r.blk_weight, r.blk_rowptr, r.block_rows, n
        )
        out = out + torch.cat([res, res.new_zeros(rows - n, res.shape[1])])
    deg = hg.in_degrees
    scale = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)
    return out * torch.cat([scale, scale.new_zeros(rows - n)])[:, None]


def abs_operand(hg):
    """The operand with every tile and residual weight made nonnegative:
    its products with |x| are the sums of the terms' magnitudes."""
    res = hg.res_graph
    if res is not None:
        res = dataclasses.replace(res, blk_weight=res.blk_weight.abs())
    return dataclasses.replace(hg, tile_vals=hg.tile_vals.abs(), res_graph=res)


def card_vs_cpu_step(cfg, small, args, dev, loss_tol=1e-5, grad_tol=1e-4, param_atol=1e-5):
    """One train step on the card and the same step on the CPU (the plain
    path), on the training recipe at 1/SMALL of the size (``small``), with
    the CE loss and SGD in place of the epoch's AUC and Adam.

    Why.  Under a pairwise loss such as AUC the gradient of the MLP
    predictor's last bias is exactly 0 and the predictor's other gradients
    at init are the remainder of sums that cancel, so two reduction orders
    differ there by percent: no gradient tolerance that means anything
    holds.  CE has no such direction.  Adam's first step moves an entry by
    lr * g / (|g| + eps), about lr * sign(g), so an entry whose gradient is
    smaller than its rounding error may move 2 * lr apart on the two
    devices; SGD's step is linear in the gradient, so the parameters after
    it can be held to a plain tolerance.

    Tolerances (float32; the bf16 phase passes its own).  The loss within
    ``loss_tol`` = 1e-5 relative; the gradient of each clipping group
    (embedding, encoder, predictor) within ``grad_tol`` = 1e-4 in relative
    L2 norm (f32 sums in another order); every parameter after the step
    within ``param_atol`` = 1e-5, + 1e-5 * |p|."""
    import torch

    from plnlp_tpu_torch.training import Model

    cfg = dataclasses.replace(cfg, loss_func="CE", optimizer="SGD")
    hg, n = small["hg"], small["hg"].num_nodes
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    m_gpu = Model(cfg, n, seed=args.seed + 1, device=dev)
    m_cpu = copy.deepcopy(m_gpu).to("cpu")
    pos = torch.as_tensor(small["pos"][:BATCH], device=dev)
    neg = m_gpu.sample_negatives(gen, small["sample_graph"], pos)
    mask = torch.ones(pos.shape[0], device=dev)
    loss_g = float(m_gpu.train_step(m_gpu.make_optimizer(), hg, None, None, pos, neg, None,
                                    mask, cfg.lr))
    t0 = time.perf_counter()
    loss_c = float(m_cpu.train_step(m_cpu.make_optimizer(), hg.to("cpu"), None, None,
                                    pos.cpu(), neg.cpu(), None, mask.cpu(), cfg.lr))
    cpu_s = time.perf_counter() - t0
    require(abs(loss_g - loss_c) <= loss_tol * abs(loss_c), f"loss card {loss_g} vs CPU {loss_c}")
    pairs = [(k, a, b) for (k, a), (_, b) in zip(m_gpu.named_parameters(), m_cpu.named_parameters())]
    group_err = {}
    for group in ("emb", "encoder", "predictor"):
        members = [(a, b) for k, a, b in pairs if k.split(".")[0] == group]
        require(members, f"parameters of {group}")
        diff = sum(float((a.grad.cpu() - b.grad).square().sum()) for a, b in members)
        ref = sum(float(b.grad.square().sum()) for _, b in members)
        group_err[group] = (diff / max(ref, 1e-60)) ** 0.5
        require(group_err[group] <= grad_tol,
                f"{group} gradient relative L2 error {group_err[group]:.3e}")
    worst_param, worst_ratio = 0.0, 0.0
    for k, a, b in pairs:
        d = (a.detach().cpu() - b.detach()).abs()
        ratio = float((d / (param_atol + 1e-5 * b.detach().abs())).max())
        worst_param, worst_ratio = max(worst_param, float(d.max())), max(worst_ratio, ratio)
        require(ratio <= 1.0, f"{k} after the step: max |diff|/tol {ratio:.3f}")
    log(f"[train] card vs CPU, {cfg.encoder} in {cfg.compute_dtype}: one SGD step with CE at N={n} "
        f"(nt={hg.num_tiles}, batch {pos.shape[0]}): loss {loss_g:.9g} vs {loss_c:.9g} (tol "
        f"{loss_tol} relative); gradient relative L2 error "
        + ", ".join(f"{g} {e:.3e}" for g, e in group_err.items())
        + f" (tol {grad_tol}); parameters after the step max |diff| {worst_param:.3e}, max "
        f"|diff|/tol {worst_ratio:.3f} (tol {param_atol} + 1e-5 |p|); CPU step {cpu_s:.1f} s")


def train_path(args, dev, card):
    """Phases 7-16; returns the entries of K2-K5 in the kernels line, K1's
    launches on the training path (epoch and test), and the SBM data and its
    small twin for the bf16 phases."""
    import torch

    from plnlp_tpu_torch.ops import scatter_matmul as sm
    from plnlp_tpu_torch.ops import tile_matmul as tm
    from plnlp_tpu_torch.ops.spmm import spmm
    from plnlp_tpu_torch.training import Model, ModelConfig

    # 7. training data --------------------------------------------------------
    data = hybrid_data(N_NODES, N_EDGES, N_COMMUNITIES, args.seed, dev)
    hg, est = data["hg"], data["est"]
    n = hg.num_nodes
    n_r = hg.tile_rowptr.shape[0] - 1
    e = hg.dense_edges + hg.res_edges
    tile_bytes = 2 * hg.tile_vals.numel() * hg.tile_vals.element_size()
    t_gen, t_est, t_build = data["seconds"]
    log(f"[train-data] SBM N={n} E={e} (symmetrized), {N_COMMUNITIES} communities; "
        f"estimate (label-prop, T={TILE}, min_fill={MIN_FILL}): coverage "
        f"{est['coverage']:.4f}, {est['num_tiles']} tiles; generate {t_gen:.1f} s, "
        f"estimate {t_est:.1f} s, build {t_build:.1f} s")
    require(est["coverage"] >= AUTO_COVERAGE, f"coverage {est['coverage']} < {AUTO_COVERAGE}")
    if args.seed == 0 and n == 235_868:
        # the native sweep gives the NumPy sweep's labels: the estimate the
        # NumPy sweep made on this graph does not move
        require((round(est["coverage"], 4), est["num_tiles"]) == PHASE7_ESTIMATE,
                f"estimate ({est['coverage']:.4f}, {est['num_tiles']}) != {PHASE7_ESTIMATE}")
    require(hg.res_graph is not None, "the operand has a residual")
    log(f"[train-data] hybrid: nt={hg.num_tiles} over {n_r} row tiles, dense share "
        f"{hg.dense_edges / e:.4f} ({hg.dense_edges} of {e} edges), store "
        f"{hg.tile_vals.dtype}, tiles {tile_bytes / 1e6:.1f} MB in both directions, "
        f"residual {hg.res_edges} edges; {len(data['pos'])} training pairs")

    # 8. K2 and the hybrid operator against their plain versions, with x at
    # num_nodes rows and at n_pad rows (the padded-carry shape every launch
    # of the epoch takes; its pad rows are not zero after the first layer,
    # so here they are random too) --------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n_pad = n_r * TILE
    x_pad = torch.randn(n_pad, WIDTH, device=dev, generator=gen)
    gy_pad = torch.randn(n_pad, WIDTH, device=dev, generator=gen)
    sets = {
        "tile_vals": (hg.tile_vals, hg.tile_row, hg.tile_col, hg.tile_rowptr),
        "tile_vals_t": (hg.tile_vals_t, hg.tile_row_t, hg.tile_col_t, hg.tile_rowptr_t),
    }
    max_abs = 0.0
    hg_abs = abs_operand(hg)
    for rows in (n, n_pad):
        x, gy = x_pad[:rows], gy_pad[:rows]
        for label, (v, r, c, p) in sets.items():
            got = tm.tile_matmul(v, r, c, p, x, rows)
            require(torch.equal(got, tm.tile_matmul(v, r, c, p, x, rows)),
                    f"tile_matmul on {label}: a second launch differs")
            want = tm.tile_matmul_reference(v, r, c, x, n_r, rows)
            scale = tm.tile_matmul_reference(v.abs(), r, c, x.abs(), n_r, rows)
            torch.cuda.synchronize()
            ea, ratio, ok = sum_errors(got, want, scale)
            max_abs = max(max_abs, ea)
            log(f"[check] tile_matmul on {label}, x at {rows} rows: max_abs={ea:.3e} max "
                f"err/tol={ratio:.3f} (tol {SUM_ATOL} + {SUM_RTOL}*sum|v x|) ok={ok}")
            require(ok, f"tile_matmul on {label} at {rows} rows disagrees with its plain version")
            require(not got[n:].any(), f"tile_matmul on {label}: rows past num_nodes not zero")
        del got, want, scale
        xk = x.clone().requires_grad_(True)
        out_k = spmm(hg, xk, reduce="mean")
        out_k.backward(gy)
        xr = x.clone().requires_grad_(True)
        out_r = plain_hybrid_mean(hg, xr)
        out_r.backward(gy)
        xa = x.abs().requires_grad_(True)
        out_a = plain_hybrid_mean(hg_abs, xa)
        out_a.backward(gy.abs())
        torch.cuda.synchronize()
        require(out_k.shape == (rows, WIDTH), f"hybrid_spmm output {tuple(out_k.shape)}")
        for label, a, b, sc in (("fwd", out_k.detach(), out_r.detach(), out_a.detach()),
                                ("grad", xk.grad, xr.grad, xa.grad)):
            ea, ratio, ok = sum_errors(a, b, sc)
            log(f"[check] hybrid_spmm mean {label}, x at {rows} rows, vs autograd through "
                f"the plain versions: max_abs={ea:.3e} max err/tol={ratio:.3f} ok={ok}")
            require(ok, f"hybrid_spmm mean {label} at {rows} rows disagrees with the plain versions")
            require(not a[n:].any(), f"hybrid_spmm mean {label}: rows past num_nodes not zero")
        del xk, xr, xa, out_k, out_r, out_a
    del hg_abs, gy_pad

    # 9. one epoch and Model.test through the hybrid path ---------------------
    cfg = ModelConfig(
        encoder="SAGE", predictor="MLP", loss_func="AUC", neg_sampler="global",
        gnn_num_layers=2, emb_hidden_channels=WIDTH, gnn_hidden_channels=WIDTH,
        mlp_hidden_channels=WIDTH, batch_size=BATCH, num_neg=1,
    )
    model = Model(cfg, n, seed=args.seed, device=dev)
    opt = model.make_optimizer()
    steps = math.ceil(len(data["pos"]) / BATCH)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    loss = model.train_epoch(
        opt, hg, None, None, data["pos"], None, gen, cfg.lr, sample_graph=data["sample_graph"]
    )
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    k2_epoch, k1_epoch = tm.LAUNCHES, sm.LAUNCHES
    require(tm.LAUNCHES_BF16 == 0 and sm.LAUNCHES_BF16 == 0, "a bf16 kernel ran in float32")
    log(f"[train] one epoch: {steps} steps, mean loss {loss:.6g}, {k2_epoch} tile_matmul "
        f"and {k1_epoch} scatter_matmul launches; {epoch_s:.3f} s; card {card}")
    # the epoch's loss is the count-weighted mean of every step's loss, so
    # it is finite only if every step's is
    require(math.isfinite(loss), f"epoch loss {loss}")
    require(k2_epoch == 4 * steps and k1_epoch == 4 * steps,
            f"{k2_epoch}/{k1_epoch} launches in {steps} steps (want 4 each a step)")
    zero_counts()
    hits = model.test(hg, None, None, data["split"], "hits")
    torch.cuda.synchronize()
    k2_test, k1_test = tm.LAUNCHES, sm.LAUNCHES
    require(k2_test == 2 and k1_test == 2, f"{k2_test}/{k1_test} launches in one encode")
    require(all(0.0 <= v <= 1.0 for pair in hits.values() for v in pair), f"hits {hits}")
    log(f"[train] Model.test over the hybrid operand: {k2_test} tile_matmul and {k1_test} "
        f"scatter_matmul launches (2 per encode); {json.dumps(hits)}")

    # 10. the card against the CPU ------------------------------------------
    small = hybrid_data(
        N_NODES // SMALL, N_EDGES // SMALL, N_COMMUNITIES // SMALL, args.seed + 1, dev
    )
    card_vs_cpu_step(cfg, small, args, dev)

    # 11. timings -------------------------------------------------------------
    pos_b = torch.as_tensor(data["pos"][:BATCH], device=dev)
    neg_b = model.sample_negatives(gen, data["sample_graph"], pos_b)
    ones = torch.ones(BATCH, device=dev)
    step_ms = cuda_ms(
        lambda: model.train_step(opt, hg, None, None, pos_b, neg_b, None, ones, cfg.lr),
        reps=3, runs=3,
    )
    # K2 at the epoch's shape: x and out at n_pad rows
    k2_ms = {
        label: cuda_ms(lambda a=a: tm.tile_matmul(*a, x_pad, n_pad), reps=10, runs=5)
        for label, a in sets.items()
    }
    v, r, c, p = sets["tile_vals"]
    plain_ms = cuda_ms(lambda: tm.tile_matmul_reference(v, r, c, x_pad, n_r, n_pad),
                       reps=2, runs=3)
    nz = v.nonzero()
    nnz = int(nz.shape[0])
    rows = r[nz[:, 0]].long() * TILE + nz[:, 1]
    cols = c[nz[:, 0]].long() * TILE + nz[:, 2]
    adj = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), v[nz[:, 0], nz[:, 1], nz[:, 2]].float(), (n_pad, n_pad),
        check_invariants=True,
    ).coalesce().to_sparse_csr()
    lib_err = float((torch.sparse.mm(adj, x_pad) - tm.tile_matmul(v, r, c, p, x_pad, n_pad))
                    .abs().max())
    library_ms = cuda_ms(lambda: torch.sparse.mm(adj, x_pad), reps=20, runs=5)
    res = hg.res_graph
    res_ms = cuda_ms(lambda: sm.scatter_matmul(
        x_pad, res.blk_src, res.blk_local, res.blk_weight, res.blk_rowptr, res.block_rows, n
    ), reps=10, runs=5)
    # Least time for the same function on these inputs: vals, x and out once
    # each plus the indices; one multiply-add per nonzero of the tiles and
    # column of x (2 nnz D).  Beside it: the row gather the kernel adds (one
    # x row per nonzero), and the dense tile products (2 nt T^2 D) that the
    # TPU kernel's shape runs and this kernel skips.
    nbytes = (v.numel() * v.element_size() + 2 * n_pad * WIDTH * 4
              + (2 * hg.num_tiles + n_r + 1) * 4)
    flops = 2 * nnz * WIDTH
    dense_flops = 2 * hg.num_tiles * TILE * TILE * WIDTH
    gather_bytes = nnz * WIDTH * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[time] tile_matmul tile_vals {k2_ms['tile_vals']:.4f} ms, tile_vals_t "
        f"{k2_ms['tile_vals_t']:.4f} ms (x at {n_pad} rows); plain {plain_ms:.4f} ms; "
        f"torch.sparse.mm (CSR of the {nnz} dense-tile edges) {library_ms:.4f} ms (max_abs "
        f"vs kernel {lib_err:.3e}); bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB "
        f"take {t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP take {t_ops:.4f} ms); its row "
        f"gather, {gather_bytes / 1e9:.3f} GB, takes {gather_bytes / HBM_BYTES_PER_S * 1e3:.4f} "
        f"ms from HBM; the dense tile products it skips, {dense_flops / 1e9:.3f} GFLOP, "
        f"take {dense_flops / F32_FLOPS * 1e3:.4f} ms at the f32 peak; card {card}")
    log(f"[time] scatter_matmul on the residual ({hg.res_edges} edges) {res_ms:.4f} ms; "
        f"train step (batch {BATCH}, 2-layer SAGE + MLP, hybrid) {step_ms:.3f} ms; "
        f"epoch {epoch_s:.3f} s ({steps} steps, sampling included); card {card}")
    k2 = {
        "name": "tile_matmul",
        "route": "cuda",
        "source": "plnlp_tpu_torch/csrc/tile_matmul.cu",
        "replaces": "plnlp_tpu/ops/pallas_tiles.py:62",
        "launches": k2_epoch + k2_test,
        "max_abs_err": max_abs,
        "ms": k2_ms["tile_vals"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    del model, opt, adj, x_pad, pos_b, neg_b
    flash = transformer_path(args, dev, card, cfg, data, small, gen)
    return [k2, *flash], k1_epoch + k1_test, data, small


# ---------------------------------------------------------------------------
# TRANSFORMER over the hybrid operand
# ---------------------------------------------------------------------------


def flash_bwd_magnitudes(vals, tile_row, tile_col, q, k, v, g, stats, scale, transposed):
    """The sums of the terms' magnitudes of K4's dq (the row-sorted set) or
    of K5's dk and dv (``transposed``), chunk by chunk as the plain versions
    run: Σ_j |ds_ij| |k_j| with |ds| bounded by α (|g|·|v| + |δ|) scale, and
    Σ α |g| for dv."""
    import torch

    from plnlp_tpu_torch.ops.flash_tiles import _chunks, _row_stats, _tiles

    t, (rows, d) = vals.shape[1], q.shape
    n_r = -(-rows // t)
    qt, kt, vt, gt = (_tiles(a, n_r, t) for a in (q, k, v, g))
    m, den, delta = _row_stats(stats, n_r, t)
    out = [qt.new_zeros((n_r, t, d)) for _ in range(2 if transposed else 1)]
    for c in _chunks(vals.shape[0]):
        r, cc = tile_row[c].long(), tile_col[c].long()
        if transposed:  # rows are sources r, columns destinations cc
            s = torch.bmm(kt[r], qt[cc].transpose(1, 2)) * scale
            gv = torch.bmm(vt[r].abs(), gt[cc].abs().transpose(1, 2))
            st = [a[cc][:, None, :] for a in (m, den, delta)]
        else:
            s = torch.bmm(qt[r], kt[cc].transpose(1, 2)) * scale
            gv = torch.bmm(gt[r].abs(), vt[cc].abs().transpose(1, 2))
            st = [a[r][:, :, None] for a in (m, den, delta)]
        alpha = torch.where(vals[c] != 0, torch.exp(s - st[0]) / st[1], 0.0)
        ds = alpha * (gv + st[2].abs()) * scale
        if transposed:
            out[0].index_add_(0, r, torch.bmm(ds, qt[cc].abs()))
            out[1].index_add_(0, r, torch.bmm(alpha, gt[cc].abs()))
        else:
            out[0].index_add_(0, r, torch.bmm(ds, kt[cc].abs()))
    return [o.reshape(-1, d)[:rows] for o in out]


def fwd_errors(num, ml, num_r, ml_r, num_a, sum_rtol=SUM_RTOL):
    """K3's (num, ml) against the plain version's (num_r, ml_r), with
    ``num_a`` the plain num over |v|: (max error / tolerance over y = num /
    den, m and den; whether the rows without a tile edge are exactly
    (0, 0, -inf); the mask of the rows with one).  bf16 features pass
    ``sum_rtol`` = SUM_RTOL + BF16_RTOL (each p is rounded to bf16 before
    its product with v, against the kernel's running max)."""
    import torch

    has = ml_r[:, 1] > 0
    den_r = ml_r[:, 1].clamp(min=1e-30)[:, None]
    y_err = ((num / ml[:, 1:].clamp(min=1e-30) - num_r / den_r).abs()[has]
             / (SUM_ATOL + sum_rtol * num_a / den_r)[has])
    m_err = (ml[has, 0] - ml_r[has, 0]).abs() / (1e-6 * (1 + ml_r[has, 0].abs()))
    den_err = (ml[has, 1] - ml_r[has, 1]).abs() / (1e-5 * ml_r[has, 1])
    ratio = max(float(y_err.max()), float(m_err.max()), float(den_err.max()))
    empty_ok = (not num[~has].any() and not ml[~has, 1].any()
                and bool(torch.isneginf(ml[~has, 0]).all()))
    return ratio, empty_ok, has


def check_flash_kernels(fwd_set, bwd_set, q, k, v, g, n):
    """Phases 12 and 27: K3, K4 and K5 against their plain versions on the
    tile sets ``fwd_set`` and ``bwd_set`` (vals, tile_row, tile_col,
    tile_rowptr), with q, k, v, g of one (rows, D) shape and dtype (f32, or
    bf16 for the bf16 entry points); rows from ``n`` on have no edge and
    must come out empty; a second launch of K3, of K4 and of K5 must give
    the same bits (each row's sum runs in one order).  Returns the stats
    (M, den, δ) the backward checks used and each kernel's max abs error."""
    import torch

    from plnlp_tpu_torch.ops import flash_tiles as ft

    n_pad = q.shape[0]
    scale = 1.0 / math.sqrt(q.shape[1])
    n_r = fwd_set[3].shape[0] - 1
    errs = {}
    bf16 = q.dtype == torch.bfloat16
    # bf16: each term's weight is rounded to bf16 before its product, so a
    # term may land one bf16 ulp (2**-7 of it) from the plain version's
    sum_rtol = SUM_RTOL + (BF16_RTOL if bf16 else 0.0)
    label = " bf16" if bf16 else ""

    # K3: y = num / den within 1e-5 + 1e-6 Σ p|v| / den (+ 2**-7 Σ p|v| / den
    # in bf16), m within 1e-6 (1 + |m|), den within 1e-5 relative (a sum of
    # positive f32 terms); rows with no tile edge, the pad rows among them,
    # exactly (0, 0, -inf)
    num, ml = ft.flash_tiles_fwd(*fwd_set, q, k, v, scale)
    again = ft.flash_tiles_fwd(*fwd_set, q, k, v, scale)
    num_r, ml_r = ft.flash_tiles_fwd_reference(*fwd_set[:3], q, k, v, n_r, scale)
    num_a, _ = ft.flash_tiles_fwd_reference(*fwd_set[:3], q, k, v.abs(), n_r, scale)
    torch.cuda.synchronize()
    same = torch.equal(num, again[0]) and torch.equal(ml, again[1])
    log(f"[check] flash_tiles_fwd{label}: a second launch gives the same bits: {same}")
    require(same, f"flash_tiles_fwd{label}: a second launch differs")
    ratio, empty_ok, has = fwd_errors(num, ml, num_r, ml_r, num_a, sum_rtol)
    errs["fwd"] = float((num - num_r).abs().max())
    log(f"[check] flash_tiles_fwd{label} (K3) on {fwd_set[0].dtype} tiles at {n_pad} rows: "
        f"max_abs num {errs['fwd']:.3e}; max err/tol {ratio:.3f} (y {SUM_ATOL} + {sum_rtol:.4g}"
        f"*sum p|v|/den, m 1e-6 (1+|m|), den 1e-5 den); {int(has.sum())} rows with a tile edge; "
        f"rows without one (0, 0, -inf): {empty_ok}")
    require(ratio <= 1.0 and empty_ok, f"flash_tiles_fwd{label} disagrees with its plain version")
    require(not has[n:].any(), "flash_tiles_fwd: a pad row has a tile edge")

    # the stats the backward gets: the global max and denominator of these
    # tiles, and δ = Σ_d g·y
    m_glob = torch.where(torch.isfinite(ml_r[:, 0]), ml_r[:, 0], 0.0)
    den_glob = ml_r[:, 1].clamp(min=torch.finfo(torch.float32).tiny)
    delta = (g.float() * num_r / den_glob[:, None]).sum(-1)
    stats = torch.stack([m_glob, den_glob, delta], 1).contiguous()
    del num, ml, again, num_r, num_a

    # K4, K5: within 1e-5 + 1e-6 Σ|terms|; rows past num_nodes zero; a
    # second launch bitwise equal
    for kind, tiles, fn, ref in (
        ("dq", fwd_set, ft.flash_tiles_dq, ft.flash_tiles_dq_reference),
        ("dkv", bwd_set, ft.flash_tiles_dkv, ft.flash_tiles_dkv_reference),
    ):
        got = fn(*tiles, q, k, v, g, stats, scale)
        again = fn(*tiles, q, k, v, g, stats, scale)
        want = ref(*tiles[:3], q, k, v, g, stats, n_r, scale)
        mags = flash_bwd_magnitudes(*tiles[:3], q, k, v, g, stats, scale, kind == "dkv")
        if kind == "dq":
            got, again, want = [got], [again], [want]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"[check] flash_tiles_{kind}{label}: a second launch gives the same bits: {same}")
        require(same, f"flash_tiles_{kind}{label}: a second launch differs")
        errs[kind] = 0.0
        for name, a, b, sc in zip(("dq",) if kind == "dq" else ("dk", "dv"), got, want, mags):
            ea, ratio, ok = sum_errors(a, b, sc, sum_rtol=sum_rtol)
            errs[kind] = max(errs[kind], ea)
            log(f"[check] flash_tiles_{kind}{label} ({'K4' if kind == 'dq' else 'K5'}) {name} "
                f"on {tiles[0].dtype} tiles at {n_pad} rows: max_abs={ea:.3e} max err/tol="
                f"{ratio:.3f} (tol {SUM_ATOL} + {sum_rtol:.4g}*sum|terms|) ok={ok}")
            require(ok, f"flash_tiles_{kind}{label} {name} disagrees with its plain version")
            require(not a[n:].any(), f"flash_tiles_{kind} {name}: rows past num_nodes not zero")
        del got, again, want, mags
    return stats, errs


def check_transformer_conv(hg, sample_graph, n, gen, dev):
    """Phase 13: one TRANSFORMER layer at width 256 over the hybrid operand
    (x at the padded-carry n_pad rows) against autograd through the
    per-edge path over the plain CSR twin (x at num_nodes rows), for the
    rows past num_nodes a zero cotangent.  Values within rtol = atol =
    1e-4; the gradient of x and of each linear (weight and bias together)
    within 1e-4 in relative L2 norm.  (The key bias alone is not held: it
    adds q_i·b to every logit of row i, which the softmax cancels, so its
    gradient is 0 up to rounding residue.)"""
    import torch

    from plnlp_tpu_torch.models import Encoder
    from plnlp_tpu_torch.models.encoders import _transformer_conv
    from plnlp_tpu_torch.ops.tile_attention import hybrid_transformer_conv

    n_pad = (hg.tile_rowptr.shape[0] - 1) * TILE
    lp = Encoder(torch.Generator().manual_seed(1), "TRANSFORMER", WIDTH, WIDTH, 1).to(dev).layers[0]
    x = torch.randn(n_pad, WIDTH, device=dev, generator=gen)
    gy = torch.randn(n, WIDTH, device=dev, generator=gen)
    grads = []
    for run in ("hybrid", "per-edge"):
        lp.zero_grad(set_to_none=True)
        xr = (x if run == "hybrid" else x[:n]).clone().requires_grad_(True)
        out = (hybrid_transformer_conv(lp, hg, xr) if run == "hybrid"
               else _transformer_conv(lp, sample_graph, None, xr))
        (out[:n] * gy).sum().backward()
        grads.append([out[:n].detach(), xr.grad[:n]] + [
            torch.cat([lin.weight.grad.reshape(-1), lin.bias.grad]) for lin in lp.values()])
        if run == "hybrid":
            require(out.shape == (n_pad, WIDTH), f"conv output {tuple(out.shape)}")
            require(not xr.grad[n:].any(), "conv: gradient of the pad rows not zero")
        del out, xr
    torch.cuda.synchronize()
    names = ["x", *lp.keys()]
    ea, er, ok = errors(grads[0][0], grads[1][0])
    require(ok, f"hybrid_transformer_conv values: max_abs {ea:.3e} max_rel {er:.3e}")
    rel = {}
    for name, a, b in zip(names, grads[0][1:], grads[1][1:]):
        rel[name] = float((a - b).norm() / b.norm().clamp(min=1e-30))
        require(rel[name] <= 1e-4, f"conv gradient of {name}: relative L2 error {rel[name]:.3e}")
    log(f"[check] hybrid_transformer_conv (x at {n_pad} rows) vs autograd through the per-edge "
        f"path on the CSR twin: values max_abs={ea:.3e} max_rel={er:.3e}; gradient relative L2 "
        f"error max {max(rel.values()):.3e} (x {rel['x']:.3e}; tol 1e-4)")


def transformer_path(args, dev, card, cfg, data, small, gen):
    """Phases 12-16; returns the entries of K3, K4 and K5 in the kernels
    line."""
    import torch

    from plnlp_tpu_torch.ops import flash_tiles as ft
    from plnlp_tpu_torch.ops import scatter_matmul as sm
    from plnlp_tpu_torch.ops import tile_matmul as tm
    from plnlp_tpu_torch.serve import Scorer
    from plnlp_tpu_torch.training import Model

    hg = data["hg"]
    n = hg.num_nodes
    n_pad = (hg.tile_rowptr.shape[0] - 1) * TILE

    # 12, 13. the kernels and the conv against their plain versions --------
    fwd_set = (hg.tile_vals, hg.tile_row, hg.tile_col, hg.tile_rowptr)
    bwd_set = (hg.tile_vals_t, hg.tile_row_t, hg.tile_col_t, hg.tile_rowptr_t)
    q, k, v, g = (torch.randn(n_pad, WIDTH, device=dev, generator=gen) for _ in range(4))
    stats, errs = check_flash_kernels(fwd_set, bwd_set, q, k, v, g, n)
    check_transformer_conv(hg, data["sample_graph"], n, gen, dev)

    # 14. one epoch, Model.test and Scorer.score ------------------------------
    cfg = dataclasses.replace(cfg, encoder="TRANSFORMER")
    model = Model(cfg, n, seed=args.seed, device=dev)
    opt = model.make_optimizer()
    steps = math.ceil(len(data["pos"]) / BATCH)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    loss = model.train_epoch(
        opt, hg, None, None, data["pos"], None, gen, cfg.lr, sample_graph=data["sample_graph"]
    )
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch = dict(ft.LAUNCHES)
    log(f"[transformer] one epoch: {steps} steps, mean loss {loss:.6g}, launches {epoch} "
        f"(K1 {sm.LAUNCHES}, K2 {tm.LAUNCHES}); {epoch_s:.3f} s; card {card}")
    require(math.isfinite(loss), f"TRANSFORMER epoch loss {loss}")
    require(epoch == {"fwd": 2 * steps, "dq": 2 * steps, "dkv": 2 * steps},
            f"{epoch} launches in {steps} steps (want 2 of each a step)")
    require(tm.LAUNCHES == 0 and sm.LAUNCHES == 0, "K1/K2 launched on the TRANSFORMER path")
    ft.LAUNCHES.update(fwd=0, dq=0, dkv=0)
    t0 = time.perf_counter()
    hits = model.test(hg, None, None, data["split"], "hits")
    torch.cuda.synchronize()
    test_ms = (time.perf_counter() - t0) * 1e3
    test = dict(ft.LAUNCHES)
    require(test == {"fwd": 2, "dq": 0, "dkv": 0}, f"{test} launches in one encode")
    require(all(0.0 <= v <= 1.0 for pair in hits.values() for v in pair), f"hits {hits}")
    ft.LAUNCHES.update(fwd=0, dq=0, dkv=0)
    rng = np.random.default_rng(args.seed)
    pairs = rng.integers(0, n, (65_536, 2))
    scorer = Scorer(model, hg, exclude_graph=data["sample_graph"])
    scores = scorer.score(pairs)
    torch.cuda.synchronize()
    serve = dict(ft.LAUNCHES)
    require(serve == {"fwd": 2, "dq": 0, "dkv": 0}, f"{serve} launches in the Scorer's encode")
    require(scores.shape == (65_536,) and np.isfinite(scores).all(), "TRANSFORMER scores")
    require(tm.LAUNCHES == 0 and sm.LAUNCHES == 0, "K1/K2 launched by the TRANSFORMER encode")
    # ranking over the hybrid operand excludes the known edges of its CSR
    # twin; without exclude_graph it must refuse
    srcs = rng.integers(0, n, 300)
    ids, top = scorer.rank_candidates_batch(srcs, k=50, exclude_edges=True)
    require(ids.shape == (300, 50) and np.isfinite(top).all(), "TRANSFORMER rank")
    sg = data["sample_graph"]
    indptr, senders = sg.indptr.cpu().numpy(), sg.senders.cpu().numpy()
    for row, s in zip(ids, srcs):
        require(not set(row.tolist()) & set(senders[indptr[s]:indptr[s + 1]].tolist()),
                f"a known neighbor of {s} ranked")
    try:
        Scorer(model, hg).rank_candidates_batch(srcs[:4], k=50, exclude_edges=True)
        refused = False
    except ValueError as exc:
        refused = "exclude_graph" in str(exc)
    require(refused, "Scorer over the hybrid operand without exclude_graph did not refuse "
                     "exclude_edges with a ValueError naming exclude_graph")
    log(f"[transformer] Model.test: {test} launches, {test_ms:.1f} ms (host clock, the encode and "
        f"the valid and test pairs); {json.dumps(hits)}; Scorer.score on 65536 "
        f"pairs finite, {serve} launches; rank 300 sources k=50 over the hybrid operand, known "
        f"neighbors (exclude_graph = the CSR twin) excluded, scores finite; without "
        f"exclude_graph: ValueError")

    # 15. the card against the CPU ------------------------------------------
    card_vs_cpu_step(cfg, small, args, dev)

    # 16. timings -------------------------------------------------------------
    pos_b = torch.as_tensor(data["pos"][:BATCH], device=dev)
    neg_b = model.sample_negatives(gen, data["sample_graph"], pos_b)
    ones = torch.ones(BATCH, device=dev)
    step_ms = cuda_ms(
        lambda: model.train_step(opt, hg, None, None, pos_b, neg_b, None, ones, cfg.lr),
        reps=3, runs=3,
    )
    encode_ms = cuda_ms(lambda: model.encode(hg), reps=3, runs=3)
    scale = 1.0 / math.sqrt(WIDTH)
    n_r = n_pad // TILE
    calls = {
        "fwd": (lambda: ft.flash_tiles_fwd(*fwd_set, q, k, v, scale),
                lambda: ft.flash_tiles_fwd_reference(*fwd_set[:3], q, k, v, n_r, scale)),
        "dq": (lambda: ft.flash_tiles_dq(*fwd_set, q, k, v, g, stats, scale),
               lambda: ft.flash_tiles_dq_reference(*fwd_set[:3], q, k, v, g, stats, n_r, scale)),
        "dkv": (lambda: ft.flash_tiles_dkv(*bwd_set, q, k, v, g, stats, scale),
                lambda: ft.flash_tiles_dkv_reference(*bwd_set[:3], q, k, v, g, stats, n_r,
                                                     scale)),
    }
    # Least time for the same function on these inputs: the tiles (one int8
    # read), each (n_pad, 256) f32 input read once and output written once,
    # the stats and the indices; 4, 6 and 8 FLOP per nonzero and feature
    # column (K3: q.k and p v; K4: q.k, g.v and ds k; K5: k.q, v.g, ds q and
    # a g).  Printed beside the bound, not as it: the dense tile products
    # (T^2 per tile in place of the nonzeros), which the kernels skip, and
    # the row gather they add (two rows of 256 f32 a nonzero: k and v for K3
    # and K4, q and g for K5 with the destination's stats).
    nnz = int((hg.tile_vals != 0).sum())
    feat_bytes = n_pad * WIDTH * 4
    idx_bytes = (2 * hg.num_tiles + n_r + 1) * 4
    vals_bytes = hg.tile_vals.numel() * hg.tile_vals.element_size()
    shape = {  # (feature arrays read + written, stats columns, FLOP per nonzero per column)
        "fwd": (4, 2, 4), "dq": (5, 3, 6), "dkv": (6, 3, 8),
    }
    entries = []
    data["transformer_f32"] = {}
    for kind, (kernel, plain) in calls.items():
        ms = cuda_ms(kernel, reps=5, runs=3)
        data["transformer_f32"][kind] = ms
        plain_ms = cuda_ms(plain, reps=1, runs=3)
        arrays, stat_cols, per = shape[kind]
        nbytes = vals_bytes + arrays * feat_bytes + n_pad * stat_cols * 4 + idx_bytes
        flops = per * nnz * WIDTH
        dense = per * hg.num_tiles * TILE * TILE * WIDTH
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        gather = nnz * (2 * WIDTH * 4 + (12 if kind == "dkv" else 0))
        log(f"[time] flash_tiles_{kind} {ms:.4f} ms (q, k, v, g at {n_pad} rows); plain "
            f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB take "
            f"{t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP on {nnz} nonzeros take {t_ops:.4f} ms); "
            f"its row gather, {gather / 1e9:.3f} GB, takes {gather / HBM_BYTES_PER_S * 1e3:.4f} "
            f"ms from HBM; the dense tile products it skips, {dense / 1e9:.3f} GFLOP, take "
            f"{dense / F32_FLOPS * 1e3:.4f} ms at the f32 peak; card {card}")
        entries.append({
            "name": f"flash_tiles_{kind}",
            "route": "cuda",
            "source": "plnlp_tpu_torch/csrc/flash_tiles.cu",
            "replaces": {"fwd": "plnlp_tpu/ops/pallas_attention.py:104",
                         "dq": "plnlp_tpu/ops/pallas_attention.py:216",
                         "dkv": "plnlp_tpu/ops/pallas_attention.py:303"}[kind],
            "launches": epoch[kind] + test[kind] + serve[kind],
            "max_abs_err": errs[kind],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes tile-local softmax partials
            # merged across a row tile's tiles (per-tile
            # scaled_dot_product_attention normalises each tile alone)
            "library_ms": None,
        })
    log(f"[time] TRANSFORMER train step (batch {BATCH}, 2 layers + MLP, hybrid) {step_ms:.3f} ms; "
        f"epoch {epoch_s:.3f} s ({steps} steps, sampling included); encode {encode_ms:.3f} ms; "
        f"card {card}")
    data["transformer_f32"].update(step_ms=step_ms, epoch_s=epoch_s, encode_ms=encode_ms)
    return entries


# ---------------------------------------------------------------------------
# bfloat16 compute: K1 and K2 in bf16, SAGE in bf16, the CLI in bf16
# ---------------------------------------------------------------------------


def launch_counts():
    """Every kernel's launch count, by kernel and, for K1 and K2, dtype."""
    from plnlp_tpu_torch.ops import flash_tiles as ft
    from plnlp_tpu_torch.ops import scatter_matmul as sm
    from plnlp_tpu_torch.ops import tile_matmul as tm

    return {"K1": sm.LAUNCHES, "K1bf16": sm.LAUNCHES_BF16, "K2": tm.LAUNCHES,
            "K2bf16": tm.LAUNCHES_BF16, "K3": ft.LAUNCHES["fwd"], "K4": ft.LAUNCHES["dq"],
            "K5": ft.LAUNCHES["dkv"], "K3bf16": ft.LAUNCHES_BF16["fwd"],
            "K4bf16": ft.LAUNCHES_BF16["dq"], "K5bf16": ft.LAUNCHES_BF16["dkv"]}


def zero_counts() -> None:
    from plnlp_tpu_torch.ops import flash_tiles as ft
    from plnlp_tpu_torch.ops import scatter_matmul as sm
    from plnlp_tpu_torch.ops import tile_matmul as tm

    sm.LAUNCHES = sm.LAUNCHES_BF16 = tm.LAUNCHES = tm.LAUNCHES_BF16 = 0
    ft.LAUNCHES.update(fwd=0, dq=0, dkv=0)
    ft.LAUNCHES_BF16.update(fwd=0, dq=0, dkv=0)


def library_call_ms(fn):
    """(ms, None) for one PyTorch library call, or (None, the error it
    raised) where PyTorch does not run it on these inputs (a sparse product
    in bf16, say); the port never calls it."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    return cuda_ms(fn, reps=20, runs=5), None


def k1_bf16_phase(graph, graph_t, data, gen, card):
    """Phase 20: K1 in bf16 against its plain version over the collab graph
    and its transpose (x (N, 256)) and the SBM operand's residual (x at the
    padded-carry n_pad rows), a second launch bitwise equal; then its time,
    the plain version's, ``torch.sparse.mm`` on a bf16 CSR, and its bound."""
    import torch

    from plnlp_tpu_torch.ops import scatter_matmul as sm

    n = graph.num_nodes
    hg = data["hg"]
    res = hg.res_graph
    n_pad = (hg.tile_rowptr.shape[0] - 1) * TILE
    x = torch.randn(n, WIDTH, device=graph.blk_src.device, generator=gen).to(torch.bfloat16)
    x_res = torch.randn(n_pad, WIDTH, device=x.device, generator=gen).to(torch.bfloat16)
    max_abs = 0.0
    for label, g, xx, rows in (("graph", graph, x, n), ("graph_t", graph_t, x, n),
                               ("the SBM residual", res, x_res, hg.num_nodes)):
        kargs = (g.blk_src, g.blk_local, g.blk_weight, g.blk_rowptr, g.block_rows, rows)
        got = sm.scatter_matmul(xx, *kargs)
        require(got.dtype == torch.bfloat16 and torch.equal(got, sm.scatter_matmul(xx, *kargs)),
                f"scatter_matmul bf16 on {label}: a second launch differs")
        want = sm.scatter_matmul_reference(xx, *kargs)
        abs_sum = sm.scatter_matmul_reference(xx.float().abs(), g.blk_src, g.blk_local,
                                              g.blk_weight.abs(), *kargs[3:])
        torch.cuda.synchronize()
        ea, ratio, ok = sum_errors(got, want, abs_sum, BF16_RTOL)
        max_abs = max(max_abs, ea)
        log(f"[bf16] scatter_matmul bf16 on {label} ({rows} rows): max_abs={ea:.3e} max err/tol="
            f"{ratio:.3f} (tol {SUM_ATOL} + {SUM_RTOL}*sum|w x| + {BF16_RTOL}*|plain|); a second "
            f"launch gives the same bits")
        require(ok, f"scatter_matmul bf16 on {label} disagrees with its plain version")
        require(not got[(g.in_degrees == 0).nonzero()[:, 0]].any(),
                f"scatter_matmul bf16 on {label}: a row no edge reaches is not zero")
    del got, want, abs_sum
    kargs = (graph.blk_src, graph.blk_local, graph.blk_weight, graph.blk_rowptr, BLOCK[0], n)
    ms = cuda_ms(lambda: sm.scatter_matmul(x, *kargs), reps=20, runs=5)
    plain_ms = cuda_ms(lambda: sm.scatter_matmul_reference(x, *kargs), reps=3, runs=3)
    adj = torch.sparse_csr_tensor(graph.indptr.long(), graph.senders.long(),
                                  graph.edge_weight.to(torch.bfloat16), size=(n, n))
    library_ms, lib_err = library_call_ms(lambda: torch.sparse.mm(adj, x))
    res_ms = cuda_ms(lambda: sm.scatter_matmul(
        x_res, res.blk_src, res.blk_local, res.blk_weight, res.blk_rowptr, res.block_rows,
        hg.num_nodes), reps=10, runs=5)
    # Least time for the same work: x (bf16) read once, out (bf16) written
    # once, the blocked metadata (12 bytes a slot) and the row pointer; the
    # multiply-adds of the real edges at the bf16 peak.
    e, nblk = graph.num_edges, graph.blk_src.shape[0]
    nbytes = 2 * n * WIDTH * 2 + nblk * BLOCK[1] * 12 + graph.blk_rowptr.numel() * 4
    flops = 2 * e * WIDTH
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    gather = e * WIDTH * 2
    log(f"[time] scatter_matmul bf16 graph {ms:.4f} ms (N={n}, D={WIDTH}, E={e}); plain "
        f"{plain_ms:.4f} ms; torch.sparse.mm (bf16 CSR) "
        + (f"{library_ms:.4f} ms" if library_ms is not None else f"not run: {lib_err}")
        + f"; bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB take {t_bytes:.4f} ms, "
        f"{flops / 1e9:.3f} GFLOP take {t_ops:.4f} ms at the bf16 peak); its row gather, "
        f"{gather / 1e9:.3f} GB, takes {gather / HBM_BYTES_PER_S * 1e3:.4f} ms from HBM; on the "
        f"SBM residual ({hg.res_edges} edges, x at {n_pad} rows) {res_ms:.4f} ms; card {card}")
    return {
        "name": "scatter_matmul_bf16",
        "route": "cuda",
        "source": "plnlp_tpu_torch/csrc/scatter_matmul.cu",
        "replaces": "plnlp_tpu/ops/pallas_spmm.py:51",
        "launches": 0,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def k2_bf16_phase(args, data, gen, card):
    """Phase 21: K2 with bf16 x (the padded-carry n_pad rows) against its
    plain version on the SBM operand's int8 tiles and on bf16 tiles (the
    same SBM with non-integer edge weights, built with dtype="bfloat16"
    through the estimate's cached order: no second label-prop sweep), both
    directions, a second launch bitwise equal; then its time, the plain
    version's, ``torch.sparse.mm`` on a bf16 CSR of the tile edges, and its
    bound."""
    import torch

    from plnlp_tpu_torch.ops import tile_matmul as tm
    from plnlp_tpu_torch.ops.tile_spmm import build_hybrid

    hg = data["hg"]
    n = hg.num_nodes
    n_r = hg.tile_rowptr.shape[0] - 1
    n_pad = n_r * TILE
    src, dst = data["edges"]
    w = np.random.default_rng(args.seed).random(len(src)).astype(np.float32) + 0.5
    t0 = time.perf_counter()
    hg_bf = build_hybrid(src, dst, w, num_nodes=n, tile=TILE, min_fill=MIN_FILL, block=BLOCK,
                         dtype="bfloat16", reorder="labelprop", order=data["est"]["order"],
                         device=hg.tile_vals.device)
    t_build = time.perf_counter() - t0
    require(hg_bf.tile_vals.dtype == torch.bfloat16 and hg_bf.num_tiles == hg.num_tiles,
            f"bf16 build: store {hg_bf.tile_vals.dtype}, {hg_bf.num_tiles} tiles")
    x = torch.randn(n_pad, WIDTH, device=hg.tile_vals.device, generator=gen).to(torch.bfloat16)
    sets = {
        "int8 tile_vals": (hg.tile_vals, hg.tile_row, hg.tile_col, hg.tile_rowptr),
        "int8 tile_vals_t": (hg.tile_vals_t, hg.tile_row_t, hg.tile_col_t, hg.tile_rowptr_t),
        "bf16 tile_vals": (hg_bf.tile_vals, hg_bf.tile_row, hg_bf.tile_col, hg_bf.tile_rowptr),
        "bf16 tile_vals_t": (hg_bf.tile_vals_t, hg_bf.tile_row_t, hg_bf.tile_col_t,
                             hg_bf.tile_rowptr_t),
    }
    max_abs = 0.0
    for label, (v, r, c, p) in sets.items():
        got = tm.tile_matmul(v, r, c, p, x, n_pad)
        require(got.dtype == torch.bfloat16 and torch.equal(got, tm.tile_matmul(v, r, c, p, x, n_pad)),
                f"tile_matmul bf16 on {label}: a second launch differs")
        want = tm.tile_matmul_reference(v, r, c, x, n_r, n_pad)
        abs_sum = tm.tile_matmul_reference(v.to(torch.bfloat16).float().abs(), r, c,
                                           x.float().abs(), n_r, n_pad)
        torch.cuda.synchronize()
        ea, ratio, ok = sum_errors(got, want, abs_sum, BF16_RTOL)
        max_abs = max(max_abs, ea)
        log(f"[bf16] tile_matmul bf16 on {label}, x at {n_pad} rows: max_abs={ea:.3e} max err/tol="
            f"{ratio:.3f} (tol {SUM_ATOL} + {SUM_RTOL}*sum|v x| + {BF16_RTOL}*|plain|); a second "
            f"launch gives the same bits")
        require(ok, f"tile_matmul bf16 on {label} disagrees with its plain version")
        require(not got[n:].any(), f"tile_matmul bf16 on {label}: rows past num_nodes not zero")
        del got, want, abs_sum
    v, r, c, p = sets["int8 tile_vals"]
    ms = cuda_ms(lambda: tm.tile_matmul(v, r, c, p, x, n_pad), reps=10, runs=5)
    ms_t = cuda_ms(lambda: tm.tile_matmul(*sets["int8 tile_vals_t"], x, n_pad), reps=10, runs=5)
    ms_bf = cuda_ms(lambda: tm.tile_matmul(*sets["bf16 tile_vals"], x, n_pad), reps=10, runs=5)
    plain_ms = cuda_ms(lambda: tm.tile_matmul_reference(v, r, c, x, n_r, n_pad), reps=2, runs=3)
    nz = v.nonzero()
    nnz = int(nz.shape[0])
    adj = torch.sparse_coo_tensor(
        torch.stack([r[nz[:, 0]].long() * TILE + nz[:, 1], c[nz[:, 0]].long() * TILE + nz[:, 2]]),
        v[nz[:, 0], nz[:, 1], nz[:, 2]].to(torch.bfloat16), (n_pad, n_pad),
    ).coalesce().to_sparse_csr()
    library_ms, lib_err = library_call_ms(lambda: torch.sparse.mm(adj, x))
    # Least time for the same function on these inputs: the int8 tiles, x
    # and out (bf16) once each, the indices; one multiply-add per nonzero
    # and column at the bf16 peak.
    nbytes = v.numel() * v.element_size() + 2 * n_pad * WIDTH * 2 + (2 * hg.num_tiles + n_r + 1) * 4
    flops = 2 * nnz * WIDTH
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    gather = nnz * WIDTH * 2
    log(f"[time] tile_matmul bf16 (int8 tiles) tile_vals {ms:.4f} ms, tile_vals_t {ms_t:.4f} ms; "
        f"bf16 tiles tile_vals {ms_bf:.4f} ms (x at {n_pad} rows); plain {plain_ms:.4f} ms; "
        f"torch.sparse.mm (bf16 CSR of the {nnz} dense-tile edges) "
        + (f"{library_ms:.4f} ms" if library_ms is not None else f"not run: {lib_err}")
        + f"; bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB take {t_bytes:.4f} ms, "
        f"{flops / 1e9:.3f} GFLOP take {t_ops:.4f} ms at the bf16 peak); its row gather, "
        f"{gather / 1e9:.3f} GB, takes {gather / HBM_BYTES_PER_S * 1e3:.4f} ms from HBM; the bf16 "
        f"build (weighted SBM, cached order) {t_build:.1f} s; card {card}")
    return {
        "name": "tile_matmul_bf16",
        "route": "cuda",
        "source": "plnlp_tpu_torch/csrc/tile_matmul.cu",
        "replaces": "plnlp_tpu/ops/pallas_tiles.py:62",
        "launches": 0,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def sage_bf16_phase(args, dev, card, graph, graph_t, ds, split, data):
    """Phase 22: SAGE + MLP + AUC in bf16 (width 256, 2 layers, batch
    65,536, Adam) for one epoch over the SBM's hybrid operand and one over
    the collab graph's blocked CSR, then ``Model.test``, ``Scorer.score`` and
    ``rank_candidates_batch(exclude_edges=True)``; only the bf16 entry points
    launch (K2 4 and K1 4 a step on hybrid, K1 4 on CSR; 2 each an encode)
    and the parameters and Adam's state are still f32.  Returns the launches
    of the phase."""
    import torch

    from plnlp_tpu_torch.serve import Scorer
    from plnlp_tpu_torch.training import Model, ModelConfig

    cfg = ModelConfig(
        encoder="SAGE", predictor="MLP", loss_func="AUC", neg_sampler="global",
        gnn_num_layers=2, emb_hidden_channels=WIDTH, gnn_hidden_channels=WIDTH,
        mlp_hidden_channels=WIDTH, batch_size=BATCH, num_neg=1, compute_dtype="bfloat16",
    )
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    rng = np.random.default_rng(args.seed + 2)
    total = dict.fromkeys(launch_counts(), 0)
    runs = (
        ("hybrid", data["hg"], None, data["sample_graph"], data["pos"], data["split"],
         ("K1bf16", "K2bf16")),
        ("csr", graph, graph_t, graph, ds["split_edge"]["train"]["edge"], split, ("K1bf16",)),
    )
    for label, g, gt, sample, pos, spl, kernels in runs:
        n = g.num_nodes
        model = Model(cfg, n, seed=args.seed, device=dev)
        opt = model.make_optimizer()
        steps = math.ceil(len(pos) / BATCH)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        loss = model.train_epoch(opt, g, gt, None, pos, None, gen, cfg.lr, sample_graph=sample)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        epoch = launch_counts()
        require(math.isfinite(loss), f"bf16 {label} epoch loss {loss}")
        require(epoch == _only(epoch, **{k: 4 * steps for k in kernels}),
                f"bf16 {label}: launches {epoch} in {steps} steps (want {kernels} 4 a step, "
                "no float32 launch)")
        require(all(p.dtype == torch.float32 for p in model.parameters())
                and all(v.dtype == torch.float32 for st in opt.state.values() for v in st.values()
                        if torch.is_tensor(v) and v.is_floating_point()),
                "bf16: a parameter or an optimizer state is not float32")
        zero_counts()
        t0 = time.perf_counter()
        hits = model.test(g, gt, None, spl, "hits")
        torch.cuda.synchronize()
        test_ms = (time.perf_counter() - t0) * 1e3
        test = launch_counts()
        require(test == _only(test, **{k: 2 for k in kernels}), f"bf16 {label}: {test} in a test")
        require(all(0.0 <= v <= 1.0 for pair in hits.values() for v in pair), f"hits {hits}")
        zero_counts()
        pairs = rng.integers(0, n, (65_536, 2))
        srcs = rng.integers(0, n, 256)
        scorer = Scorer(model, g, gt, exclude_graph=sample)
        scores = scorer.score(pairs)
        ids, top = scorer.rank_candidates_batch(srcs, k=50, exclude_edges=True)
        torch.cuda.synchronize()
        serve = launch_counts()
        require(serve == _only(serve, **{k: 2 for k in kernels}), f"bf16 {label}: {serve} serving")
        require(scorer.h.dtype == torch.float32 and scores.dtype == np.float32
                and np.isfinite(scores).all() and np.isfinite(top).all(), "bf16 scores")
        indptr, senders = sample.indptr.cpu().numpy(), sample.senders.cpu().numpy()
        for row, s in zip(ids, srcs):
            require(not set(row.tolist()) & set(senders[indptr[s]:indptr[s + 1]].tolist()),
                    f"bf16 {label}: a known neighbor of {s} ranked")
        for counts in (epoch, test, serve):
            for k, v in counts.items():
                total[k] += v
        pos_b = torch.as_tensor(pos[:BATCH], device=dev)
        neg_b = model.sample_negatives(gen, sample, pos_b)
        ones = torch.ones(pos_b.shape[0], device=dev)
        step_ms = cuda_ms(
            lambda: model.train_step(opt, g, gt, None, pos_b, neg_b, None, ones, cfg.lr),
            reps=3, runs=3)
        encode_ms = cuda_ms(lambda: model.encode(g, gt), reps=3, runs=3)
        score_ms = cuda_ms(lambda: scorer.score(pairs), reps=5, runs=3)
        log(f"[bf16] SAGE in bf16 over {label} (N={n}): one epoch of {steps} steps, mean loss "
            f"{loss:.6g}, {epoch_s:.3f} s (sampling included), launches {epoch}; train step "
            f"{step_ms:.3f} ms; encode {encode_ms:.3f} ms; Model.test {test_ms:.1f} ms (host "
            f"clock), launches {test}, {json.dumps(hits)}; Scorer.score 65536 pairs {score_ms:.3f} "
            f"ms and rank 256 sources k=50 exclude_edges, launches {serve}, scores f32 and "
            f"finite; parameters and Adam state f32; card {card}")
        del model, opt, scorer, pos_b, neg_b
        torch.cuda.empty_cache()
    return total


# The bf16 card-vs-CPU step.  Both devices round each bf16 product's sum
# once, but in other orders (cuBLAS against the CPU's matmul, the kernels
# against their plain versions), so an activation may land one bf16 ulp
# (2**-8 relative) apart; through two layers, the predictor and the
# backward that reaches a gradient's norm at about a percent.  SGD's step
# is 1.9 lr g (momentum 0.9, nesterov), so parameters move apart by
# 1.9e-3 times the gradient's difference.
BF16_STEP_TOLS = dict(loss_tol=1e-2, grad_tol=3e-2, param_atol=1e-4)


def cli_bf16_path(args, dev, card, tmp):
    """Phases 24-25; returns the launches in them."""
    from plnlp_tpu_torch import cli
    from plnlp_tpu_torch.profiling import summarize_trace

    total = dict.fromkeys(launch_counts(), 0)
    # 24. the collab command in bf16 with --block_rows 0 ----------------------
    mf, pd = os.path.join(tmp, "collab_bf16.jsonl"), os.path.join(tmp, "trace_bf16")
    argv = collab_flags(args.seed) + [
        "--compute_dtype", "bfloat16", "--block_rows", "0", "--epochs", "2",
        "--metrics_file", mf, "--profile_dir", pd,
    ]
    with watch_cli() as a:
        loggers = cli.main(argv)
    tuned = [line for line in a["lines"] if line.startswith("autotune: (R=")]
    chosen = [line for line in a["lines"] if line.startswith("autotuned block")]
    steps, tests = a["steps"], a["tests"]
    require(tuned and len(chosen) == 1, f"collab bf16: autotune lines {tuned}, {chosen}")
    # each measured candidate: a warm-up and 3 timed forward+backward runs,
    # 2 launches each
    want = 4 * steps + 2 * tests + 8 * len(tuned)
    require(a["launches"] == _only(a["launches"], K1bf16=want),
            f"collab bf16: launches {a['launches']} in {steps} steps, {tests} tests and "
            f"{len(tuned)} autotune candidates (want K1bf16 {want}, nothing else)")
    with open(mf) as f:
        metrics = [json.loads(line) for line in f]
    require(len(metrics) == 2 and all(math.isfinite(m["loss"]) for m in metrics),
            f"collab bf16 metrics {metrics}")
    hits = {k: lg.results[0][-1] for k, lg in loggers.items()}
    require(all(map(math.isfinite, sum(hits.values(), ()))), f"collab bf16 Hits@K {hits}")
    ops = summarize_trace(pd, top=None)
    require(ops, "collab bf16: the profiled epoch has no device op")
    busy_ms = sum(row["total_ms"] for row in ops)
    epoch_ms = metrics[1]["epoch_seconds"] * 1e3
    gemms = [row for row in ops
             if any(k in row["name"].lower() for k in ("gemm", "nvjet", "xmma", "cutlass"))]
    gemm_ms = sum(row["total_ms"] for row in gemms)
    k1_ms = sum(row["total_ms"] for row in ops if "scatter_" in row["name"])
    per_epoch = steps // 2
    for line in tuned + chosen:
        log(f"[cli-bf16] {line}")
    for row in gemms:
        log(f"[cli-bf16] GEMM in the profiled epoch: {row['name'][:150]}: {row['count']} launches, "
            f"{row['total_ms']:.3f} ms")
    log(f"[cli-bf16] collab (csr, bf16, --block_rows 0, 2 epochs): {steps} steps, {tests} tests, "
        f"launches {a['launches']}; epoch losses {[m['loss'] for m in metrics]}, epoch seconds "
        f"{[m['epoch_seconds'] for m in metrics]}; last eval {json.dumps(hits)}; profiled epoch 2: "
        f"{busy_ms:.3f} ms busy of {epoch_ms:.1f} ms (device busy share {busy_ms / epoch_ms:.3f}); "
        f"GEMMs {gemm_ms:.3f} ms ({gemm_ms / max(per_epoch, 1):.3f} ms a step over {per_epoch} "
        f"steps), K1 bf16 {k1_ms:.3f} ms; {a['seconds']:.1f} s; card {card}")
    for k, v in a["launches"].items():
        total[k] += v
    del loggers

    # 25. the ddi command in bf16 on the dense backend -----------------------
    mf_b = os.path.join(tmp, "ddi_bf16.jsonl")
    with watch_cli() as b:
        loggers = cli.main(ddi_flags(args.seed) + ["--compute_dtype", "bfloat16",
                                                   "--metrics_file", mf_b])
    with open(mf_b) as f:
        (m,) = [json.loads(line) for line in f]
    require(math.isfinite(m["loss"]), f"ddi bf16 loss {m['loss']}")
    require(b["launches"] == _only(b["launches"]), f"ddi bf16 (dense) launched {b['launches']}")
    require(not any(line.startswith(("auto backend", "hybrid backend")) for line in b["lines"]),
            "ddi bf16: auto did not take the dense backend")
    hits = {k: lg.results[0][-1] for k, lg in loggers.items()}
    require(all(map(math.isfinite, sum(hits.values(), ()))), f"ddi bf16 Hits@K {hits}")
    log(f"[cli-bf16] ddi (dense, bf16, width 512, 3 negatives, 1 epoch): {b['steps']} steps, loss "
        f"{m['loss']:.6g}, epoch {m['epoch_seconds']:.3f} s, launches {b['launches']}; "
        f"{json.dumps(hits)}; {b['seconds']:.1f} s; card {card}")
    return total


def bf16_path(args, dev, card, graph, graph_t, ds, split, data, small, tmp):
    """Phases 20-25; returns the bf16 entries of the kernels line."""
    import torch

    from plnlp_tpu_torch.training import ModelConfig

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    k1 = k1_bf16_phase(graph, graph_t, data, gen, card)
    k2 = k2_bf16_phase(args, data, gen, card)
    torch.cuda.empty_cache()
    sage = sage_bf16_phase(args, dev, card, graph, graph_t, ds, split, data)
    # 23. the card against the CPU in bf16 ---------------------------------
    cfg = ModelConfig(
        encoder="SAGE", predictor="MLP", gnn_num_layers=2, emb_hidden_channels=WIDTH,
        gnn_hidden_channels=WIDTH, mlp_hidden_channels=WIDTH, batch_size=BATCH,
        compute_dtype="bfloat16",
    )
    card_vs_cpu_step(cfg, small, args, dev, **BF16_STEP_TOLS)
    cli = cli_bf16_path(args, dev, card, tmp)
    k1["launches"] = sage["K1bf16"] + cli["K1bf16"]
    k2["launches"] = sage["K2bf16"] + cli["K2bf16"]
    log(f"[bf16] phases 20-25 in {time.perf_counter() - t0:.1f} s; launches: SAGE {sage}, CLI {cli}")
    return [k1, k2]


# ---------------------------------------------------------------------------
# TRANSFORMER in bf16 (K3-K5 bf16) and over blocked CSR (ops/transformer.py)
# ---------------------------------------------------------------------------

# bf16 against f32 (one computation in bf16, the other in f32 on the same
# bf16-rounded inputs, or bf16 in another place of rounding): a layer's
# output agg + skip within the JAX package's bf16 bound, rtol 3e-2 and atol
# 1e-2, taken relative to |agg| + |skip| (both are rounded to bf16 at their
# own magnitude, up to ~3 here, before they cancel: a row of two in-edges
# came out 0.0196 apart at a value of -0.027); gradients within phase 23's
# 3e-2 in relative L2 norm.
BF16_VALUE_TOL = dict(rtol=3e-2, atol=1e-2)
BF16_GRAD_TOL = BF16_STEP_TOLS["grad_tol"]


def conv_value_errors(got, want, skip, dtype):
    """(max abs error, max error / tolerance) of a TransformerConv layer's
    output ``got`` against ``want`` = agg + ``skip``: rtol = atol = 1e-4 in
    f32; in bf16 BF16_VALUE_TOL relative to |agg| + |skip|."""
    import torch

    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        tol = TOL + TOL * want.float().abs()
    else:
        terms = (want.float() - skip.float()).abs() + skip.float().abs()
        tol = BF16_VALUE_TOL["atol"] + BF16_VALUE_TOL["rtol"] * terms
    return float(diff.max()), float((diff / tol).max())


def flash_bf16_phase(data, gen, card):
    """Phase 27: K3, K4 and K5's bf16 entry points against their bf16 plain
    versions at the SBM training shape (q, k, v, g bf16 at the padded-carry
    n_pad rows), on the int8 tile store and on the same tiles stored in
    bf16, each with a second launch bitwise equal and no f32 launch; their
    times, the plain versions', and the bound.  Returns their entries of
    the kernels line (launches filled in later)."""
    import torch

    from plnlp_tpu_torch.ops import flash_tiles as ft

    hg = data["hg"]
    n = hg.num_nodes
    n_r = hg.tile_rowptr.shape[0] - 1
    n_pad = n_r * TILE
    dev = hg.tile_vals.device
    fwd_set = (hg.tile_vals, hg.tile_row, hg.tile_col, hg.tile_rowptr)
    bwd_set = (hg.tile_vals_t, hg.tile_row_t, hg.tile_col_t, hg.tile_rowptr_t)
    q, k, v, g = (torch.randn(n_pad, WIDTH, device=dev, generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    zero_counts()
    stats, errs = check_flash_kernels(fwd_set, bwd_set, q, k, v, g, n)
    bf_fwd = (fwd_set[0].to(torch.bfloat16), *fwd_set[1:])
    bf_bwd = (bwd_set[0].to(torch.bfloat16), *bwd_set[1:])
    _, errs_b = check_flash_kernels(bf_fwd, bf_bwd, q, k, v, g, n)
    torch.cuda.synchronize()
    counts = launch_counts()
    require(counts == _only(counts, K3bf16=4, K4bf16=4, K5bf16=4),
            f"bf16 flash checks: launches {counts} (want 2 of each bf16 entry a tile store, no "
            "f32 launch)")
    scale = 1.0 / math.sqrt(WIDTH)
    calls = {
        "fwd": (lambda: ft.flash_tiles_fwd(*fwd_set, q, k, v, scale),
                lambda: ft.flash_tiles_fwd_reference(*fwd_set[:3], q, k, v, n_r, scale)),
        "dq": (lambda: ft.flash_tiles_dq(*fwd_set, q, k, v, g, stats, scale),
               lambda: ft.flash_tiles_dq_reference(*fwd_set[:3], q, k, v, g, stats, n_r, scale)),
        "dkv": (lambda: ft.flash_tiles_dkv(*bwd_set, q, k, v, g, stats, scale),
                lambda: ft.flash_tiles_dkv_reference(*bwd_set[:3], q, k, v, g, stats, n_r,
                                                     scale)),
    }
    # Least time for the same function on these inputs: the int8 tiles read
    # once, each bf16 input (q, k, v and, in the backward, g) read once at 2
    # bytes, each f32 output written once at 4, the stats and the indices;
    # 4, 6 and 8 FLOP per nonzero and column at the bf16 peak.
    nnz = int((hg.tile_vals != 0).sum())
    vals_bytes = hg.tile_vals.numel() * hg.tile_vals.element_size()
    idx_bytes = (2 * hg.num_tiles + n_r + 1) * 4
    shape = {  # (bf16 arrays read, f32 arrays written, stats columns, FLOP per nonzero per column)
        "fwd": (3, 1, 2, 4), "dq": (4, 1, 3, 6), "dkv": (4, 2, 3, 8),
    }
    on_bf16_tiles = {
        "fwd": lambda: ft.flash_tiles_fwd(*bf_fwd, q, k, v, scale),
        "dq": lambda: ft.flash_tiles_dq(*bf_fwd, q, k, v, g, stats, scale),
        "dkv": lambda: ft.flash_tiles_dkv(*bf_bwd, q, k, v, g, stats, scale),
    }
    f32_ms = data.get("transformer_f32", {})
    entries = []
    for kind, (kernel, plain) in calls.items():
        ms = cuda_ms(kernel, reps=5, runs=3)
        ms_bt = cuda_ms(on_bf16_tiles[kind], reps=5, runs=3)
        plain_ms = cuda_ms(plain, reps=1, runs=3)
        reads, writes, stat_cols, per = shape[kind]
        nbytes = (vals_bytes + reads * n_pad * WIDTH * 2 + writes * n_pad * WIDTH * 4
                  + n_pad * stat_cols * 4 + idx_bytes)
        flops = per * nnz * WIDTH
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        gather = nnz * (2 * WIDTH * 2 + (12 if kind == "dkv" else 0))
        f32 = f32_ms.get(kind)
        log(f"[time] flash_tiles_{kind} bf16 {ms:.4f} ms on the int8 tiles, {ms_bt:.4f} ms on "
            f"bf16 tiles (q, k, v, g bf16 at {n_pad} rows) [f32 entry, phase 16: "
            + (f"{f32:.4f} ms" if f32 is not None else "not run") + f"]; plain {plain_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB take {t_bytes:.4f} ms, "
            f"{flops / 1e9:.3f} GFLOP take {t_ops:.4f} ms at the bf16 peak); its row gather, "
            f"{gather / 1e9:.3f} GB, takes {gather / HBM_BYTES_PER_S * 1e3:.4f} ms from HBM; "
            f"card {card}")
        entries.append({
            "name": f"flash_tiles_{kind}_bf16",
            "route": "cuda",
            "source": "plnlp_tpu_torch/csrc/flash_tiles.cu",
            "replaces": {"fwd": "plnlp_tpu/ops/pallas_attention.py:104",
                         "dq": "plnlp_tpu/ops/pallas_attention.py:216",
                         "dkv": "plnlp_tpu/ops/pallas_attention.py:303"}[kind],
            "launches": 0,
            "max_abs_err": max(errs[kind], errs_b[kind]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call (phase 16)
        })
    del q, k, v, g, stats, bf_fwd, bf_bwd
    return entries


def transformer_bf16_hybrid_phase(args, dev, card, data, small):
    """Phase 28: TRANSFORMER + MLP + AUC in bf16 (width 256, 2 layers, batch
    65,536, Adam) for one epoch over the SBM's hybrid operand, then
    ``Model.test`` and ``Scorer.score``: only the bf16 flash entries launch
    (K3, K4, K5 2 each a step; K3 2 an encode), parameters and Adam's state
    stay f32; step, epoch and encode times beside phase 16's f32 ones.  Then
    the card-against-CPU step in bf16.  Returns the phase's launches."""
    import torch

    from plnlp_tpu_torch.serve import Scorer
    from plnlp_tpu_torch.training import Model, ModelConfig

    cfg = ModelConfig(
        encoder="TRANSFORMER", predictor="MLP", loss_func="AUC", neg_sampler="global",
        gnn_num_layers=2, emb_hidden_channels=WIDTH, gnn_hidden_channels=WIDTH,
        mlp_hidden_channels=WIDTH, batch_size=BATCH, num_neg=1, compute_dtype="bfloat16",
    )
    hg, sample = data["hg"], data["sample_graph"]
    n = hg.num_nodes
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    total = dict.fromkeys(launch_counts(), 0)
    model = Model(cfg, n, seed=args.seed, device=dev)
    opt = model.make_optimizer()
    steps = math.ceil(len(data["pos"]) / BATCH)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    loss = model.train_epoch(opt, hg, None, None, data["pos"], None, gen, cfg.lr,
                             sample_graph=sample)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch = launch_counts()
    require(math.isfinite(loss), f"TRANSFORMER bf16 epoch loss {loss}")
    require(epoch == _only(epoch, K3bf16=2 * steps, K4bf16=2 * steps, K5bf16=2 * steps),
            f"TRANSFORMER bf16: launches {epoch} in {steps} steps (want the bf16 K3, K4, K5 2 "
            "each a step, nothing else)")
    require(all(p.dtype == torch.float32 for p in model.parameters())
            and all(v.dtype == torch.float32 for st in opt.state.values() for v in st.values()
                    if torch.is_tensor(v) and v.is_floating_point()),
            "TRANSFORMER bf16: a parameter or an optimizer state is not float32")
    zero_counts()
    t0 = time.perf_counter()
    hits = model.test(hg, None, None, data["split"], "hits")
    torch.cuda.synchronize()
    test_ms = (time.perf_counter() - t0) * 1e3
    test = launch_counts()
    require(test == _only(test, K3bf16=2), f"TRANSFORMER bf16: {test} in a test")
    require(all(0.0 <= v <= 1.0 for pair in hits.values() for v in pair), f"hits {hits}")
    zero_counts()
    pairs = np.random.default_rng(args.seed + 4).integers(0, n, (65_536, 2))
    scorer = Scorer(model, hg, exclude_graph=sample)
    scores = scorer.score(pairs)
    torch.cuda.synchronize()
    serve = launch_counts()
    require(serve == _only(serve, K3bf16=2), f"TRANSFORMER bf16: {serve} serving")
    require(scorer.h.dtype == torch.float32 and scores.dtype == np.float32
            and np.isfinite(scores).all(), "TRANSFORMER bf16 scores")
    for counts in (epoch, test, serve):
        for k, v in counts.items():
            total[k] += v
    pos_b = torch.as_tensor(data["pos"][:BATCH], device=dev)
    neg_b = model.sample_negatives(gen, sample, pos_b)
    ones = torch.ones(BATCH, device=dev)
    step_ms = cuda_ms(
        lambda: model.train_step(opt, hg, None, None, pos_b, neg_b, None, ones, cfg.lr),
        reps=3, runs=3)
    encode_ms = cuda_ms(lambda: model.encode(hg), reps=3, runs=3)
    f32 = data.get("transformer_f32", {})
    log(f"[transformer-bf16] TRANSFORMER in bf16 over the SBM's hybrid operand (N={n}): one "
        f"epoch of {steps} steps, mean loss {loss:.6g}, {epoch_s:.3f} s (sampling included), "
        f"launches {epoch}; train step {step_ms:.3f} ms; encode {encode_ms:.3f} ms; "
        f"Model.test {test_ms:.1f} ms (host clock), launches {test}, {json.dumps(hits)}; "
        f"Scorer.score 65536 pairs, launches {serve}, scores f32 and finite; parameters and Adam "
        f"state f32 [f32, phase 16: step {f32.get('step_ms', float('nan')):.3f} ms, epoch "
        f"{f32.get('epoch_s', float('nan')):.3f} s, encode {f32.get('encode_ms', float('nan')):.3f} "
        f"ms]; card {card}")
    del model, opt, scorer, pos_b, neg_b
    torch.cuda.empty_cache()
    # the card against the CPU in bf16, at phase 23's tolerances
    card_vs_cpu_step(cfg, small, args, dev, **BF16_STEP_TOLS)
    return total


def _grads_of(lp, xr):
    """x's gradient and each linear's weight and bias gradients together."""
    import torch

    return [xr.grad.float()] + [torch.cat([lin.weight.grad.reshape(-1), lin.bias.grad])
                                for lin in lp.values()]


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


def top_device_ops(fn, top=10):
    """(name, launches, total ms) of the device ops of one call of ``fn``
    under ``torch.profiler``, the largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, ev.count, dev_us / 1e3))
    return sorted(rows, key=lambda r: -r[2])[:top]


def check_blocked_small(dev):
    """Phase 29's small graph: ``transformer_conv_blocked`` (width 64) over
    3,000 nodes with rows of ~10 in-edges, rows of exactly one in-edge
    (dlogit is exactly 0 on all their slots, which K1 skips mid-run), 300
    self loops, every edge into rows 0-99 twice (``coalesce=False``: the
    slot map pairs duplicates k-th with k-th) and isolated rows, through K1
    on the card against the same layer through K1's plain version on the
    CPU.  float32: values within rtol = atol = 1e-4, gradients (x; each
    linear's weight and bias together) within 1e-4 in relative L2; bf16 at
    BF16_VALUE_TOL (relative to |agg| + |skip|) and BF16_GRAD_TOL.  K1 launches once forward and three
    times backward, in the entry point of x's dtype."""
    import torch

    from plnlp_tpu_torch import prepare_graph
    from plnlp_tpu_torch.models import Encoder
    from plnlp_tpu_torch.nn import apply_linear
    from plnlp_tpu_torch.ops.transformer import transformer_conv_blocked

    rng = np.random.default_rng(7)
    n, d = 3000, 64
    many = rng.integers(0, 1500, 15_000)
    single = np.arange(1500, 2500)
    loops = np.arange(300)
    dst = np.concatenate([many, single, loops])
    src = np.concatenate([rng.integers(0, n, len(many) + len(single)), loops])
    dup = dst < 100
    src, dst = np.concatenate([src, src[dup]]), np.concatenate([dst, dst[dup]])
    g, gt = prepare_graph(src, dst, None, num_nodes=n, block=(256, 128), coalesce=False,
                          couple_transpose=True, device=dev)
    require(g.num_edges == len(src), "the small graph lost an edge")
    g_cpu, gt_cpu = g.to("cpu"), gt.to("cpu")
    lp = Encoder(torch.Generator().manual_seed(3), "TRANSFORMER", d, d, 1).layers[0].to(dev)
    lp_cpu = copy.deepcopy(lp).to("cpu")
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(4))
    gy = torch.randn(n, d, generator=torch.Generator().manual_seed(5))
    report = []
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        with torch.no_grad():
            skip = apply_linear(lp_cpu["lin_skip"], x.to(dtype)).float()
        for device, graph, graph_t, layer in ((dev, g, gt, lp), ("cpu", g_cpu, gt_cpu, lp_cpu)):
            layer.zero_grad(set_to_none=True)
            xr = x.to(device, dtype, copy=True).requires_grad_(True)
            torch.cuda.synchronize()
            zero_counts()
            out = transformer_conv_blocked(layer, graph, graph_t, xr)
            out.backward(gy.to(device, dtype))
            torch.cuda.synchronize()
            if device != "cpu":
                counts = launch_counts()
            runs.append([out.detach().float().cpu()] + [a.cpu() for a in _grads_of(layer, xr)])
        key = "K1" if dtype == torch.float32 else "K1bf16"
        require(counts == _only(counts, **{key: 4}),
                f"the small blocked layer in {dtype}: launches {counts} (want {key} 4)")
        grad_tol = 1e-4 if dtype == torch.float32 else BF16_GRAD_TOL
        (card_out, *card_g), (cpu_out, *cpu_g) = runs
        ea, ratio = conv_value_errors(card_out, cpu_out, skip, dtype)
        require(ratio <= 1.0, f"the small blocked layer in {dtype}: values max_abs {ea:.3e}, "
                f"max err/tol {ratio:.3f}")
        rel = max(_rel_l2(a, b) for a, b in zip(card_g, cpu_g))
        require(rel <= grad_tol, f"the small blocked layer in {dtype}: gradient relative L2 {rel:.3e}")
        report.append(f"{str(dtype)[6:]} values max_abs {ea:.3e} (max err/tol {ratio:.3f}), "
                      f"gradients relative L2 max {rel:.3e}, launches {counts}")
    log(f"[csr-transformer] small graph (N={n}: single-in-edge rows, self loops, duplicate edges, "
        f"isolated rows; {g.num_edges} edges) through K1 on the card vs its plain version on the "
        f"CPU: " + "; ".join(report))


def csr_transformer_phase(args, dev, card, graph, graph_t, ds, split):
    """Phase 29: TRANSFORMER over the collab graph's blocked CSR with
    ``tconv_map`` (N = 235,868, the serving graph of phase 3):
    ``transformer_conv_blocked`` (width 256) and its x and parameter
    gradients against autograd through the per-edge path on the card, in
    f32 (rtol = atol = 1e-4; 1e-4 relative L2) and in bf16 (against the
    per-edge path in f32 on the same bf16-rounded x; BF16_VALUE_TOL relative
    to |agg| + |skip|, BF16_GRAD_TOL), K1 1 launch forward and 3 backward; one epoch of
    TRANSFORMER + MLP + AUC (width 256, 2 layers, batch 65,536, Adam) in
    each dtype with its step and epoch times (K1 8 a step, 2 a test, in x's
    dtype only), a per-edge f32 step for comparison; then the small graph
    (``check_blocked_small``).  Returns the phase's launches."""
    import torch

    from plnlp_tpu_torch.models import Encoder
    from plnlp_tpu_torch.models.encoders import _transformer_conv
    from plnlp_tpu_torch.nn import apply_linear
    from plnlp_tpu_torch.ops.transformer import transformer_conv_blocked
    from plnlp_tpu_torch.training import Model, ModelConfig

    require(graph.tconv_map is not None, "the collab graph carries no tconv_map")
    n = graph.num_nodes
    total = dict.fromkeys(launch_counts(), 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    lp = Encoder(torch.Generator().manual_seed(1), "TRANSFORMER", WIDTH, WIDTH, 1).to(dev).layers[0]
    x = torch.randn(n, WIDTH, device=dev, generator=gen)
    gy = torch.randn(n, WIDTH, device=dev, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        for path in ("blocked", "per-edge"):
            lp.zero_grad(set_to_none=True)
            xr = x.to(dtype) if path == "blocked" else x.to(dtype).float()
            xr = xr.clone().requires_grad_(True)
            torch.cuda.synchronize()
            zero_counts()
            if path == "blocked":
                out = transformer_conv_blocked(lp, graph, graph_t, xr)
            else:  # no transpose: the per-edge path
                out = _transformer_conv(lp, graph, None, xr)
            (out.float() * gy).sum().backward()
            torch.cuda.synchronize()
            counts = launch_counts()
            if path == "blocked":
                key = "K1" if dtype == torch.float32 else "K1bf16"
                require(counts == _only(counts, **{key: 4}),
                        f"transformer_conv_blocked in {dtype}: launches {counts} (want {key} 1 "
                        "forward and 3 backward)")
                for k, v in counts.items():
                    total[k] += v
            runs.append([out.detach().float()] + _grads_of(lp, xr))
            del out, xr
        (b_out, *b_g), (e_out, *e_g) = runs
        grad_tol = 1e-4 if dtype == torch.float32 else BF16_GRAD_TOL
        with torch.no_grad():
            skip = apply_linear(lp["lin_skip"], x.to(dtype).float())
        ea, ratio = conv_value_errors(b_out, e_out, skip, dtype)
        del skip
        require(ratio <= 1.0, f"transformer_conv_blocked in {dtype} vs the per-edge path: values "
                f"max_abs {ea:.3e}, max err/tol {ratio:.3f}")
        rel = {name: _rel_l2(a, b) for name, a, b in zip(["x", *lp.keys()], b_g, e_g)}
        require(max(rel.values()) <= grad_tol,
                f"transformer_conv_blocked in {dtype}: gradient relative L2 errors {rel}")
        log(f"[csr-transformer] transformer_conv_blocked in {str(dtype)[6:]} (N={n}, D={WIDTH}, "
            f"E={graph.num_edges}) vs autograd through the per-edge path in f32 on the card: values "
            f"max_abs {ea:.3e}, max err/tol {ratio:.3f}; gradient relative L2 "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + f" (tol {grad_tol}); card {card}")
        del runs, b_g, e_g
    del x, gy
    torch.cuda.empty_cache()

    pos = ds["split_edge"]["train"]["edge"]
    steps = math.ceil(len(pos) / BATCH)
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(
            encoder="TRANSFORMER", predictor="MLP", loss_func="AUC", neg_sampler="global",
            gnn_num_layers=2, emb_hidden_channels=WIDTH, gnn_hidden_channels=WIDTH,
            mlp_hidden_channels=WIDTH, batch_size=BATCH, num_neg=1, compute_dtype=dtype,
        )
        key = "K1" if dtype == "float32" else "K1bf16"
        model = Model(cfg, n, seed=args.seed, device=dev)
        opt = model.make_optimizer()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        loss = model.train_epoch(opt, graph, graph_t, None, pos, None, gen, cfg.lr,
                                 sample_graph=graph)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        epoch = launch_counts()
        require(math.isfinite(loss), f"CSR TRANSFORMER {dtype} epoch loss {loss}")
        require(epoch == _only(epoch, **{key: 8 * steps}),
                f"CSR TRANSFORMER {dtype}: launches {epoch} in {steps} steps (want {key} 8 a step)")
        zero_counts()
        hits = model.test(graph, graph_t, None, split, "hits")
        torch.cuda.synchronize()
        test = launch_counts()
        require(test == _only(test, **{key: 2}), f"CSR TRANSFORMER {dtype}: {test} in a test")
        require(all(0.0 <= v <= 1.0 for pair in hits.values() for v in pair), f"hits {hits}")
        for counts in (epoch, test):
            for k, v in counts.items():
                total[k] += v
        pos_b = torch.as_tensor(pos[:BATCH], device=dev)
        neg_b = model.sample_negatives(gen, graph, pos_b)
        ones = torch.ones(BATCH, device=dev)
        step_ms = cuda_ms(
            lambda: model.train_step(opt, graph, graph_t, None, pos_b, neg_b, None, ones, cfg.lr),
            reps=3, runs=3)
        top = top_device_ops(
            lambda: model.train_step(opt, graph, graph_t, None, pos_b, neg_b, None, ones, cfg.lr))
        per_edge = ""
        if dtype == "float32":
            plain = dataclasses.replace(graph, tconv_map=None)
            edge_ms = cuda_ms(
                lambda: model.train_step(opt, plain, None, None, pos_b, neg_b, None, ones, cfg.lr),
                reps=2, runs=3)
            per_edge = f"; the per-edge path's step {edge_ms:.3f} ms"
        log(f"[csr-transformer] TRANSFORMER in {dtype} over the collab graph's blocked CSR "
            f"(N={n}): one epoch of {steps} steps, mean loss {loss:.6g}, {epoch_s:.3f} s "
            f"(sampling included), launches {epoch}; train step {step_ms:.3f} ms{per_edge}; "
            f"Model.test launches {test}, {json.dumps(hits)}; card {card}")
        for name, count, ms in top:
            log(f"[csr-transformer] {dtype} step, top device op: {name[:120]}: {count} launches, "
                f"{ms:.3f} ms")
        del model, opt, pos_b, neg_b
        torch.cuda.empty_cache()
    check_blocked_small(dev)
    return total


def cli_transformer_path(args, dev, card, tmp):
    """Phase 30: the CLI in process.  The collab command with ``--encoder
    TRANSFORMER --adj_backend csr`` for one epoch in f32 (K1 8 a step and 2
    a test) and one in bf16 (only K1-bf16); phase 19's SBM command in bf16
    (``auto`` chooses hybrid, only the bf16 K3-K5 launch) and its
    ``--score_pairs``, equal to the restored Scorer.  Returns the launches."""
    from plnlp_tpu_torch import cli

    total = dict.fromkeys(launch_counts(), 0)
    for dtype, key in (("float32", "K1"), ("bfloat16", "K1bf16")):
        with watch_cli() as a:
            cli.main(collab_flags(args.seed) + ["--encoder", "TRANSFORMER", "--epochs", "1",
                                                "--compute_dtype", dtype])
        steps, tests = a["steps"], a["tests"]
        require(a["epochs"] == 1 and tests == 1, f"collab TRANSFORMER {dtype}: {a['epochs']} "
                f"epochs, {tests} tests")
        require(a["launches"] == _only(a["launches"], **{key: 8 * steps + 2 * tests}),
                f"collab TRANSFORMER {dtype}: launches {a['launches']} in {steps} steps and "
                f"{tests} tests (want {key} 8 a step and 2 a test, nothing else)")
        log(f"[cli-transformer] collab TRANSFORMER (csr, {dtype}, 1 epoch): {steps} steps, "
            f"launches {a['launches']}; {a['seconds']:.1f} s; card {card}")
        for k, v in a["launches"].items():
            total[k] += v
    ck = os.path.join(tmp, "sbm_bf16_ck")
    sbm = sbm_flags(args.seed, ck) + ["--compute_dtype", "bfloat16"]
    with watch_cli() as c:
        cli.main(sbm)
    decision = [line for line in c["lines"] if line.startswith("auto backend")]
    require(len(decision) == 1 and decision[0].endswith("-> hybrid"),
            f"TRANSFORMER bf16: auto did not choose hybrid: {decision}")
    steps, tests = c["steps"], c["tests"]
    require(c["launches"] == _only(c["launches"], K3bf16=2 * steps + 2 * tests,
                                   K4bf16=2 * steps, K5bf16=2 * steps),
            f"TRANSFORMER bf16: launches {c['launches']} in {steps} steps and {tests} tests")
    for k, v in c["launches"].items():
        total[k] += v
    pairs = np.random.default_rng(args.seed + 6).integers(0, SBM_NODES, (CLI_PAIRS, 2))
    pp, so = os.path.join(tmp, "sbm_bf16_pairs.npy"), os.path.join(tmp, "sbm_bf16_scores.npy")
    np.save(pp, pairs)
    serve = sbm + ["--adj_backend", "hybrid", "--score_pairs", pp, "--score_out", so]
    with watch_cli() as s:
        cli.main(serve)
    require(s["launches"] == _only(s["launches"], K3bf16=2),
            f"TRANSFORMER bf16 serving launches {s['launches']}")
    _, err = check_cli_scores(cli, serve, ck, pairs, np.load(so), "TRANSFORMER bf16", bf16=True)
    for k, v in s["launches"].items():
        total[k] += v
    log(f"[cli-transformer] TRANSFORMER bf16 (auto -> hybrid, 1 epoch): {steps} steps, launches "
        f"{c['launches']}, {c['seconds']:.1f} s; --score_pairs launches {s['launches']}, equal to "
        f"the restored Scorer within one bf16 ulp of the largest score (max_abs {err:.3e}); "
        f"card {card}")
    return total


def transformer_bf16_path(args, dev, card, graph, graph_t, ds, split, data, small, tmp):
    """Phases 27-30; returns the bf16 flash entries of the kernels line and
    the launches of the phases' main paths."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    flash = flash_bf16_phase(data, gen, card)
    torch.cuda.empty_cache()
    hybrid = transformer_bf16_hybrid_phase(args, dev, card, data, small)
    csr = csr_transformer_phase(args, dev, card, graph, graph_t, ds, split)
    cli = cli_transformer_path(args, dev, card, tmp)
    total = {k: hybrid[k] + csr[k] + cli[k] for k in hybrid}
    for entry, key in zip(flash, ("K3bf16", "K4bf16", "K5bf16")):
        entry["launches"] = total[key]
    log(f"[transformer-bf16] phases 27-30 in {time.perf_counter() - t0:.1f} s; launches: hybrid "
        f"{hybrid}, CSR {csr}, CLI {cli}")
    return flash, total


# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------


class _Tee:
    """stdout that is also kept, so the CLI's log can be checked."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.out.write(text)
        self.parts.append(text)
        return len(text)

    def flush(self):
        self.out.flush()

    def lines(self):
        return "".join(self.parts).splitlines()


@contextlib.contextmanager
def watch_cli():
    """Count ``Model.train_step``, ``train_epoch`` and ``test`` calls, keep
    the parameters the first ``train_epoch`` starts from, tee stdout, and
    zero every kernel's launch count; yields a dict that holds, after the
    block, the launches made in it."""
    import torch

    from plnlp_tpu_torch.training import Model

    seen = {"steps": 0, "epochs": 0, "tests": 0, "first_params": None}
    orig = {name: getattr(Model, name) for name in ("train_step", "train_epoch", "test")}

    def train_step(self, *a, **kw):
        seen["steps"] += 1
        return orig["train_step"](self, *a, **kw)

    def train_epoch(self, *a, **kw):
        if seen["first_params"] is None:
            seen["first_params"] = {k: v.detach().cpu().clone() for k, v in self.state_dict().items()}
        seen["epochs"] += 1
        return orig["train_epoch"](self, *a, **kw)

    def test(self, *a, **kw):
        seen["tests"] += 1
        return orig["test"](self, *a, **kw)

    tee = _Tee(sys.stdout)
    Model.train_step, Model.train_epoch, Model.test = train_step, train_epoch, test
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            yield seen
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(Model, name, fn)
    seen["seconds"] = time.perf_counter() - t0
    seen["launches"] = launch_counts()
    seen["lines"] = tee.lines()


def _only(launches, **want):
    """The launch counts, with every kernel not named required to be 0."""
    return {k: want.get(k, 0) for k in launches}


def check_cli_scores(cli, argv, ckpt, pairs, scores, label, bf16=False):
    """``scores`` (from ``--score_pairs``) against the Scorer restored from
    ``ckpt`` over the operand the serving run builds, on the pairs mapped
    through the trained run's relabel; the same computation, so within
    1e-6.  With ``bf16`` within 1e-6 + 2**-7 of the largest score: the
    hybrid residual's f32 ``index_add_`` adds in arrival order on the card,
    and a last-bit difference can move one of the encode's bf16 roundings
    by an ulp (1.2e-5 apart, measured)."""
    from plnlp_tpu_torch.serve import Scorer

    exp = cli.prepare_experiment(cli.argument(argv), log=lambda *_: None, serving=True)
    want = Scorer.from_checkpoint(
        exp["model"], ckpt, exp["graph"], exp["graph_t"], exp["node_feats"]
    ).score(pairs if exp["node_relabel"] is None else exp["node_relabel"][pairs])
    err = float(np.abs(scores - want).max())
    require(scores.shape == (len(pairs),) and np.isfinite(scores).all(), f"{label} scores")
    if bf16:
        tol = 1e-6 + BF16_RTOL * float(np.abs(want).max())
        require(err <= tol, f"{label}: --score_pairs vs the restored Scorer max_abs {err:.3e} "
                f"(tol {tol:.3e})")
    else:
        require(np.allclose(scores, want, rtol=1e-6, atol=1e-6),
                f"{label}: --score_pairs vs the restored Scorer max_abs {err:.3e}")
    return exp["node_relabel"], err


def collab_flags(seed: int) -> list:
    """The reference README's ogbl-collab command over blocked CSR, on
    synthetic data of collab's size with weights and years, one run."""
    return [
        "--data_name",
        f"synthetic:hits:num_nodes={N_NODES},num_edges={N_EDGES},weighted=1,with_year=1",
        "--predictor", "DOT", "--use_valedges_as_input", "True", "--year", "2010",
        "--eval_last_best", "True", "--dropout", "0.3", "--adj_backend", "csr",
        "--eval_steps", "1", "--runs", "1", "--seed", str(seed),
    ]


def ddi_flags(seed: int) -> list:
    """The README's ogbl-ddi command (width 512, 3 negatives) at ddi's size,
    one epoch of one run."""
    return [
        "--data_name", f"synthetic:hits:num_nodes={DDI_NODES},num_edges={DDI_EDGES}",
        "--emb_hidden_channels", "512", "--gnn_hidden_channels", "512",
        "--mlp_hidden_channels", "512", "--num_neg", "3", "--dropout", "0.3",
        "--epochs", "1", "--eval_steps", "1", "--runs", "1", "--seed", str(seed),
    ]


def sbm_flags(seed: int, ckpt: str) -> list:
    """TRANSFORMER on a 200-community SBM for one epoch, through ``auto``,
    with a checkpoint in ``ckpt``."""
    return [
        "--data_name", f"synthetic:hits-sbm:num_nodes={SBM_NODES},num_edges={SBM_EDGES},"
        f"num_communities={SBM_COMMUNITIES}",
        "--encoder", "TRANSFORMER", "--epochs", "1", "--eval_steps", "1", "--runs", "1",
        "--checkpoint_dir", ckpt, "--checkpoint_every", "1", "--seed", str(seed),
    ]


def cli_path(args, dev, card, tmp):
    """Phases 17-19; returns the launches of K1-K5 in them."""
    import torch

    from plnlp_tpu_torch import cli
    from plnlp_tpu_torch.checkpoint import CheckpointManager
    from plnlp_tpu_torch.profiling import summarize_trace

    total = dict.fromkeys(launch_counts(), 0)
    rng = np.random.default_rng(args.seed)
    t_phases = time.perf_counter()

    # 17. the collab command over blocked CSR ------------------------------
    ck, mf, pd = (os.path.join(tmp, name) for name in ("collab_ck", "collab.jsonl", "trace"))
    collab = collab_flags(args.seed) + [
        "--checkpoint_dir", ck, "--checkpoint_every", "1", "--metrics_file", mf,
        "--profile_dir", pd,
    ]
    with watch_cli() as a:
        loggers = cli.main(collab + ["--epochs", "2"])
    steps, tests = a["steps"], a["tests"]
    require(a["epochs"] == 2 and tests == 2, f"collab: {a['epochs']} epochs, {tests} tests")
    require(a["launches"] == _only(a["launches"], K1=4 * steps + 2 * tests),
            f"collab: launches {a['launches']} in {steps} steps and {tests} tests "
            "(want K1 4 a step and 2 a test, no other kernel)")
    with open(mf) as f:
        metrics = [json.loads(line) for line in f]
    require(len(metrics) == 2 and all(math.isfinite(m["loss"]) for m in metrics),
            f"collab metrics {metrics}")
    hits = {k: lg.results[0] for k, lg in loggers.items()}
    require(all(len(r) == 2 and all(map(math.isfinite, sum(r, ()))) for r in hits.values()),
            f"collab Hits@K {hits}")
    profile = [line for line in a["lines"] if line.startswith("[profile]")]
    require(profile, "collab: the profiled epoch logged no device op (torch.profiler saw no "
                     "CUDA activity)")
    # the traced epoch's device time (kernels, copies, memsets; one stream)
    # against its host-clock seconds, which include the profiler's own cost
    ops = summarize_trace(pd, top=None)
    busy_ms = sum(row["total_ms"] for row in ops)
    kernels_ms = {name: sum(row["total_ms"] for row in ops if pattern in row["name"])
                  for name, pattern in (("K1", "scatter_"), ("gemm", "gemm"))}
    log(f"[cli] collab epoch 2 under the profiler: {sum(row['count'] for row in ops)} device "
        f"events in {len(ops)} names, {busy_ms:.3f} ms busy of {metrics[1]['epoch_seconds'] * 1e3:.1f} "
        f"ms (host clock): device busy share {busy_ms / (metrics[1]['epoch_seconds'] * 1e3):.3f}; "
        f"K1 {kernels_ms['K1']:.3f} ms, GEMMs {kernels_ms['gemm']:.3f} ms; card {card}")
    log(f"[cli] collab (csr, 2 epochs): {steps} steps, {tests} tests, launches {a['launches']}; "
        f"epoch losses {[m['loss'] for m in metrics]}, epoch seconds "
        f"{[m['epoch_seconds'] for m in metrics]}; last eval {json.dumps({k: r[-1] for k, r in hits.items()})}; "
        f"{len(profile)} [profile] lines above (epoch 2's top device ops); {a['seconds']:.1f} s; "
        f"card {card}")
    for k, v in a["launches"].items():
        total[k] += v

    with watch_cli() as r:
        cli.main(collab + ["--epochs", "3", "--resume", "True"])
    require("Resumed from run 1, epoch 3" in r["lines"], "collab resume: no 'Resumed from run 1, "
            "epoch 3' line")
    require(r["epochs"] == 1 and r["tests"] == 1, f"collab resume: {r['epochs']} epochs")
    saved, _, _ = CheckpointManager(ck).restore(step=2, device="cpu")
    start = r["first_params"]
    require(start is not None and set(start) == set(saved)
            and all(torch.equal(start[k], saved[k]) for k in saved),
            "collab resume: the epoch did not start from the checkpoint's parameters")
    require(r["launches"] == _only(r["launches"], K1=4 * r["steps"] + 2),
            f"collab resume: launches {r['launches']} in {r['steps']} steps")
    log(f"[cli] collab --resume: 'Resumed from run 1, epoch 3', 1 epoch of {r['steps']} steps from "
        f"parameters bitwise equal to checkpoint step 2, launches {r['launches']}; "
        f"{r['seconds']:.1f} s")
    for k, v in r["launches"].items():
        total[k] += v

    pairs = rng.integers(0, N_NODES, (CLI_PAIRS, 2))
    pp, so = os.path.join(tmp, "collab_pairs.npy"), os.path.join(tmp, "collab_scores.npy")
    np.save(pp, pairs)
    serve = collab + ["--epochs", "3", "--score_pairs", pp, "--score_out", so]
    with watch_cli() as s:
        cli.main(serve)
    require(s["launches"] == _only(s["launches"], K1=2), f"collab serving launches {s['launches']}")
    _, err = check_cli_scores(cli, serve, ck, pairs, np.load(so), "collab")
    log(f"[cli] collab --score_pairs: {CLI_PAIRS} pairs, launches {s['launches']}; equal to "
        f"Scorer.from_checkpoint(...).score within 1e-6 (max_abs {err:.3e}); {s['seconds']:.1f} s")
    for k, v in s["launches"].items():
        total[k] += v
    del loggers
    torch.cuda.empty_cache()

    # 18. the ddi command on the dense backend ------------------------------
    mf_b = os.path.join(tmp, "ddi.jsonl")
    ddi = ddi_flags(args.seed) + ["--metrics_file", mf_b]
    with watch_cli() as b:
        loggers = cli.main(ddi)
    with open(mf_b) as f:
        (m,) = [json.loads(line) for line in f]
    require(math.isfinite(m["loss"]), f"ddi loss {m['loss']}")
    require(b["launches"] == _only(b["launches"]), f"ddi (dense) launched {b['launches']}")
    require(not any(line.startswith(("auto backend", "hybrid backend")) for line in b["lines"]),
            "ddi: auto did not take the dense backend")
    hits = {k: lg.results[0][-1] for k, lg in loggers.items()}
    require(all(map(math.isfinite, sum(hits.values(), ()))), f"ddi Hits@K {hits}")
    log(f"[cli] ddi (dense, width 512, 3 negatives, 1 epoch): {b['steps']} steps, loss "
        f"{m['loss']:.6g}, epoch {m['epoch_seconds']:.3f} s, launches {b['launches']}; "
        f"{json.dumps(hits)}; {b['seconds']:.1f} s; card {card}")
    del loggers
    torch.cuda.empty_cache()

    # 19. TRANSFORMER through auto onto the hybrid operand ------------------
    ck_c = os.path.join(tmp, "sbm_ck")
    sbm = sbm_flags(args.seed, ck_c)
    with watch_cli() as c:
        cli.main(sbm)
    decision = [line for line in c["lines"] if line.startswith("auto backend")]
    require(len(decision) == 1 and decision[0].endswith("-> hybrid"),
            f"TRANSFORMER: auto did not choose hybrid: {decision}")
    steps, tests = c["steps"], c["tests"]
    require(c["launches"] == _only(c["launches"], K3=2 * steps + 2 * tests, K4=2 * steps,
                                   K5=2 * steps),
            f"TRANSFORMER: launches {c['launches']} in {steps} steps and {tests} tests")
    log(f"[cli] TRANSFORMER (auto -> hybrid, 1 epoch): {steps} steps, launches {c['launches']}; "
        f"{c['seconds']:.1f} s; card {card}")
    for k, v in c["launches"].items():
        total[k] += v
    pairs = rng.integers(0, SBM_NODES, (CLI_PAIRS, 2))
    pp, so = os.path.join(tmp, "sbm_pairs.npy"), os.path.join(tmp, "sbm_scores.npy")
    np.save(pp, pairs)
    serve = sbm + ["--adj_backend", "hybrid", "--score_pairs", pp, "--score_out", so]
    with watch_cli() as s:
        cli.main(serve)
    require(s["launches"] == _only(s["launches"], K3=2), f"TRANSFORMER serving launches "
            f"{s['launches']}")
    relabel, err = check_cli_scores(cli, serve, ck_c, pairs, np.load(so), "TRANSFORMER")
    require(relabel is not None and (relabel != np.arange(SBM_NODES)).any(),
            "TRANSFORMER serving: no id-space relabel")
    log(f"[cli] TRANSFORMER --score_pairs over the hybrid operand: {CLI_PAIRS} pairs in original ids, "
        f"launches {s['launches']}; equal to the restored Scorer on the relabeled ids within "
        f"1e-6 (max_abs {err:.3e}); {s['seconds']:.1f} s")
    for k, v in s["launches"].items():
        total[k] += v
    log(f"[cli] phases 17-19 in {time.perf_counter() - t_phases:.1f} s; launches {total}")
    return total


# ---------------------------------------------------------------------------
# The native host library and the multi-device runtime
# ---------------------------------------------------------------------------


def native_phase(args, data):
    """Phase 31: the native library against the NumPy plain versions, bit
    for bit, on a 20,000-node graph, and the label-prop sweep on phase 7's
    SBM, natively."""
    from plnlp_tpu_torch import graph as G
    from plnlp_tpu_torch import native
    from plnlp_tpu_torch.ops import tile_spmm as ts
    from plnlp_tpu_torch.parallel import partition as P

    require(native.available(), "the native library runs (the NumPy fallback fails the phase)")
    rng = np.random.default_rng(args.seed)
    n, e = 20_000, 200_000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = (rng.random(e) + 0.1).astype(np.float32)
    csr = G._csr_np(src, dst, w, n, False, True)
    indptr, indices = G._undirected_csr_np(src, dst, n)
    seeds = np.argsort(-np.diff(indptr), kind="stable")
    cases = {
        "coalesce_add": (lambda: native.coalesce_add(src, dst, w, n),
                         lambda: G._coalesce_plain(src, dst, w, n)),
        "blocks_build": (lambda: native.blocks_build(csr["senders"], csr["receivers"],
                                                     csr["edge_weight"], csr["indptr"], n, *BLOCK),
                         lambda: G._blocks_plain(csr, *BLOCK)),
        "label_prop": (lambda: native.label_prop(indptr, indices, n, 20),
                       lambda: ts._label_prop_plain(src, dst, n, 20)),
        "bfs_order": (lambda: native.bfs_order(indptr, indices, n, seeds),
                      lambda: P._bfs_order_plain(indptr, indices, n, seeds)),
    }

    def bits(v):
        v = np.asarray(v)
        return v.view(np.uint32) if v.dtype == np.float32 else v

    for name, (nat, plain) in cases.items():
        t0 = time.perf_counter()
        got = nat()
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = plain()
        t_plain = time.perf_counter() - t0
        if isinstance(want, dict):
            got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
        elif not isinstance(want, tuple):
            got, want = [got], [want]
        same = all(
            (a is None and b is None) or (np.asarray(a).dtype == np.asarray(b).dtype
                                          and np.array_equal(bits(a), bits(b)))
            for a, b in zip(got, want)
        )
        log(f"[native] {name} on N={n} E={e}: native {t_nat * 1e3:.1f} ms, NumPy "
            f"{t_plain * 1e3:.1f} ms, bit for bit {same}")
        require(same, f"native {name} differs from its NumPy version")
    s_src, s_dst = data["edges"]
    t0 = time.perf_counter()
    order = ts.label_prop_order(s_src, s_dst, N_NODES)
    t_lp = time.perf_counter() - t0
    require(np.array_equal(np.sort(order), np.arange(N_NODES)), "label-prop order is a permutation")
    t_est = data["seconds"][1]
    log(f"[native] label-prop order on phase 7's SBM (N={N_NODES}, E={len(s_src)}): "
        f"{t_lp:.3f} s natively; phase 7's whole estimate {t_est:.3f} s (the NumPy sweep: "
        f"21.4 s on this graph, PERF.md section 5)")
    return {"label_prop_s": t_lp, "estimate_s": t_est}


def shard_k1_phase(graph, graph_t, src, dst, gen, card):
    """Phase 31b: K1 over each shard of a 4-shard partition on this card
    (one process, the exchanges done by indexing) against K1 over the
    single operand."""
    import torch

    from plnlp_tpu_torch.ops import scatter_matmul as sm
    from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel, _k1, shard_node_features
    from plnlp_tpu_torch.parallel.mesh import Mesh
    from plnlp_tpu_torch.parallel.partition import partition_graph, with_halo

    S, dev, n = 4, graph.blk_src.device, graph.num_nodes
    t0 = time.perf_counter()
    pg = with_halo(partition_graph(src, dst, None, num_nodes=n, num_shards=S, block=BLOCK,
                                   symmetrize=True, reorder="bfs"))
    build_s = time.perf_counter() - t0
    shards = [GraphParallel.place(pg, Mesh(1, S, rank=s, device=dev), "halo") for s in range(S)]
    rps = pg.rows_per_shard
    log(f"[shards] S={S} reorder={pg.reorder} rows_per_shard={rps} shard_edges={pg.shard_edges} "
        f"halo q={pg.halo_quota} qh={pg.halo_hubs}, built in {build_s:.2f} s")

    def to_slots(v):  # (n, D) in node order -> (S * rps, D): the gathered buffer
        return torch.cat([shard_node_features(v, shard) for shard in shards])

    def halo_body(v_slots, d, direction):
        plan = getattr(shards[d], f"{direction}_halo")
        rows = [v_slots[s * rps:(s + 1) * rps] for s in range(S)]
        sends = [getattr(shards[s], f"{direction}_halo")["send_idx"].reshape(S, -1)[d]
                 for s in range(S)]
        hubs = [getattr(shards[s], f"{direction}_halo")["hub_idx"] for s in range(S)]
        buf = torch.cat([r.index_select(0, i) for r, i in zip(rows, sends)]
                        + [r.index_select(0, i) for r, i in zip(rows, hubs)])
        return _k1(rows[d], plan["loc"], shards[d]) + _k1(buf, plan["rem"], shards[d])

    def bodies(v_slots, direction):
        return {
            "all_gather": [_k1(v_slots, getattr(shards[d], direction), shards[d])
                           for d in range(S)],
            "halo": [halo_body(v_slots, d, direction) for d in range(S)],
        }

    def to_nodes(parts):
        return torch.cat(parts).index_select(0, shards[0].node_map)

    sm.LAUNCHES = 0
    ok = True
    for direction, g in (("fwd", graph), ("bwd", graph_t)):
        v = torch.randn(n, WIDTH, device=dev, generator=gen)
        kargs = (g.blk_src, g.blk_local, g.blk_weight, g.blk_rowptr, g.block_rows, n)
        want = sm.scatter_matmul(v, *kargs)
        scale = sm.scatter_matmul_reference(v.abs(), g.blk_src, g.blk_local, g.blk_weight.abs(),
                                            g.blk_rowptr, g.block_rows, n)
        v_slots = to_slots(v)
        for body, parts in bodies(v_slots, direction).items():
            ea, ratio, good = sum_errors(to_nodes(parts), want, scale)
            ok &= good
            log(f"[shards] {direction} {body}: 4 shards' K1 reassembled vs K1 over the single "
                f"operand: max_abs={ea:.3e} max err/tol={ratio:.3f} ok={good}")
        torch.cuda.synchronize()
    # a direction: the single operand's K1, each shard's all_gather K1, and
    # each shard's halo K1 twice (local, remote)
    launches, want_launches = sm.LAUNCHES, 2 * (1 + S + 2 * S)
    require(launches == want_launches,
            f"{launches} K1 launches over the shards, want {want_launches}")
    require(ok, "K1 over the 4 shards differs from K1 over the single operand")
    x_slots = to_slots(torch.randn(n, WIDTH, device=dev, generator=gen))
    xn = x_slots.index_select(0, shards[0].node_map)
    single_ms = cuda_ms(lambda: sm.scatter_matmul(xn, graph.blk_src, graph.blk_local,
                                                  graph.blk_weight, graph.blk_rowptr,
                                                  graph.block_rows, n), reps=10, runs=3)
    ag_ms = [cuda_ms(lambda d=d: _k1(x_slots, shards[d].fwd, shards[d]), reps=10, runs=3)
             for d in range(S)]
    halo_ms = [cuda_ms(lambda d=d: halo_body(x_slots, d, "fwd"), reps=10, runs=3)
               for d in range(S)]
    log(f"[shards] forward K1 per shard, all_gather body "
        f"{', '.join(f'{t:.4f}' for t in ag_ms)} ms (sum {sum(ag_ms):.4f}); halo body with its "
        f"buffer's gather {', '.join(f'{t:.4f}' for t in halo_ms)} ms (sum {sum(halo_ms):.4f}); "
        f"K1 over the single operand {single_ms:.4f} ms; card {card}")
    return {"build_s": build_s, "ag_ms": ag_ms, "halo_ms": halo_ms, "single_ms": single_ms}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _parallel_rank(rank, world, port, out_path, opts):
    """One rank of the partitioned path (its own process, its own card)."""
    import datetime

    import torch
    import torch.distributed as dist

    cuda = opts["backend"] == "nccl"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:  # a rehearsal on the CPU under gloo
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group(
        opts["backend"], init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S),
        device_id=dev if cuda else None,
    )
    try:
        result = _parallel_work(rank, world, dev, opts)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _parallel_work(rank, world, dev, opts):
    """Phase 32 on one rank; rank 0's numbers are returned."""
    import torch

    from plnlp_tpu_torch import prepare_graph
    from plnlp_tpu_torch.data import make_synthetic_dataset
    from plnlp_tpu_torch.ops import scatter_matmul as sm
    from plnlp_tpu_torch.parallel import make_graph_parallel, make_mesh
    from plnlp_tpu_torch.serve import Scorer
    from plnlp_tpu_torch.training import Model, ModelConfig

    cuda = dev.type == "cuda"
    say = log if rank == 0 else (lambda _msg: None)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n, seed, width, batch = opts["n_nodes"], opts["seed"], opts["width"], opts["batch"]
    ds = make_synthetic_dataset("hits", num_nodes=n, num_edges=opts["n_edges"], seed=seed)
    src, dst = ds["edge_index"]
    graph, graph_t = prepare_graph(src, dst, None, num_nodes=n, symmetrize=True, block=BLOCK,
                                   device=dev)
    twin, _ = prepare_graph(src, dst, None, num_nodes=n, symmetrize=True, block=None, device=dev)
    pos = torch.as_tensor(ds["split_edge"]["train"]["edge"], device=dev)
    split = {s: {"pos": ds["split_edge"][s]["edge"], "neg": ds["split_edge"][s]["edge_neg"]}
             for s in ("valid", "test")}
    pairs = np.random.default_rng(seed).integers(0, n, (opts["pairs"], 2))
    steps = -(-pos.shape[0] // batch)
    cfg = ModelConfig(encoder="SAGE", predictor="DOT", gnn_num_layers=2, emb_hidden_channels=width,
                      gnn_hidden_channels=width, mlp_hidden_channels=width, batch_size=batch)
    mlp_cfg = dataclasses.replace(cfg, predictor="MLP")

    def k1():
        return {"K1": sm.LAUNCHES, "K1bf16": sm.LAUNCHES_BF16}

    def zero():
        sync()
        sm.LAUNCHES = sm.LAUNCHES_BF16 = 0

    def launches_ok(what, want):
        got = k1()
        if cuda:  # a wrapper counts where it launches the kernel: on the card
            require(got == want, f"rank {rank} {what}: launches {got}, want {want}")
        return got

    def time_steps(model, opt, g, g_t, mesh, reps=5):
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        pos_b = pos[:batch]
        neg_b = model.sample_negatives(gen, twin, pos_b)
        mask = torch.ones(pos_b.shape[0], device=dev)
        kw = {} if mesh is None else {"mesh": mesh}
        model.train_step(opt, g, g_t, None, pos_b, neg_b, None, mask, 1e-3, gen, **kw)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            model.train_step(opt, g, g_t, None, pos_b, neg_b, None, mask, 1e-3, gen, **kw)
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    def epoch(model, opt, g, g_t, mesh):
        gen = torch.Generator(device=dev).manual_seed(seed)
        zero()
        t0 = time.perf_counter()
        loss = model.train_epoch(opt, g, g_t, None, pos, None, gen, 1e-3, sample_graph=twin,
                                 mesh=mesh)
        sync()
        return loss, time.perf_counter() - t0

    out = {"world": world, "steps": steps, "comm": {}, "launches": {"K1": 0, "K1bf16": 0}}

    def add(counts):
        for k, v in counts.items():
            out["launches"][k] += v

    # the single operand's step and epoch on this card, for comparison
    ref_mlp = Model(mlp_cfg, n, seed=seed, device=dev)
    opt = ref_mlp.make_optimizer()
    out["single_step_ms"] = time_steps(ref_mlp, opt, graph, graph_t, None)
    single = Model(mlp_cfg, n, seed=seed, device=dev)
    loss, out["single_epoch_s"] = epoch(single, single.make_optimizer(), graph, graph_t, None)
    require(math.isfinite(loss), f"single-operand epoch loss {loss}")
    del ref_mlp, single, opt

    mesh = make_mesh(1, world, device=dev)
    gp_ag = None
    for comm in ("all_gather", "halo"):
        per_pass = 1 if comm == "all_gather" else 2  # K1 launches a SpMM pass: halo runs local + remote
        sync()
        t0 = time.perf_counter()
        gp = make_graph_parallel(src, dst, None, num_nodes=n, mesh=mesh, block=BLOCK,
                                 symmetrize=True, comm=comm, reorder="bfs")
        sync()
        r = {"build_s": time.perf_counter() - t0, "rows_per_shard": gp.rows_per_shard,
             "reorder": gp.pg.reorder, "shard_edges": list(gp.pg.shard_edges),
             "halo_quota": gp.pg.halo_quota, "halo_hubs": gp.pg.halo_hubs}
        say(f"[parallel] W={world} comm={comm}: partition reorder={gp.pg.reorder} "
            f"rows_per_shard={gp.rows_per_shard} shard_edges={gp.pg.shard_edges} halo "
            f"q={gp.pg.halo_quota} qh={gp.pg.halo_hubs} built in {r['build_s']:.2f} s")

        # the partitioned encode against the single operand's, same parameters
        ref = Model(cfg, n, seed=seed, device=dev)
        model = copy.deepcopy(ref).place_rows(gp)
        zero()
        h = model.encode(gp)
        sync()
        add(launches_ok("encode", {"K1": 2 * per_pass, "K1bf16": 0}))
        h_ref = ref.encode(graph, graph_t)
        with torch.no_grad():
            for p in ref.parameters():
                p.abs_()
        h_abs = ref.encode(graph, graph_t)  # the terms' magnitudes (no cancellation)
        tol = SUM_ATOL + SUM_RTOL * h_abs
        ratio = float(((h - h_ref).abs() / tol).max())
        r["encode_max_abs"] = float((h - h_ref).abs().max())
        r["encode_err_over_tol"] = ratio
        say(f"[parallel] {comm}: partitioned encode vs the single operand's: max_abs="
            f"{r['encode_max_abs']:.3e} max err/tol={ratio:.3f} (tol {SUM_ATOL} + "
            f"{SUM_RTOL}*sum|terms|)")
        require(ratio <= 1.0, f"{comm}: partitioned encode differs from the single operand's")
        del ref, h_ref, h_abs

        # one epoch, a test and scoring
        mlp = Model(mlp_cfg, n, seed=seed, device=dev).place_rows(gp)
        opt = mlp.make_optimizer()
        loss, r["epoch_s"] = epoch(mlp, opt, gp, None, mesh)
        add(launches_ok("epoch", {"K1": 4 * per_pass * steps, "K1bf16": 0}))
        require(math.isfinite(loss), f"{comm}: epoch loss {loss}")
        r["loss"] = loss
        r["step_ms"] = time_steps(mlp, opt, gp, None, mesh)
        zero()
        hits = mlp.test(gp, None, None, split, "hits", mesh=mesh)
        sync()
        add(launches_ok("test", {"K1": 2 * per_pass, "K1bf16": 0}))
        require(all(0.0 <= v <= 1.0 for pair in hits.values() for v in pair), f"hits {hits}")
        zero()
        scores = Scorer(model, gp, mesh=mesh).score(pairs)
        scores_mlp = Scorer(mlp, gp, mesh=mesh).score(pairs)
        add(launches_ok("two scorers", {"K1": 4 * per_pass, "K1bf16": 0}))
        require(scores.shape == (len(pairs),) and np.isfinite(scores).all(), "DOT scores")
        require(scores_mlp.shape == (len(pairs),) and np.isfinite(scores_mlp).all(), "MLP scores")
        r["hits"] = hits
        say(f"[parallel] {comm}: epoch loss {loss:.4f} in {r['epoch_s']:.3f} s ({steps} steps, "
            f"K1 {4 * per_pass} a step), step {r['step_ms']:.2f} ms; test {json.dumps(hits)}; "
            f"score {len(pairs)} pairs finite (DOT, MLP)")
        out["comm"][comm] = r
        if comm == "all_gather":
            gp_ag = gp
        del model, mlp, opt, h
        if cuda:
            torch.cuda.empty_cache()

    # one epoch in bf16: only K1-bf16 launches
    bf = Model(dataclasses.replace(mlp_cfg, compute_dtype="bfloat16"), n, seed=seed,
               device=dev).place_rows(gp_ag)
    opt = bf.make_optimizer()
    loss, out["bf16_epoch_s"] = epoch(bf, opt, gp_ag, None, mesh)
    add(launches_ok("bf16 epoch", {"K1": 0, "K1bf16": 4 * steps}))
    require(math.isfinite(loss), f"bf16 epoch loss {loss}")
    require(all(p.dtype == torch.float32 for p in bf.parameters()), "bf16: parameters stay f32")
    out["bf16_loss"] = loss
    out["bf16_step_ms"] = time_steps(bf, opt, gp_ag, None, mesh)
    say(f"[parallel] bf16 (all_gather): epoch loss {loss:.4f} in {out['bf16_epoch_s']:.3f} s, "
        f"step {out['bf16_step_ms']:.2f} ms, only K1-bf16 launched")
    del bf, opt

    if world == 4:
        # (data, node) = (2, 2): pair batches over 'data', the graph over 'node'
        mesh22 = make_mesh(2, 2, device=dev)
        gp22 = make_graph_parallel(src, dst, None, num_nodes=n, mesh=mesh22, block=BLOCK,
                                   symmetrize=True, comm="all_gather", reorder="bfs")
        m22 = Model(mlp_cfg, n, seed=seed, device=dev).place_rows(gp22)
        loss, out["mesh22_epoch_s"] = epoch(m22, m22.make_optimizer(), gp22, None, mesh22)
        require(math.isfinite(loss), f"(2, 2) epoch loss {loss}")
        hits = m22.test(gp22, None, None, split, "hits", mesh=mesh22)
        out["mesh22_loss"], out["mesh22_hits"] = loss, hits
        say(f"[parallel] mesh (data=2, node=2): epoch loss {loss:.4f} in "
            f"{out['mesh22_epoch_s']:.3f} s; test {json.dumps(hits)}")
    return out


def spawn_ranks(world: int, opts: dict, tmp: str) -> dict:
    """Run ``_parallel_rank`` on ``world`` processes, one card each; rank
    0's result.  Every process is joined or killed before this returns."""
    import torch.multiprocessing as mp

    out = os.path.join(tmp, f"parallel_w{world}.json")
    ctx = mp.start_processes(_parallel_rank, args=(world, _free_port(), out, opts), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            require(time.monotonic() < deadline, f"{world} ranks ran past {PARALLEL_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    with open(out) as f:
        return json.load(f)


def parallel_path(args, card, tmp):
    """Phase 32: the partitioned path at collab's width on W ranks."""
    import torch

    world = min(torch.cuda.device_count(), MAX_RANKS)
    log(f"[parallel] W={world} rank(s) over NCCL, one card each "
        f"({torch.cuda.device_count()} card(s) here); card {card}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn_ranks(world, {
        "backend": "nccl", "seed": args.seed, "n_nodes": N_NODES, "n_edges": N_EDGES,
        "width": WIDTH, "batch": BATCH, "pairs": CLI_PAIRS,
    }, tmp)
    log(f"[parallel] W={world}: single operand step {res['single_step_ms']:.2f} ms, epoch "
        f"{res['single_epoch_s']:.3f} s; partitioned all_gather step "
        f"{res['comm']['all_gather']['step_ms']:.2f} ms, epoch "
        f"{res['comm']['all_gather']['epoch_s']:.3f} s, build "
        f"{res['comm']['all_gather']['build_s']:.2f} s; halo step "
        f"{res['comm']['halo']['step_ms']:.2f} ms, epoch {res['comm']['halo']['epoch_s']:.3f} s, "
        f"build {res['comm']['halo']['build_s']:.2f} s; bf16 step {res['bf16_step_ms']:.2f} ms, "
        f"epoch {res['bf16_epoch_s']:.3f} s; rank 0's K1 launches {res['launches']}; "
        f"phase {time.perf_counter() - t0:.1f} s; card {card}")
    return res


def cli_torchrun_phase(args, world: int, tmp: str):
    """Phase 33: the collab command through torchrun with --num_shards W
    for one epoch (W = 1: one rank, the single-device operand)."""
    root = os.path.dirname(os.path.abspath(__file__))
    metrics = os.path.join(tmp, "torchrun.jsonl")
    cmd = [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        f"--nproc_per_node={world}", "-m", "plnlp_tpu_torch", *collab_flags(args.seed),
        "--num_shards", str(world), "--epochs", "1", "--metrics_file", metrics,
    ]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                       timeout=PARALLEL_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = [line for line in r.stdout.splitlines() if line.strip()]
    for line in lines:
        if line.startswith(("partition", "Run:", "Training Time")):
            log(f"[torchrun] {line}")
    require(r.returncode == 0,
            f"torchrun exited {r.returncode}: {(r.stderr or r.stdout)[-2000:]}")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    require(len(rows) == 1 and math.isfinite(rows[0]["loss"]), f"torchrun metrics {rows}")
    if world > 1:
        require(any(line.startswith(f"partition: S={world}") for line in lines),
                "torchrun: no partition line")
    log(f"[torchrun] --num_shards {world}: one epoch, loss {rows[0]['loss']:.4f}, epoch "
        f"{rows[0]['epoch_seconds']:.3f} s, {seconds:.1f} s in all")
    return rows[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        from plnlp_tpu_torch import _build, prepare_graph
        from plnlp_tpu_torch.data import make_synthetic_dataset
        from plnlp_tpu_torch.ops import scatter_matmul as sm
        from plnlp_tpu_torch.ops.spmm import _mean_scale, spmm
        from plnlp_tpu_torch.serve import Scorer
        from plnlp_tpu_torch.training import Model, ModelConfig
    except ImportError as exc:
        print(f"chip_smoke: the plnlp_tpu_torch package is missing ({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build(_build.sources())
    log(f"[build] {sorted(_build.sources())} in {time.perf_counter() - t0:.2f} s")
    from plnlp_tpu_torch import native

    t0 = time.perf_counter()
    require(native.available(), "the native host library builds (g++)")
    log(f"[build] native host library csrc/graphcore.cpp (g++ -O3 -march=native -fopenmp) "
        f"in {time.perf_counter() - t0:.2f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")

    # 2. card -----------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 3. data -----------------------------------------------------------------
    t0 = time.perf_counter()
    ds = make_synthetic_dataset("hits", num_nodes=N_NODES, num_edges=N_EDGES, seed=args.seed)
    src, dst = ds["edge_index"]
    # with the slot map TRANSFORMER's blocked backward needs (phase 29);
    # SAGE ignores it
    graph, graph_t = prepare_graph(
        src, dst, None, num_nodes=N_NODES, symmetrize=True, block=BLOCK, device=dev,
        couple_transpose=True,
    )
    torch.cuda.synchronize()
    n, e = graph.num_nodes, graph.num_edges
    nblk, nblk_t = graph.blk_src.shape[0], graph_t.blk_src.shape[0]
    log(
        f"[data] N={n} E={e} (after symmetrize+coalesce) nblk={nblk} "
        f"nblk_t={nblk_t} max_degree={graph.max_degree} "
        f"in {time.perf_counter() - t0:.2f} s"
    )
    hub_share = float((graph.blk_rowptr[1] - graph.blk_rowptr[0]) * BLOCK[1]) / max(e, 1)
    log(f"[data] row-block 0 holds {hub_share:.1%} of the edge slots (hub row-block)")

    # 4. kernel against its plain version -----------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn(n, WIDTH, device=dev, generator=gen)
    max_abs = 0.0
    checks_ok = True
    def abs_sum(g, v):
        return sm.scatter_matmul_reference(
            v.abs(), g.blk_src, g.blk_local, g.blk_weight.abs(), g.blk_rowptr,
            g.block_rows, n,
        )

    for label, g in (("graph", graph), ("graph_t", graph_t)):
        kargs = (g.blk_src, g.blk_local, g.blk_weight, g.blk_rowptr, g.block_rows, n)
        got = sm.scatter_matmul(x, *kargs)
        require(torch.equal(got, sm.scatter_matmul(x, *kargs)),
                f"scatter_matmul on {label}: a second launch differs")
        want = sm.scatter_matmul_reference(x, *kargs)
        torch.cuda.synchronize()
        ea, ratio, ok = sum_errors(got, want, abs_sum(g, x))
        max_abs = max(max_abs, ea)
        checks_ok &= ok
        log(f"[check] scatter_matmul on {label}: max_abs={ea:.3e} "
            f"max err/tol={ratio:.3f} (tol {SUM_ATOL} + {SUM_RTOL}*sum|w x|) ok={ok}")
    gy = torch.randn(n, WIDTH, device=dev, generator=gen)
    xk = x.clone().requires_grad_(True)
    out_k = spmm(graph, xk, reduce="mean", graph_t=graph_t)
    out_k.backward(gy)
    xr = x.clone().requires_grad_(True)
    out_r = _mean_scale(graph, sm.scatter_matmul_reference(
        xr, graph.blk_src, graph.blk_local, graph.blk_weight, graph.blk_rowptr,
        graph.block_rows, n,
    ))
    out_r.backward(gy)
    torch.cuda.synchronize()
    scales = (_mean_scale(graph, abs_sum(graph, x)),
              abs_sum(graph_t, _mean_scale(graph, gy)))
    for label, a, b, sc in (("spmm mean fwd", out_k.detach(), out_r.detach(), scales[0]),
                            ("spmm mean grad", xk.grad, xr.grad, scales[1])):
        ea, ratio, ok = sum_errors(a, b, sc)
        max_abs = max(max_abs, ea)
        checks_ok &= ok
        log(f"[check] {label} vs autograd through the plain version: "
            f"max_abs={ea:.3e} max err/tol={ratio:.3f} ok={ok}")
    del xk, xr, out_k, out_r, gy
    if not checks_ok:
        log("[check] FAILED: kernel disagrees with its plain version")
        return 1

    # 5. the serving path -----------------------------------------------------
    cfg = ModelConfig(
        encoder="SAGE", predictor="DOT", gnn_num_layers=2,
        emb_hidden_channels=WIDTH, gnn_hidden_channels=WIDTH, mlp_hidden_channels=WIDTH,
    )
    rng = np.random.default_rng(args.seed)
    pairs = rng.integers(0, n, (65_536, 2))
    srcs = rng.integers(0, n, 256)
    split = {
        s: {"pos": ds["split_edge"][s]["edge"], "neg": ds["split_edge"][s]["edge_neg"]}
        for s in ("valid", "test")
    }
    per_encode = cfg.gnn_num_layers

    sm.LAUNCHES = 0
    model = Model(cfg, n, seed=args.seed, device=dev)
    scorer = Scorer(model, graph, graph_t)
    torch.cuda.synchronize()
    require(sm.LAUNCHES == per_encode, f"{sm.LAUNCHES} launches after one encode")
    scores = scorer.score(pairs)
    ids, top = scorer.rank_candidates_batch(srcs, k=50, exclude_edges=True)
    hits = model.test(graph, graph_t, None, split, "hits")
    require(sm.LAUNCHES == 2 * per_encode, f"{sm.LAUNCHES} launches after two encodes")
    model_mlp = Model(dataclasses.replace(cfg, predictor="MLP"), n, seed=args.seed, device=dev)
    scorer_mlp = Scorer(model_mlp, graph, graph_t)
    scores_mlp = scorer_mlp.score(pairs)
    torch.cuda.synchronize()
    launches = sm.LAUNCHES
    require(launches == 3 * per_encode, f"{launches} launches after three encodes")
    log(f"[serve] 3 encodes, {launches} scatter_matmul launches "
        f"({per_encode} per encode, as gnn_num_layers)")

    require(scores.shape == (65_536,) and np.isfinite(scores).all(), "DOT scores")
    require(scores_mlp.shape == (65_536,) and np.isfinite(scores_mlp).all(), "MLP scores")
    require(ids.shape == (256, 50) and np.isfinite(top).all(), "rank shapes")
    require((np.diff(top, axis=1) <= 0).all(), "top-k rows descending")
    indptr, senders = graph.indptr.cpu().numpy(), graph.senders.cpu().numpy()
    for row, s in zip(ids, srcs):
        nbrs = set(senders[indptr[s]:indptr[s + 1]].tolist())
        require(not set(row.tolist()) & nbrs, f"neighbors of {s} excluded")
    require(all(0.0 <= v <= 1.0 for pair in hits.values() for v in pair), f"hits {hits}")
    log(f"[serve] score: 65536 pairs finite (DOT and MLP); rank: 256x50, "
        f"descending, known neighbors excluded; test: {json.dumps(hits)}")

    # the same model on the CPU (plain path) must give the same encoding
    t0 = time.perf_counter()
    h_cpu = copy.deepcopy(model).to("cpu").encode(graph.to("cpu"), graph_t.to("cpu"))
    ea, er, ok = errors(scorer.h.cpu(), h_cpu)
    log(f"[serve] encode on the card vs on the CPU: max_abs={ea:.3e} max_rel={er:.3e} "
        f"ok={ok} (CPU encode {time.perf_counter() - t0:.1f} s)")
    if not ok:
        return 1
    s_cpu = (h_cpu[pairs[:, 0]] * h_cpu[pairs[:, 1]]).sum(-1).numpy()
    ea_s = float(np.abs(s_cpu - scores).max())
    log(f"[serve] DOT scores vs the CPU encoding: max_abs={ea_s:.3e}")
    if not np.allclose(scores, s_cpu, rtol=TOL, atol=TOL):
        return 1

    # 6. timings ------------------------------------------------------------
    kargs = (graph.blk_src, graph.blk_local, graph.blk_weight, graph.blk_rowptr, BLOCK[0], n)
    ms = cuda_ms(lambda: sm.scatter_matmul(x, *kargs), reps=20, runs=5)
    plain_ms = cuda_ms(lambda: sm.scatter_matmul_reference(x, *kargs), reps=3, runs=3)
    adj = torch.sparse_csr_tensor(
        graph.indptr.long(), graph.senders.long(), graph.edge_weight, size=(n, n),
        check_invariants=True,
    )
    lib_out = torch.sparse.mm(adj, x)
    lib_err = float((lib_out - sm.scatter_matmul(x, *kargs)).abs().max())
    library_ms = cuda_ms(lambda: torch.sparse.mm(adj, x), reps=20, runs=5)
    kt_args = (graph_t.blk_src, graph_t.blk_local, graph_t.blk_weight, graph_t.blk_rowptr,
               BLOCK[0], n)
    ms_t = cuda_ms(lambda: sm.scatter_matmul(x, *kt_args), reps=20, runs=5)

    # Least time for the same work: each input read once (x, the blocked
    # metadata, the row pointer), the output written once; the f32 multiply-
    # adds of the real edges.
    nbytes = 2 * n * WIDTH * 4 + nblk * BLOCK[1] * 12 + graph.blk_rowptr.numel() * 4
    flops = 2 * e * WIDTH
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    gather_ms = (e * WIDTH * 4 + nbytes - n * WIDTH * 4) / HBM_BYTES_PER_S * 1e3
    log(f"[time] scatter_matmul graph {ms:.4f} ms, graph_t {ms_t:.4f} ms; plain "
        f"{plain_ms:.4f} ms; torch.sparse.mm (CSR) {library_ms:.4f} ms "
        f"(max_abs vs kernel {lib_err:.3e}); bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.3f} GFLOP); no-reuse gather bound "
        f"{gather_ms:.4f} ms; card {card}")

    # Whether the hub still sets the time: the sub-blocks of row-block 0
    # alone, then every other row-block's alone (a row pointer that empties
    # the rest; the kernel reads only sub-blocks [blk_rowptr[0],
    # blk_rowptr[-1]), so each share runs on its own slots' runs).
    hub_ptr = graph.blk_rowptr.clone()
    hub_ptr[2:] = hub_ptr[1]
    rest_ptr = graph.blk_rowptr.clone()
    rest_ptr[0] = rest_ptr[1]
    split_ms = [
        cuda_ms(lambda p=p: sm.scatter_matmul(x, *kargs[:3], p, *kargs[4:]), reps=20, runs=5)
        for p in (hub_ptr, rest_ptr)
    ]
    log(f"[time] scatter_matmul hub row-block 0's sub-blocks alone {split_ms[0]:.4f} ms "
        f"({hub_share:.1%} of edge slots); all other row-blocks {split_ms[1]:.4f} ms; "
        f"card {card}")

    encode_ms = cuda_ms(lambda: model.encode(graph, graph_t), reps=3, runs=3)
    score_ms = cuda_ms(lambda: scorer.score(pairs), reps=5, runs=3)
    t0 = time.perf_counter()
    scorer.rank_candidates_batch(srcs, k=50, exclude_edges=True)
    torch.cuda.synchronize()
    rank_s = time.perf_counter() - t0
    log(f"[time] encode (2-layer SAGE, N={n}, D={WIDTH}) {encode_ms:.3f} ms; "
        f"score 65536 pairs {score_ms:.3f} ms ({65_536 / score_ms * 1e3:.4g} pairs/s); "
        f"rank 256 sources x {n} candidates k=50 exclude_edges {rank_s * 1e3:.1f} ms "
        f"({256 * n / rank_s:.4g} pairs/s); card {card}")

    del model, model_mlp, scorer, scorer_mlp, x, adj, lib_out
    train_kernels, k1_train_launches, data, small = train_path(args, dev, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="plnlp_chip_smoke_") as tmp:
        cli_launches = cli_path(args, dev, card, tmp)
        torch.cuda.empty_cache()
        bf16_kernels = bf16_path(args, dev, card, graph, graph_t, ds, split, data, small, tmp)
        torch.cuda.empty_cache()
        flash_bf16, tf_launches = transformer_bf16_path(args, dev, card, graph, graph_t, ds,
                                                        split, data, small, tmp)
        native_phase(args, data)
        del data, small
        shard_k1_phase(graph, graph_t, src, dst, gen, card)
        torch.cuda.empty_cache()
        par = parallel_path(args, card, tmp)
        cli_torchrun_phase(args, par["world"], tmp)
    for entry, kernel in zip(train_kernels, ("K2", "K3", "K4", "K5")):
        entry["launches"] += cli_launches[kernel]
    bf16_kernels[0]["launches"] += tf_launches["K1bf16"] + par["launches"]["K1bf16"]

    kernels = [{
        "name": "scatter_matmul",
        "route": "cuda",
        "source": "plnlp_tpu_torch/csrc/scatter_matmul.cu",
        "replaces": "plnlp_tpu/ops/pallas_spmm.py:51",
        "launches": (launches + k1_train_launches + cli_launches["K1"] + tf_launches["K1"]
                     + par["launches"]["K1"]),
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, *train_kernels, *bf16_kernels, *flash_bf16]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
