#!/usr/bin/env python3
"""Drive the plnlp_tpu_torch serving and training paths (SAGE and
TRANSFORMER) on one NVIDIA GPU and check them.

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
   products each skips printed beside it; print one ``{"kernels": [...]}``
   line listing K1 to K5;
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
20. print ``{"ok": true, "device": {...}}`` as the last line.

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
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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


def sum_errors(got, want, abs_sum):
    """(max abs error, max of error / tolerance, within tolerance) for a
    kernel output against its plain version; ``abs_sum`` is the same sum
    over the terms' magnitudes."""
    diff = (got - want).abs()
    ratio = float((diff / (SUM_ATOL + SUM_RTOL * abs_sum)).max())
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
        "seconds": (t_gen, t_est, t_build),
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


def card_vs_cpu_step(cfg, small, args, dev) -> None:
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

    Tolerances.  The loss within 1e-5 relative; the gradient of each
    clipping group (embedding, encoder, predictor) within 1e-4 in relative
    L2 norm (f32 sums in another order); every parameter after the step
    within 1e-5 + 1e-5 * |p|."""
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
    require(abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), f"loss card {loss_g} vs CPU {loss_c}")
    pairs = [(k, a, b) for (k, a), (_, b) in zip(m_gpu.named_parameters(), m_cpu.named_parameters())]
    group_err = {}
    for group in ("emb", "encoder", "predictor"):
        members = [(a, b) for k, a, b in pairs if k.split(".")[0] == group]
        require(members, f"parameters of {group}")
        diff = sum(float((a.grad.cpu() - b.grad).square().sum()) for a, b in members)
        ref = sum(float(b.grad.square().sum()) for _, b in members)
        group_err[group] = (diff / max(ref, 1e-60)) ** 0.5
        require(group_err[group] <= 1e-4,
                f"{group} gradient relative L2 error {group_err[group]:.3e}")
    worst_param, worst_ratio = 0.0, 0.0
    for k, a, b in pairs:
        d = (a.detach().cpu() - b.detach()).abs()
        ratio = float((d / (1e-5 + 1e-5 * b.detach().abs())).max())
        worst_param, worst_ratio = max(worst_param, float(d.max())), max(worst_ratio, ratio)
        require(ratio <= 1.0, f"{k} after the step: max |diff|/tol {ratio:.3f}")
    log(f"[train] card vs CPU, {cfg.encoder}: one SGD step with CE at N={n} (nt={hg.num_tiles}, batch "
        f"{pos.shape[0]}): loss {loss_g:.9g} vs {loss_c:.9g}; gradient relative L2 error "
        + ", ".join(f"{g} {e:.3e}" for g, e in group_err.items())
        + f" (tol 1e-4); parameters after the step max |diff| {worst_param:.3e}, max "
        f"|diff|/tol {worst_ratio:.3f} (tol 1e-5 + 1e-5 |p|); CPU step {cpu_s:.1f} s")


def train_path(args, dev, card):
    """Phases 7-16; returns the entries of K2-K5 in the kernels line and
    K1's launches on the training path (epoch and test)."""
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
    tm.LAUNCHES = sm.LAUNCHES = 0
    t0 = time.perf_counter()
    loss = model.train_epoch(
        opt, hg, None, None, data["pos"], None, gen, cfg.lr, sample_graph=data["sample_graph"]
    )
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    k2_epoch, k1_epoch = tm.LAUNCHES, sm.LAUNCHES
    log(f"[train] one epoch: {steps} steps, mean loss {loss:.6g}, {k2_epoch} tile_matmul "
        f"and {k1_epoch} scatter_matmul launches; {epoch_s:.3f} s; card {card}")
    # the epoch's loss is the count-weighted mean of every step's loss, so
    # it is finite only if every step's is
    require(math.isfinite(loss), f"epoch loss {loss}")
    require(k2_epoch == 4 * steps and k1_epoch == 4 * steps,
            f"{k2_epoch}/{k1_epoch} launches in {steps} steps (want 4 each a step)")
    tm.LAUNCHES = sm.LAUNCHES = 0
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
    return [k2, *flash], k1_epoch + k1_test


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
    out = [q.new_zeros((n_r, t, d)) for _ in range(2 if transposed else 1)]
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


def fwd_errors(num, ml, num_r, ml_r, num_a):
    """K3's (num, ml) against the plain version's (num_r, ml_r), with
    ``num_a`` the plain num over |v|: (max error / tolerance over y = num /
    den, m and den; whether the rows without a tile edge are exactly
    (0, 0, -inf); the mask of the rows with one)."""
    import torch

    has = ml_r[:, 1] > 0
    den_r = ml_r[:, 1].clamp(min=1e-30)[:, None]
    y_err = ((num / ml[:, 1:].clamp(min=1e-30) - num_r / den_r).abs()[has]
             / (SUM_ATOL + SUM_RTOL * num_a / den_r)[has])
    m_err = (ml[has, 0] - ml_r[has, 0]).abs() / (1e-6 * (1 + ml_r[has, 0].abs()))
    den_err = (ml[has, 1] - ml_r[has, 1]).abs() / (1e-5 * ml_r[has, 1])
    ratio = max(float(y_err.max()), float(m_err.max()), float(den_err.max()))
    empty_ok = (not num[~has].any() and not ml[~has, 1].any()
                and bool(torch.isneginf(ml[~has, 0]).all()))
    return ratio, empty_ok, has


def check_flash_kernels(fwd_set, bwd_set, q, k, v, g, n):
    """Phase 12: K3, K4 and K5 against their plain versions on the tile
    sets ``fwd_set`` and ``bwd_set`` (vals, tile_row, tile_col,
    tile_rowptr), with q, k, v, g of one (rows, D) shape; rows from ``n``
    on have no edge and must come out empty; a second launch of K3, of K4
    and of K5 must give the same bits (each row's sum runs in one order).
    Returns the stats (M, den, δ) the backward checks used and each
    kernel's max abs error."""
    import torch

    from plnlp_tpu_torch.ops import flash_tiles as ft

    n_pad = q.shape[0]
    scale = 1.0 / math.sqrt(q.shape[1])
    n_r = fwd_set[3].shape[0] - 1
    errs = {}

    # K3: y = num / den within 1e-5 + 1e-6 Σ p|v| / den, m within 1e-6 (1 + |m|),
    # den within 1e-5 relative (a sum of positive terms); rows with no tile
    # edge, the pad rows among them, exactly (0, 0, -inf)
    num, ml = ft.flash_tiles_fwd(*fwd_set, q, k, v, scale)
    again = ft.flash_tiles_fwd(*fwd_set, q, k, v, scale)
    num_r, ml_r = ft.flash_tiles_fwd_reference(*fwd_set[:3], q, k, v, n_r, scale)
    num_a, _ = ft.flash_tiles_fwd_reference(*fwd_set[:3], q, k, v.abs(), n_r, scale)
    torch.cuda.synchronize()
    same = torch.equal(num, again[0]) and torch.equal(ml, again[1])
    log(f"[check] flash_tiles_fwd: a second launch gives the same bits: {same}")
    require(same, "flash_tiles_fwd: a second launch differs")
    ratio, empty_ok, has = fwd_errors(num, ml, num_r, ml_r, num_a)
    errs["fwd"] = float((num - num_r).abs().max())
    log(f"[check] flash_tiles_fwd (K3) on tile_vals at {n_pad} rows: max_abs num "
        f"{errs['fwd']:.3e}; max err/tol {ratio:.3f} (y {SUM_ATOL} + {SUM_RTOL}*sum p|v|/den, "
        f"m 1e-6 (1+|m|), den 1e-5 den); {int(has.sum())} rows with a tile edge; rows without "
        f"one (0, 0, -inf): {empty_ok}")
    require(ratio <= 1.0 and empty_ok, "flash_tiles_fwd disagrees with its plain version")
    require(not has[n:].any(), "flash_tiles_fwd: a pad row has a tile edge")

    # the stats the backward gets: the global max and denominator of these
    # tiles, and δ = Σ_d g·y
    m_glob = torch.where(torch.isfinite(ml_r[:, 0]), ml_r[:, 0], 0.0)
    den_glob = ml_r[:, 1].clamp(min=torch.finfo(torch.float32).tiny)
    delta = (g * num_r / den_glob[:, None]).sum(-1)
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
        log(f"[check] flash_tiles_{kind}: a second launch gives the same bits: {same}")
        require(same, f"flash_tiles_{kind}: a second launch differs")
        errs[kind] = 0.0
        for name, a, b, sc in zip(("dq",) if kind == "dq" else ("dk", "dv"), got, want, mags):
            ea, ratio, ok = sum_errors(a, b, sc)
            errs[kind] = max(errs[kind], ea)
            log(f"[check] flash_tiles_{kind} ({'K4' if kind == 'dq' else 'K5'}) {name} at "
                f"{n_pad} rows: max_abs={ea:.3e} max err/tol={ratio:.3f} (tol {SUM_ATOL} + "
                f"{SUM_RTOL}*sum|terms|) ok={ok}")
            require(ok, f"flash_tiles_{kind} {name} disagrees with its plain version")
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
    ft.LAUNCHES.update(fwd=0, dq=0, dkv=0)
    tm.LAUNCHES = sm.LAUNCHES = 0
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
    for kind, (kernel, plain) in calls.items():
        ms = cuda_ms(kernel, reps=5, runs=3)
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
    return entries


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

    from plnlp_tpu_torch.ops import flash_tiles as ft
    from plnlp_tpu_torch.ops import scatter_matmul as sm
    from plnlp_tpu_torch.ops import tile_matmul as tm
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
    sm.LAUNCHES = tm.LAUNCHES = 0
    ft.LAUNCHES.update(fwd=0, dq=0, dkv=0)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            yield seen
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(Model, name, fn)
    seen["seconds"] = time.perf_counter() - t0
    seen["launches"] = {"K1": sm.LAUNCHES, "K2": tm.LAUNCHES, "K3": ft.LAUNCHES["fwd"],
                        "K4": ft.LAUNCHES["dq"], "K5": ft.LAUNCHES["dkv"]}
    seen["lines"] = tee.lines()


def _only(launches, **want):
    """The launch counts, with every kernel not named required to be 0."""
    return {k: want.get(k, 0) for k in launches}


def check_cli_scores(cli, argv, ckpt, pairs, scores, label):
    """``scores`` (from ``--score_pairs``) against the Scorer restored from
    ``ckpt`` over the operand the serving run builds, on the pairs mapped
    through the trained run's relabel; the same computation, so within
    1e-6."""
    from plnlp_tpu_torch.serve import Scorer

    exp = cli.prepare_experiment(cli.argument(argv), log=lambda *_: None, serving=True)
    want = Scorer.from_checkpoint(
        exp["model"], ckpt, exp["graph"], exp["graph_t"], exp["node_feats"]
    ).score(pairs if exp["node_relabel"] is None else exp["node_relabel"][pairs])
    err = float(np.abs(scores - want).max())
    require(scores.shape == (len(pairs),) and np.isfinite(scores).all(), f"{label} scores")
    require(np.allclose(scores, want, rtol=1e-6, atol=1e-6),
            f"{label}: --score_pairs vs the restored Scorer max_abs {err:.3e}")
    return exp["node_relabel"], err


def cli_path(args, dev, card, tmp):
    """Phases 17-19; returns the launches of K1-K5 in them."""
    import torch

    from plnlp_tpu_torch import cli
    from plnlp_tpu_torch.checkpoint import CheckpointManager
    from plnlp_tpu_torch.profiling import summarize_trace

    total = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)
    rng = np.random.default_rng(args.seed)
    t_phases = time.perf_counter()

    # 17. the collab command over blocked CSR ------------------------------
    ck, mf, pd = (os.path.join(tmp, name) for name in ("collab_ck", "collab.jsonl", "trace"))
    collab = [
        "--data_name",
        f"synthetic:hits:num_nodes={N_NODES},num_edges={N_EDGES},weighted=1,with_year=1",
        "--predictor", "DOT", "--use_valedges_as_input", "True", "--year", "2010",
        "--eval_last_best", "True", "--dropout", "0.3", "--adj_backend", "csr",
        "--eval_steps", "1", "--runs", "1", "--checkpoint_dir", ck, "--checkpoint_every", "1",
        "--metrics_file", mf, "--profile_dir", pd, "--seed", str(args.seed),
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
    ddi = [
        "--data_name", f"synthetic:hits:num_nodes={DDI_NODES},num_edges={DDI_EDGES}",
        "--emb_hidden_channels", "512", "--gnn_hidden_channels", "512",
        "--mlp_hidden_channels", "512", "--num_neg", "3", "--dropout", "0.3",
        "--epochs", "1", "--eval_steps", "1", "--runs", "1", "--metrics_file", mf_b,
        "--seed", str(args.seed),
    ]
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
    sbm = [
        "--data_name", f"synthetic:hits-sbm:num_nodes={SBM_NODES},num_edges={SBM_EDGES},"
        f"num_communities={SBM_COMMUNITIES}",
        "--encoder", "TRANSFORMER", "--epochs", "1", "--eval_steps", "1", "--runs", "1",
        "--checkpoint_dir", ck_c, "--checkpoint_every", "1", "--seed", str(args.seed),
    ]
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
    graph, graph_t = prepare_graph(
        src, dst, None, num_nodes=N_NODES, symmetrize=True, block=BLOCK, device=dev
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
    train_kernels, k1_train_launches = train_path(args, dev, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="plnlp_chip_smoke_") as tmp:
        cli_launches = cli_path(args, dev, card, tmp)
    for entry, kernel in zip(train_kernels, ("K2", "K3", "K4", "K5")):
        entry["launches"] += cli_launches[kernel]

    kernels = [{
        "name": "scatter_matmul",
        "route": "cuda",
        "source": "plnlp_tpu_torch/csrc/scatter_matmul.cu",
        "replaces": "plnlp_tpu/ops/pallas_spmm.py:51",
        "launches": launches + k1_train_launches + cli_launches["K1"],
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, *train_kernels]
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
