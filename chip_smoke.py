#!/usr/bin/env python3
"""Drive the plnlp_tpu_torch serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. build every CUDA kernel of the port from ``plnlp_tpu_torch/csrc``;
2. print the card's name and power limit;
3. build ogbl-collab-sized synthetic data (235,868 nodes, 1,179,052 drawn
   edges, symmetrized) and the blocked CSR graph and its transpose with the
   CLI's default block (512, 512);
4. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (x of shape (N, 256) over the graph and
   its transpose), gradient included;
5. drive the serving path through the library entry points at full collab
   width (2-layer SAGE, width 256, DOT predictor): ``Scorer.score``,
   ``rank_candidates_batch(exclude_edges=True)`` and ``Model.test``, then
   ``score`` again with the MLP predictor; the kernel launch counts must
   show ``gnn_num_layers`` launches per encode, and the encode must agree
   with the same model run on the CPU (the plain path);
6. time each kernel, its plain version, one PyTorch library call computing
   the same function, the encode and the scoring rate; print one
   ``{"kernels": [...]}`` line;
7. print ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_NODES = 235_868  # ogbl-collab
N_EDGES = 1_179_052
BLOCK = (512, 512)  # cli.py --block_rows/--block_edges defaults
WIDTH = 256
TOL = 1e-4  # rtol = atol for values that are not long sums (h, scores)
# A kernel output is a sum of up to max_degree (26k here) f32 terms, added in
# another order than the plain version adds them (shared-memory atomics vs
# index_add_), so its rounding error scales with the sum of the terms'
# magnitudes, not with the result (hub rows cancel to small values while
# carrying ~1e-3 of rounding).  Kernel checks therefore require
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

    # Where the kernel's time goes: the hub row-block 0 alone, then every
    # other row-block alone (a row pointer that empties the rest).
    hub_ptr = graph.blk_rowptr.clone()
    hub_ptr[2:] = hub_ptr[1]
    rest_ptr = graph.blk_rowptr.clone()
    rest_ptr[0] = rest_ptr[1]
    split_ms = [
        cuda_ms(lambda p=p: sm.scatter_matmul(x, *kargs[:3], p, *kargs[4:]), reps=20, runs=5)
        for p in (hub_ptr, rest_ptr)
    ]
    log(f"[time] scatter_matmul hub row-block 0 alone {split_ms[0]:.4f} ms "
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

    kernels = [{
        "name": "scatter_matmul",
        "route": "cuda",
        "source": "plnlp_tpu_torch/csrc/scatter_matmul.cu",
        "replaces": "plnlp_tpu/ops/pallas_spmm.py:51",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
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
