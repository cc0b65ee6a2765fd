"""The training CLI (port of plnlp_tpu/cli.py): ``python -m plnlp_tpu_torch``.

The flag surface is the JAX package's, field for field (the reference's 33
flags with their names and defaults, plus its extras), so its command
lines, and the reference README's repro commands, run here unchanged.

Pipeline (reference main.py:69-305): load the dataset -> dataset surgery
(citation2 symmetrize; collab year filter and val-edges-as-input with
degree-normalized train weights) -> encoder-specific adjacency
normalization -> the aggregation operand (dense, blocked CSR or hybrid,
chosen per graph; hybrid relabels the id space into slot order) -> the
multi-run train/eval protocol with the Logger, optional per-epoch
random-walk augmentation and linear LR decay, checkpoint/resume,
preemption, metrics and a profiler trace.  ``--score_pairs`` serves a
checkpoint instead of training.

Runs on ``cuda:<--device>``; library callers and tests pass ``device=``.
``--num_shards S`` (the graph partitioned over S ranks, K1 on each) and
``--mesh_data D`` (pair batches and evaluation split over D) run one
process per card under torchrun, on ``cuda:<LOCAL_RANK>``:

    torchrun --standalone --nproc_per_node=<S*D> -m plnlp_tpu_torch --num_shards S ...

Only rank 0 logs, writes metrics and writes checkpoints (the whole
embedding table in original node order, so a checkpoint resumes at any
shard count).
Randomness is positional: the parameter init of run r and the generators
of its epoch e come from ``np.random.SeedSequence([seed, r, e])``, so a
``--resume`` continues with exactly the draws an uninterrupted run makes.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from plnlp_tpu_torch import default_device
from plnlp_tpu_torch.augment import random_walk_pairs
from plnlp_tpu_torch.data import load_dataset
from plnlp_tpu_torch.dense import prepare_dense
from plnlp_tpu_torch.graph import (
    coalesce_edges,
    gcn_normalize_edges,
    prepare_graph,
    row_normalize_edges,
    to_undirected_edges,
)
from plnlp_tpu_torch.logger import Logger
from plnlp_tpu_torch.profiling import span
from plnlp_tpu_torch.training import Model, ModelConfig, adjust_lr

__all__ = ["argument", "main", "run_experiment", "prepare_experiment", "run_scoring"]

# The trained run's id-space relabel (slot -> original id), kept beside its
# checkpoints so that serving reads pairs in the ids the model was trained in.
ORDER_FILE = "node_order.npy"


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def argument(argv=None):
    """The reference's 33 flags (main.py:16-55) and the JAX package's
    extras, with the same names, types, defaults and choices."""
    parser = argparse.ArgumentParser(prog="plnlp_tpu_torch")
    parser.add_argument("--encoder", type=str, default="SAGE")
    parser.add_argument("--predictor", type=str, default="MLP")
    parser.add_argument("--optimizer", type=str, default="Adam")
    parser.add_argument("--loss_func", type=str, default="AUC")
    parser.add_argument("--neg_sampler", type=str, default="global")
    parser.add_argument("--data_name", type=str, default="ogbl-ddi")
    parser.add_argument("--data_path", type=str, default="dataset")
    parser.add_argument("--eval_metric", type=str, default="hits")
    parser.add_argument("--walk_start_type", type=str, default="edge")
    parser.add_argument("--res_dir", type=str, default="")
    parser.add_argument("--pretrain_emb", type=str, default="")
    parser.add_argument("--gnn_num_layers", type=int, default=2)
    parser.add_argument("--mlp_num_layers", type=int, default=2)
    parser.add_argument("--emb_hidden_channels", type=int, default=256)
    parser.add_argument("--gnn_hidden_channels", type=int, default=256)
    parser.add_argument("--mlp_hidden_channels", type=int, default=256)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--grad_clip_norm", type=float, default=2.0)
    parser.add_argument("--batch_size", type=int, default=64 * 1024)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--num_neg", type=int, default=1)
    parser.add_argument("--walk_length", type=int, default=5)
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--log_steps", type=int, default=1)
    parser.add_argument("--eval_steps", type=int, default=5)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--year", type=int, default=-1)
    parser.add_argument("--device", type=int, default=0, help="runs on cuda:<device>")
    parser.add_argument("--use_lr_decay", type=str2bool, default=False)
    parser.add_argument("--use_node_feats", type=str2bool, default=False)
    parser.add_argument("--use_coalesce", type=str2bool, default=False)
    parser.add_argument("--train_node_emb", type=str2bool, default=True)
    # accepted and ignored, exactly like the reference (its code is
    # commented out at main.py:152-173)
    parser.add_argument("--train_on_subgraph", type=str2bool, default=False)
    parser.add_argument("--use_valedges_as_input", type=str2bool, default=False)
    parser.add_argument("--eval_last_best", type=str2bool, default=False)
    parser.add_argument("--random_walk_augment", type=str2bool, default=False)
    # --- extras of the JAX package (no reference counterpart) ---
    parser.add_argument(
        "--adj_backend",
        type=str,
        default="auto",
        choices=["auto", "dense", "csr", "hybrid"],
        help="aggregation operand: dense adjacency (small graphs), blocked "
        "CSR, or hybrid dense tiles + blocked CSR residual over a "
        "community reorder.  'auto' picks dense at or below "
        "--dense_threshold nodes, then estimates the post-reorder tile "
        "coverage (ops.tile_spmm.estimate_hybrid, no tile build) and picks "
        "hybrid when it reaches --tile_auto_coverage, blocked CSR otherwise",
    )
    parser.add_argument(
        "--tile_auto_coverage", type=float, default=0.35,
        help="adj_backend=auto: minimum estimated dense-tile edge coverage "
        "to choose hybrid.  The default is the JAX package's (set from TPU "
        "runs); hybrid against blocked CSR on the H100 is not measured yet",
    )
    parser.add_argument(
        "--tile_min_fill", type=int, default=96,
        help="hybrid backend: minimum edges for a tile to run dense; sparser "
        "tiles stay in the residual",
    )
    parser.add_argument(
        "--tile_size", type=int, default=256,
        help="hybrid backend: dense tile edge length T (T x T tiles)",
    )
    parser.add_argument(
        "--tile_reorder", type=str, default="labelprop",
        choices=["labelprop", "multilevel", "none"],
        help="hybrid backend: locality reorder that gathers edges into dense "
        "tiles ('none' for ids that are already ordered)",
    )
    parser.add_argument("--dense_threshold", type=int, default=20000)
    parser.add_argument(
        "--block_rows", type=int, default=512,
        help="scatter-matmul row-block size; 0 = autotune on this graph",
    )
    parser.add_argument("--block_edges", type=int, default=512)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--compute_dtype",
        type=str,
        default="float32",
        choices=["float32", "bfloat16"],
        help="encoder/predictor compute dtype (parameters and optimizer stay "
        "float32)",
    )
    parser.add_argument(
        "--remat", type=str2bool, nargs="?", const=True, default=False,
        help="recompute encoder layers in the backward pass (activation "
        "memory for FLOPs)",
    )
    parser.add_argument(
        "--profile_dir", type=str, default="",
        help="capture a torch.profiler trace of run 1's epoch 2 here and log "
        "its top device ops",
    )
    parser.add_argument(
        "--metrics_file", type=str, default="",
        help="append per-epoch JSON-lines metrics (loss, edges/s)",
    )
    parser.add_argument(
        "--checkpoint_dir", type=str, default="",
        help="save parameters, optimizer state and progress here; empty = off",
    )
    parser.add_argument("--checkpoint_every", type=int, default=50,
                        help="epochs between checkpoints")
    parser.add_argument("--resume", type=str2bool, nargs="?", const=True, default=False,
                        help="resume from the latest checkpoint in --checkpoint_dir")
    parser.add_argument(
        "--prng_impl",
        type=str,
        default="rbg",
        choices=["rbg", "threefry2x32"],
        help="the JAX package's PRNG choice, accepted so that its command "
        "lines parse; selects nothing here (draws come from torch.Generators)",
    )
    parser.add_argument(
        "--max_restarts", type=int, default=0,
        help="supervise the run: on failure, restart from the latest "
        "checkpoint up to this many times (needs --checkpoint_dir)",
    )
    parser.add_argument("--reset_optimizer", type=str2bool, nargs="?", const=True, default=False,
                        help="re-init optimizer state per run (the reference "
                        "carries Adam moments across runs, model.py:85-96)")
    parser.add_argument(
        "--num_shards", type=int, default=0,
        help="shard the graph (rows and embedding table) over this many ranks "
        "on the mesh's 'node' axis, one card each (launch with torchrun); "
        "0/1 = single device",
    )
    parser.add_argument(
        "--mesh_data", type=int, default=1,
        help="size of the mesh's 'data' axis: pair batches and eval scoring "
        "split over it; num_shards x mesh_data ranks in all",
    )
    parser.add_argument(
        "--partition_comm", type=str, default="auto",
        choices=["auto", "all_gather", "halo"],
        help="multi-device feature exchange (with --num_shards > 1)",
    )
    parser.add_argument(
        "--comm_latency_rows", type=float, default=512.0,
        help="--partition_comm=auto's wire constant: per-collective latency in "
        "equivalent row transfers.  The default is the JAX package's, set for "
        "the TPU's interconnect; it is not calibrated for NCCL",
    )
    parser.add_argument(
        "--partition_reorder", type=str, default="auto",
        choices=["auto", "none", "edges", "degree", "bfs"],
        help="multi-device node->slot assignment (with --num_shards > 1)",
    )
    parser.add_argument(
        "--score_pairs", type=str, default="",
        help="serving mode: skip training, restore --checkpoint_dir, score "
        "the (M, 2) int pairs in this .npy file and exit",
    )
    parser.add_argument(
        "--score_out", type=str, default="scores.npy",
        help="output .npy for --score_pairs scores",
    )
    return parser.parse_args(argv)


# ---------------------------------------------------------------------------
# Dataset surgery (reference main.py:105-186), host-side NumPy
# ---------------------------------------------------------------------------


def apply_dataset_surgery(ds: Dict, args) -> Dict:
    """Returns {adj_src, adj_dst, adj_weight, split_edge} after the
    per-dataset tricks.  Mutates a copy of split_edge only."""
    split_edge = {
        k: dict(v) if isinstance(v, dict) else v
        for k, v in ds["split_edge"].items()
    }
    num_nodes = ds["num_nodes"]
    adj_src, adj_dst = ds["edge_index"][0], ds["edge_index"][1]
    adj_weight = ds.get("edge_weight")
    if adj_weight is not None:
        adj_weight = np.asarray(adj_weight, np.float32).reshape(-1)
    symmetrize = bool(ds.get("directed"))  # citation2: to_symmetric (main.py:109-110)

    # The reference applies the year filter and use_valedges_as_input only
    # when data_name == 'ogbl-collab' (main.py:112-130); on other ogbl-*
    # names both flags are silent no-ops, as there.  Datasets of no OGB
    # name (synthetic:*, npz:*) get the collab surgeries whenever their
    # split carries the needed keys.
    is_ogb = args.data_name.startswith("ogbl-")
    collab_like = args.data_name.startswith("ogbl-collab") or not is_ogb

    if collab_like:
        # Year filter (main.py:113-127)
        if args.year > 0 and "year" in split_edge["train"]:
            sel = split_edge["train"]["year"] >= args.year
            split_edge["train"]["edge"] = split_edge["train"]["edge"][sel]
            # a split can carry 'year' without 'weight': unit weights then
            if "weight" not in split_edge["train"]:
                split_edge["train"]["weight"] = np.ones(int(sel.sum()), np.float32)
            else:
                split_edge["train"]["weight"] = split_edge["train"]["weight"][sel]
            split_edge["train"]["year"] = split_edge["train"]["year"][sel]
            tr = split_edge["train"]["edge"]
            s, d, w = to_undirected_edges(
                tr[:, 0], tr[:, 1], split_edge["train"]["weight"], num_nodes
            )
            adj_src, adj_dst, adj_weight = s, d, w
            symmetrize = False
    if args.use_valedges_as_input and collab_like and "edge" in split_edge["train"]:
        # Use training + validation edges (main.py:129-150).
        tr = split_edge["train"]["edge"]
        va = split_edge["valid"]["edge"]
        full_edge = np.concatenate([va, tr], axis=0)  # [valid, train]
        # The reference concatenates the WEIGHTS in the other order
        # ([train, valid], main.py:134-135): kept as it is for parity.
        full_weight = np.concatenate(
            [
                np.asarray(split_edge["train"].get("weight", np.ones(len(tr)))),
                np.asarray(split_edge["valid"].get("weight", np.ones(len(va)))),
            ]
        ).astype(np.float32)
        s, d, w = to_undirected_edges(full_edge[:, 0], full_edge[:, 1], full_weight, num_nodes)
        adj_src, adj_dst, adj_weight = s, d, w
        symmetrize = False
        if args.use_coalesce:
            fe_s, fe_d, fw = coalesce_edges(full_edge[:, 0], full_edge[:, 1], full_weight, num_nodes)
            full_edge = np.stack([fe_s, fe_d], axis=1)
            full_weight = fw
        # Degree-normalized train weights d_u^-1/2 · w · d_v^-1/2
        # (main.py:144-150); degrees from the merged adjacency.
        deg = np.zeros(num_nodes, np.float64)
        np.add.at(deg, d, w.astype(np.float64))
        with np.errstate(divide="ignore"):
            dinv = np.power(deg, -0.5)
        dinv[np.isinf(dinv)] = 0.0
        split_edge["train"]["edge"] = full_edge.astype(np.int64)
        split_edge["train"]["weight"] = (
            dinv[full_edge[:, 0]] * full_weight * dinv[full_edge[:, 1]]
        ).astype(np.float32)

    if symmetrize:
        adj_src, adj_dst, adj_weight = to_undirected_edges(adj_src, adj_dst, adj_weight, num_nodes)

    # Encoder-specific adjacency normalization (main.py:177-186).
    enc = args.encoder.upper()
    if enc == "GCN":
        adj_src, adj_dst, adj_weight = gcn_normalize_edges(adj_src, adj_dst, adj_weight, num_nodes)
    elif enc == "WSAGE":
        adj_src, adj_dst, adj_weight = row_normalize_edges(adj_src, adj_dst, adj_weight, num_nodes)
    elif enc == "TRANSFORMER":
        adj_weight = None  # strip values (main.py:184-186)

    return {
        "adj_src": np.asarray(adj_src, np.int64),
        "adj_dst": np.asarray(adj_dst, np.int64),
        "adj_weight": None if adj_weight is None else np.asarray(adj_weight, np.float32),
        "split_edge": split_edge,
    }


def get_train_edges(split_edge) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Training positives and optional weights (reference utils.py:8-13)."""
    tr = split_edge["train"]
    if "edge" in tr:
        pos = np.asarray(tr["edge"], np.int64)
    else:
        pos = np.stack(
            [np.asarray(tr["source_node"]), np.asarray(tr["target_node"])], axis=1
        ).astype(np.int64)
    w = tr.get("weight")
    return pos, (None if w is None else np.asarray(w, np.float32).reshape(-1))


def get_eval_edges(split_edge, split: str) -> Dict[str, np.ndarray]:
    """Valid/test pos+neg pairs in both OGB layouts (utils.py:33-40)."""
    se = split_edge[split]
    if "edge" in split_edge["train"]:
        return {
            "pos": np.asarray(se["edge"], np.int64),
            "neg": np.asarray(se["edge_neg"], np.int64),
        }
    source = np.asarray(se["source_node"])
    target = np.asarray(se["target_node"])
    target_neg = np.asarray(se["target_node_neg"])
    k = target_neg.shape[1]
    neg = np.stack([np.repeat(source, k), target_neg.reshape(-1)], axis=1).astype(np.int64)
    return {"pos": np.stack([source, target], axis=1).astype(np.int64), "neg": neg}


# ---------------------------------------------------------------------------
# Experiment assembly and run protocol (reference main.py:188-305)
# ---------------------------------------------------------------------------


_SPLIT_ID_KEYS = ("edge", "edge_neg", "source_node", "target_node", "target_node_neg")


def _relabel_split_edge(split_edge, node_relabel):
    """Map every node-id-bearing array of a split dict (both OGB layouts,
    utils.py:7-41) through ``node_relabel`` (old id -> slot id); weights
    and other payloads pass through untouched."""
    out = {}
    for split, d in split_edge.items():
        nd = dict(d)
        for k in list(nd):
            if k in _SPLIT_ID_KEYS and nd[k] is not None:
                nd[k] = node_relabel[np.asarray(nd[k])]
        out[split] = nd
    return out


def _world(args) -> int:
    return max(args.num_shards, 1) * max(args.mesh_data, 1)


def _device(args, device):
    if device is None and _world(args) > 1:
        # one card per rank: torchrun's local rank picks it
        device = f"cuda:{os.environ.get('LOCAL_RANK', args.device)}"
    return default_device(f"cuda:{args.device}" if device is None else device)


def _make_mesh(args, dev):
    """The (mesh_data, num_shards) mesh, or None on one device; more ranks
    need the process group torchrun sets up."""
    world = _world(args)
    if world == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            f"--num_shards {args.num_shards} --mesh_data {args.mesh_data} runs {world} "
            f"ranks, one card each: launch with torchrun --standalone "
            f"--nproc_per_node={world} -m plnlp_tpu_torch <flags>"
        )
    from plnlp_tpu_torch.parallel import make_mesh

    return make_mesh(data=max(args.mesh_data, 1), node=max(args.num_shards, 1), device=dev)


def prepare_experiment(args, log=print, serving=False, device=None):
    """Everything up to the run loop; returns a dict.

    ``serving=True`` (the --score_pairs path) skips the training-only work:
    the auto backend takes blocked CSR without estimating, no sampler twin
    and no eval pairs are built, and the id space is that of the trained
    run (the order its training saved in --checkpoint_dir), never a new
    estimate.
    """
    dev = _device(args, device)
    ds = load_dataset(args.data_name, args.data_path)
    num_nodes = ds["num_nodes"]
    node_feat = ds.get("node_feat")
    num_node_feats = 0 if node_feat is None else node_feat.shape[1]

    with span("prepare.surgery"):
        surg = apply_dataset_surgery(ds, args)
    split_edge = surg["split_edge"]
    use_dense = args.adj_backend == "dense" or (
        args.adj_backend == "auto" and num_nodes <= args.dense_threshold
    )
    mesh = _make_mesh(args, dev)
    partitioned = args.num_shards > 1
    if args.block_rows == 0 and (partitioned or not use_dense) and not serving:
        from plnlp_tpu_torch.tuning import autotune_block

        block = autotune_block(
            surg["adj_src"], surg["adj_dst"], surg["adj_weight"],
            num_nodes=num_nodes, dim=args.gnn_hidden_channels,
            block_edges=args.block_edges, dtype=args.compute_dtype, log=log, device=dev,
        )
        if mesh is not None:
            # the timings differ between ranks: every rank takes rank 0's choice
            block = list(block)
            dist.broadcast_object_list(block, src=0)
        args.block_rows, args.block_edges = block
        log(f"autotuned block = ({args.block_rows}, {args.block_edges})")
    elif args.block_rows == 0:
        args.block_rows = 512
    block = (args.block_rows, args.block_edges)

    # auto above the dense threshold: estimate the post-reorder tile
    # coverage (no tile build) and take hybrid when it clears the
    # threshold, blocked CSR otherwise; the estimate's order feeds the
    # relabel below, so the reorder sweep runs once.
    backend = args.adj_backend
    order = None  # slot id -> old id (hybrid id-space relabel)
    if backend == "auto" and not use_dense:
        if serving:
            # the Scorer encodes once per restore: the operand's speed does
            # not matter, so skip the estimator's reorder sweep
            backend = "csr"
            log("auto backend: serving mode -> csr (encode runs once; estimator skipped)")
        else:
            from plnlp_tpu_torch.ops.tile_spmm import estimate_hybrid

            est = estimate_hybrid(
                surg["adj_src"], surg["adj_dst"], num_nodes=num_nodes,
                tile=args.tile_size, min_fill=args.tile_min_fill, reorder=args.tile_reorder,
            )
            thr = args.tile_auto_coverage
            backend = "hybrid" if est["coverage"] >= thr else "csr"
            if backend == "hybrid":
                order = est["order"]
            log(
                f"auto backend: estimated tile coverage {est['coverage']:.1%} "
                f"({est['num_tiles']} tiles at T={args.tile_size}"
                f"/min_fill={args.tile_min_fill}, threshold {thr:.0%}) -> {backend}"
            )
    if serving:
        # The model's rows are in the trained run's id space.  The JAX CLI
        # re-derives the order instead, which differs from the trained
        # one when training chose hybrid through auto (serving auto takes
        # csr, no relabel; an explicit hybrid estimates over the
        # symmetrized edges).
        path = os.path.join(args.checkpoint_dir, ORDER_FILE) if args.checkpoint_dir else ""
        order = np.load(path) if path and os.path.exists(path) else None
    elif backend == "hybrid" and order is None and args.tile_reorder != "none":
        from plnlp_tpu_torch.ops.tile_spmm import estimate_hybrid

        order = estimate_hybrid(
            surg["adj_src"], surg["adj_dst"], num_nodes=num_nodes,
            tile=args.tile_size, min_fill=args.tile_min_fill, symmetrize=True,
            reorder=args.tile_reorder,
        )["order"]
    node_relabel = None  # old id -> slot id
    if order is not None:
        # The id-space relabel: node ids become slot ids once, on the
        # host, so the operand carries no permutation and no layer gathers
        # rows through one.  Edges, splits, features and the pretrained
        # table follow; the metrics do not depend on ids, and serving
        # translates user pairs (run_scoring).
        node_relabel = np.empty(num_nodes, np.int64)
        node_relabel[order] = np.arange(num_nodes)
        surg["adj_src"] = node_relabel[surg["adj_src"]]
        surg["adj_dst"] = node_relabel[surg["adj_dst"]]
        split_edge = _relabel_split_edge(split_edge, node_relabel)
        if node_feat is not None:
            node_feat = np.asarray(node_feat)[order]
        log(f"{backend} backend: id space relabeled to slot order "
            f"({'the trained run' if serving else args.tile_reorder}; no per-call feature perms)")

    adj = (surg["adj_src"], surg["adj_dst"], surg["adj_weight"])
    graph_t = None
    if partitioned:
        # the partitioned operand whatever --adj_backend says (as the JAX
        # CLI): destination rows and the embedding table over the 'node' ranks
        from plnlp_tpu_torch.parallel import make_graph_parallel

        # over hybrid the tiled partition: --tile_reorder sets the slot
        # order, and an id space already relabeled to community order
        # passes the identity order (no second sweep)
        tiled = backend == "hybrid"
        t0 = time.perf_counter()
        graph = make_graph_parallel(
            *adj, num_nodes=num_nodes, mesh=mesh, block=block,
            comm=args.partition_comm, latency_rows=args.comm_latency_rows,
            reorder=args.tile_reorder if tiled else args.partition_reorder,
            tile=args.tile_size if tiled else 0, min_fill=args.tile_min_fill,
            tile_dtype=args.compute_dtype,
            order=np.arange(num_nodes, dtype=np.int64) if tiled and order is not None else None,
            log=log,
        )
        pg = graph.pg
        log(
            f"partition: S={pg.num_shards} reorder={pg.reorder} comm={graph.comm} "
            f"rows_per_shard={pg.rows_per_shard} shard_edges={pg.shard_edges} "
            f"shard_nblk={pg.shard_nblk}"
            + (f" halo_quota={pg.halo_quota} halo_hubs={pg.halo_hubs}"
               if graph.comm == "halo" else "")
            + (f" tiles/shard={pg.shard_tiles} dense_edges={pg.tile_dense_edges} "
               f"store={pg.tile_store}" if pg.tile else "")
            + f" (built in {time.perf_counter() - t0:.2f} s)"
        )
    elif use_dense:
        graph = prepare_dense(*adj, num_nodes=num_nodes, device=dev)
    elif backend == "hybrid":
        from plnlp_tpu_torch.ops.tile_spmm import build_hybrid

        graph = build_hybrid(
            *adj, num_nodes=num_nodes, tile=args.tile_size, min_fill=args.tile_min_fill,
            block=block, dtype=args.compute_dtype, reorder=None, device=dev,
        )
        tile_mb = 2 * graph.num_tiles * graph.tile**2 * graph.tile_vals.element_size() >> 20
        log(
            f"hybrid backend: {graph.num_tiles} dense tiles "
            f"({graph.dense_edges}/{graph.dense_edges + graph.res_edges} edges, "
            f"{tile_mb} MB incl. transpose, store={graph.tile_vals.dtype}"
            + (", id space relabeled to slot order" if order is not None else "")
            + ")"
        )
    else:
        # the blocked TransformerConv's backward needs the forward <->
        # transpose slot pairing (ops/transformer.py)
        graph, graph_t = prepare_graph(
            *adj, num_nodes=num_nodes, block=block, device=dev,
            couple_transpose=args.encoder.upper() == "TRANSFORMER",
        )
    if (partitioned or use_dense or backend == "hybrid") and not serving:
        # the CSR twin for the negative sampler's exclusion and the walks
        sample_graph, _ = prepare_graph(*adj, num_nodes=num_nodes, block=None, device=dev)
    else:
        sample_graph = graph

    pretrain_emb = None
    if args.pretrain_emb:
        if args.pretrain_emb.endswith(".npy"):
            pretrain_emb = np.load(args.pretrain_emb)
        else:
            pretrain_emb = torch.load(
                args.pretrain_emb, map_location="cpu", weights_only=True
            ).numpy()
        if order is not None:
            # rows follow the relabel: new_emb[slot] = old[order[slot]]
            pretrain_emb = np.asarray(pretrain_emb)[order]

    cfg = ModelConfig(
        encoder=args.encoder,
        predictor=args.predictor,
        optimizer=args.optimizer,
        loss_func=args.loss_func,
        neg_sampler=args.neg_sampler,
        gnn_num_layers=args.gnn_num_layers,
        mlp_num_layers=args.mlp_num_layers,
        emb_hidden_channels=args.emb_hidden_channels,
        gnn_hidden_channels=args.gnn_hidden_channels,
        mlp_hidden_channels=args.mlp_hidden_channels,
        dropout=args.dropout,
        grad_clip_norm=args.grad_clip_norm,
        lr=args.lr,
        num_neg=args.num_neg,
        batch_size=args.batch_size,
        use_node_feats=args.use_node_feats,
        train_node_emb=args.train_node_emb,
        compute_dtype=args.compute_dtype,
        remat=args.remat,
    )
    model = Model(
        cfg, num_nodes, num_node_feats, pretrain_emb,
        seed=_seeds(args.seed, 0, 0)[0], device=dev,
    )
    if partitioned:
        from plnlp_tpu_torch.parallel import shard_params

        shard_params(model, graph)  # this rank's rows of the table

    eval_edges = None
    if not serving:
        eval_edges = {
            split: {
                k: torch.as_tensor(v, device=dev)
                for k, v in get_eval_edges(split_edge, split).items()
            }
            for split in ("valid", "test")
        }
    return {
        "dataset": ds,
        "split_edge": split_edge,
        "graph": graph,
        "graph_t": graph_t,
        "sample_graph": sample_graph,
        "model": model,
        "eval_edges": eval_edges,
        "node_feats": None if node_feat is None else torch.as_tensor(
            np.asarray(node_feat, np.float32), device=dev
        ),
        "num_nodes": num_nodes,
        "device": dev,
        # old id -> slot id, or None; serving translates user ids through it
        "node_relabel": node_relabel,
        "order": order,
        "mesh": mesh,
    }


def _seeds(seed: int, run: int, epoch: int) -> Tuple[int, int]:
    """Two seeds drawn from (seed, run, epoch): epoch 0 is the parameter
    init of the run, train epochs start at 1; the second seed is the walk
    augmentation's."""
    ss = np.random.SeedSequence([v % 2**32 for v in (seed, run, epoch)])
    a, b = ss.generate_state(2)
    return int(a), int(b)


def _carry_optimizer(model: Model, old: Optional[torch.optim.Optimizer]):
    """A new optimizer over the model's (new) parameters that takes over
    ``old``'s state, moments included, parameter by parameter in order."""
    opt = model.make_optimizer()
    if old is not None:
        opt.load_state_dict(old.state_dict())
    return opt


def _save_order(checkpoint_dir: str, order) -> None:
    """Keep the run's id-space relabel beside its checkpoints (remove a
    stale one when this run has none)."""
    path = os.path.join(checkpoint_dir, ORDER_FILE)
    if order is None:
        if os.path.exists(path):
            os.remove(path)
        return
    os.makedirs(checkpoint_dir, exist_ok=True)
    tmp = f"{path}.tmp.npy"
    np.save(tmp, np.asarray(order, np.int64))
    os.replace(tmp, path)


def run_experiment(args, log=print, device=None):
    """The full experiment (reference main.py:69-305); returns the Loggers.
    SIGTERM during the run (a preemption notice) checkpoints at the end of
    the epoch and raises ``Preempted`` (exit code 75), so a relaunch with
    --resume continues; see ``resilience.PreemptionGuard``."""
    from plnlp_tpu_torch.resilience import PreemptionGuard

    if _rank() != 0:
        log = _quiet  # only rank 0 logs
    with PreemptionGuard() as guard:
        return _run_experiment(args, log, guard, device)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _quiet(*_args, **_kw) -> None:
    pass


def _run_experiment(args, log, guard, device):
    from plnlp_tpu_torch import profiling
    from plnlp_tpu_torch.profiling import (
        MetricsWriter,
        ThroughputMeter,
        profile_trace,
        summarize_trace,
    )
    from plnlp_tpu_torch.resilience import Preempted

    from plnlp_tpu_torch.parallel.sharded import full_state, load_full_state

    # --profile_dir records the set-up's spans too (one log line below)
    traced = bool(args.profile_dir) and _rank() == 0
    with profiling.tracing(traced):
        exp = prepare_experiment(args, log=log, device=device)
    setup_spans = profiling.drain() if traced else []
    model: Model = exp["model"]
    dev = exp["device"]
    mesh = exp["mesh"]
    rank0 = _rank() == 0
    graph, graph_t = exp["graph"], exp["graph_t"]
    sample_graph = exp["sample_graph"]
    node_feats = exp["node_feats"]
    eval_metric = args.eval_metric or exp["dataset"].get("eval_metric", "hits")
    ds_metric = exp["dataset"].get("eval_metric")
    if ds_metric and eval_metric != ds_metric:
        # --eval_metric defaults to 'hits' (reference flag parity,
        # main.py:24), so an mrr-layout dataset evaluates as hits unless
        # the flag is passed: say so
        import warnings

        warnings.warn(
            f"dataset stores eval_metric={ds_metric!r} but this run uses "
            f"{eval_metric!r}; pass --eval_metric {ds_metric} if that is "
            f"unintended (the flag default is 'hits' for reference parity)",
            stacklevel=2,
        )

    log_file = None
    if args.res_dir and rank0:
        os.makedirs(args.res_dir, exist_ok=True)
        log_file = os.path.join(args.res_dir, f"log_{args.data_name}_{int(time.time())}.txt")
        with open(log_file, "a") as f:
            f.write(str(vars(args)) + "\n")

    def emit(msg):
        log(msg)
        if log_file:
            with open(log_file, "a") as f:
                f.write(str(msg) + "\n")

    if setup_spans:
        emit("[profile] set-up " + ", ".join(
            f"{sp.name} {(sp.t1_ns - sp.t0_ns) / 1e9:.3f} s"
            for sp in sorted(setup_spans, key=lambda sp: sp.t0_ns)
        ))

    if eval_metric == "hits":
        loggers = {k: Logger(args.runs, args) for k in ("Hits@20", "Hits@50", "Hits@100")}
    else:
        loggers = {"MRR": Logger(args.runs, args)}

    pos_np, weights_np = get_train_edges(exp["split_edge"])
    base_pos = torch.as_tensor(pos_np, device=dev)
    base_weights = None if weights_np is None else torch.as_tensor(weights_np, device=dev)

    # walk start nodes, fixed before the run loop (main.py:228-233)
    rw_start = None
    if args.random_walk_augment:
        if args.walk_start_type == "edge":
            rw_start = base_pos.reshape(-1)
        else:
            rw_start = torch.arange(exp["num_nodes"], device=dev)

    # The reference creates the optimizer once and carries its state
    # across runs (model.py:85-96); --reset_optimizer starts each run clean.
    opt = model.make_optimizer()
    emit(f"Total number of model parameters is {model.param_count()}")

    meter = ThroughputMeter(sample_graph.num_edges, args.gnn_num_layers, args.batch_size)
    metrics = MetricsWriter((args.metrics_file or None) if rank0 else None)

    ckpt_mgr = None
    start_run, start_epoch = 0, 1

    def save_ckpt(run, epoch):
        # the whole table in original node order (a collective over the node
        # group when it is sharded); rank 0 writes
        model_state, opt_state = full_state(model, opt)
        if not rank0:
            return
        ckpt_mgr.save(
            run * args.epochs + epoch,
            model_state,
            opt_state,
            {
                "run": run,
                "epoch": epoch,
                "results": {k: [list(map(list, r)) for r in lg.results] for k, lg in loggers.items()},
            },
        )

    if args.checkpoint_dir:
        from plnlp_tpu_torch.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(args.checkpoint_dir)
        if rank0:
            _save_order(args.checkpoint_dir, exp["order"])
        if args.resume and ckpt_mgr.latest_step() is not None:
            # read to the host: load_state_dict copies onto the parameters'
            # device, and the optimizer keeps its step counts on the host
            # as a fresh one does; a sharded table takes this rank's rows
            model_state, opt_state, extra = ckpt_mgr.restore(device="cpu")
            load_full_state(model, opt, model_state, opt_state)
            if extra:
                start_run = int(extra.get("run", 0))
                start_epoch = int(extra.get("epoch", 0)) + 1
                for lk, res in extra.get("results", {}).items():
                    if lk in loggers:
                        loggers[lk].results = [list(map(tuple, r)) for r in res]
                emit(f"Resumed from run {start_run + 1}, epoch {start_epoch}")

    for run in range(start_run, args.runs):
        if run != start_run:
            # run 0 starts from the model's own init, drawn from the same
            # seed; a resumed run continues from the restored parameters
            model.init_params(_seeds(args.seed, run, 0)[0])
            opt = _carry_optimizer(model, None if args.reset_optimizer else opt)
        first_epoch = start_epoch if run == start_run else 1
        cur_lr = (
            adjust_lr(args.lr, (first_epoch - 1) / args.epochs)
            if args.use_lr_decay and first_epoch > 1
            else args.lr
        )
        start_time = time.time()
        for epoch in range(first_epoch, 1 + args.epochs):
            train_seed, walk_seed = _seeds(args.seed, run, epoch)
            gen = torch.Generator(device=dev).manual_seed(train_seed)
            if args.random_walk_augment:
                walk_gen = torch.Generator(device=dev).manual_seed(walk_seed)
                pos, weights, pos_mask = random_walk_pairs(
                    sample_graph, rw_start, args.walk_length, walk_gen
                )
            else:
                pos, weights, pos_mask = base_pos, base_weights, None
            profiled = bool(args.profile_dir) and run == 0 and epoch == 2 and rank0
            meter.start()
            with profile_trace(args.profile_dir if profiled else None):
                loss = model.train_epoch(
                    opt, graph, graph_t, node_feats, pos, weights, gen, cur_lr,
                    sample_graph=sample_graph, pos_mask=pos_mask, mesh=mesh,
                )
            epoch_s = meter.stop(pos.shape[0])
            if profiled:
                # the captured epoch's top device ops and its spans by self
                # time (recorded while the profiler ran), into the text log
                for row in summarize_trace(args.profile_dir, top=10):
                    emit(f"[profile] {row['total_ms']:9.3f} ms x{row['count']:<4d} "
                         f"{row['name'][:120]}")
                recorded = profiling.drain()
                profiling.write_spans(
                    os.path.join(args.profile_dir,
                                 f"plnlp_{os.getpid()}_{time.time_ns()}.spans.json"),
                    recorded,
                )
                for row in profiling.span_table(recorded, top=10):
                    emit(f"[profile] span {row['self_ms']:9.3f} ms self "
                         f"{row['total_ms']:9.3f} ms x{row['count']:<4d} {row['name']}")
            metrics.write(
                run=run,
                epoch=epoch,
                loss=loss,
                lr=cur_lr,
                epoch_seconds=epoch_s,
                agg_edges_per_sec=meter.last_edges_per_sec,
                useful_agg_edges_per_sec=meter.last_useful_edges_per_sec,
                pairs_per_sec=meter.last_pairs_per_sec,
            )
            if epoch % args.eval_steps == 0:
                results = model.test(graph, graph_t, node_feats, exp["eval_edges"], eval_metric,
                                     mesh=mesh)
                for k, res in results.items():
                    loggers[k].add_result(run, res)
                if epoch % args.log_steps == 0:
                    spent = time.time() - start_time
                    for k, (vres, tres) in results.items():
                        emit(k)
                        emit(
                            f"Run: {run + 1:02d}, Epoch: {epoch:02d}, "
                            f"Loss: {loss:.4f}, Learning Rate: {cur_lr:.4f}, "
                            f"Valid: {100 * vres:.2f}%, Test: {100 * tres:.2f}%"
                        )
                    emit("---")
                    emit(
                        f"Training Time Per Epoch: {spent / args.eval_steps: .4f} s "
                        f"({meter.last_edges_per_sec / 1e6:.1f}M agg-edges/s)"
                    )
                    emit("---")
                    start_time = time.time()
            if args.use_lr_decay:
                cur_lr = adjust_lr(args.lr, epoch / args.epochs)
            if ckpt_mgr is not None and epoch % args.checkpoint_every == 0:
                save_ckpt(run, epoch)
            if guard is not None and guard.preempted:
                # a preemption notice arrived during the epoch: persist now
                # (unless the periodic save just did) and exit cleanly
                if ckpt_mgr is not None:
                    if epoch % args.checkpoint_every != 0:
                        save_ckpt(run, epoch)
                    emit(
                        f"Preemption signal ({guard.signum}) — checkpointed "
                        f"run {run + 1} epoch {epoch}; relaunch with --resume to continue"
                    )
                else:
                    emit(
                        f"Preemption signal ({guard.signum}) at run {run + 1} epoch "
                        f"{epoch} — no --checkpoint_dir, progress is lost"
                    )
                raise Preempted(run, epoch)
        for k in loggers:
            if not rank0:
                break
            emit(k)
            loggers[k].print_statistics(run, last_best=args.eval_last_best)
            if log_file:
                with open(log_file, "a") as f:
                    loggers[k].print_statistics(run, f=f, last_best=args.eval_last_best)

    for k in loggers:
        if not rank0:
            break
        emit(k)
        loggers[k].print_statistics(last_best=args.eval_last_best)
        if log_file:
            with open(log_file, "a") as f:
                loggers[k].print_statistics(f=f, last_best=args.eval_last_best)
    return loggers


def run_scoring(args, log=print, device=None):
    """Serving mode (--score_pairs): restore the checkpoint, encode once,
    score the given pairs (original ids), write the scores; returns them."""
    if not args.checkpoint_dir:
        raise SystemExit("--score_pairs needs --checkpoint_dir")
    from plnlp_tpu_torch.serve import Scorer

    if _rank() != 0:
        log = _quiet
    exp = prepare_experiment(args, log=log, serving=True, device=device)
    sc = Scorer.from_checkpoint(
        exp["model"], args.checkpoint_dir, exp["graph"], exp["graph_t"], exp["node_feats"],
        mesh=exp["mesh"],
    )
    pairs = np.load(args.score_pairs)
    if exp["node_relabel"] is not None:
        # the model's rows are in slot order; user pairs arrive in original
        # ids.  Scores come back in input order, so nothing maps back.
        pairs = exp["node_relabel"][np.asarray(pairs)]
    scores = sc.score(pairs)
    if _rank() == 0:
        np.save(args.score_out, scores)
    log(f"scored {len(pairs)} pairs -> {args.score_out}")
    return scores


def main(argv=None):
    args = argument(argv)
    if _world(args) > 1 and "RANK" in os.environ:
        from plnlp_tpu_torch.parallel import multihost

        multihost.init()  # NCCL on cuda:<LOCAL_RANK>
    if _rank() == 0:
        print(args)
    if args.score_pairs:
        return run_scoring(args)
    if args.max_restarts > 0:
        from plnlp_tpu_torch.resilience import run_resilient

        return run_resilient(args, max_restarts=args.max_restarts)
    return run_experiment(args)


if __name__ == "__main__":
    main()
