#!/usr/bin/env python3
"""Time K1 (``plnlp_tpu_torch/csrc/scatter_matmul.cu``) on one NVIDIA GPU:
the bf16 entry at each compile-time knob, and an A/B of another commit's
``scatter_matmul.cu`` in one process.

    python3 chip_sweep_k1.py [--seed 0] [--variants a,b]
                             [--baseline OTHER/scatter_matmul.cu[,MORE.cu]]

Shapes, as ``chip_smoke.py`` makes them: the collab graph and its
transpose (phases 3 and 20: N = 235,868, D = 256), the SBM operand's
residual with x at the padded-carry n_pad rows (phase 20), shard 0's
residual of phase 31c's 4-shard tiled partition of the SBM (x at the
gathered 4 x rows_per_shard rows), shard 0's remote pass of phase 31b's
halo body over the collab graph (x the exchanged halo and hub rows; only
the rows that a halo source reaches are written), and the collab graph's
hub row-block 0 alone and every other row-block alone (phase 3's row
pointers that empty the rest: most of the output is rows no slot reaches).

Each variant is the source with some constexpr knobs of the bf16 path
replaced (live slots in flight, blocks an SM), built with the port's nvcc flags into
``build/sweep_k1/``, one nvcc each, all started together, and loaded with
ctypes.  Every variant must give the source's bits.  ``--baseline`` adds
other ``scatter_matmul.cu`` files (earlier commits', whose bf16 entry may
want a zeroed output), named baseline, baseline2, ..., run in the order
baseline, baseline2, source, source, baseline2, baseline: their bf16 and
f32 entries must give the source's bits.  The
source's bf16 output is checked in a buffer filled with NaN (the kernel
must write every row).  Each entry is timed as its wrapper calls it,
allocations included (``out`` from ``torch.zeros``, or ``torch.empty``
where the kernel writes every row; the carries from ``torch.empty``), and
the source's bf16 entry also with ``out`` from ``torch.zeros``, to show
what the memset costs.  Prints each build's registers and spills, then
each variant's time on each shape (CUDA events; median of 5 runs of 20
calls), the f32 entry's beside the source's and the baseline's, and the
card's name and power limit.  Imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

# (name, {knob: value}) over the constexpr knobs of scatter_matmul.cu's
# bf16 path: live slots in flight, blocks an SM; the source as it stands
# comes first and again last
VARIANTS = [
    ("source", {}),
    ("unroll6", {"kUnrollBf": 6}),
    ("unroll8-blocks5", {"kUnrollBf": 8, "kMinBlocksBf": 5}),
    ("blocks5", {"kMinBlocksBf": 5}),
    ("blocks4", {"kMinBlocksBf": 4}),
]
SHAPES = ("graph", "graph_t", "SBM residual", "shard residual", "halo remote", "hub alone",
          "rest alone")


def build_report(report: str) -> str:
    """Registers and spills of each kernel of the 16-byte path, with its
    mangled template arguments (Lb1: the 16-byte path; an earlier commit's
    kernels may name their element type too, f for float32)."""
    out, kern = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d(scatter_\w+?kernel)I(\w+?)EE", line)
            kern = f"{m.group(1)}<{m.group(2)}>" if m and m.group(2).endswith("Lb1") else None
        elif kern and "registers" in line:
            out.append(f"{kern} {re.search(r'Used (\d+) registers', line).group(1)} registers")
        elif kern and "spill stores" in line:
            sp = re.findall(r"(\d+) bytes spill", line)
            if sp != ["0", "0"]:
                out.append(f"{kern} spill {sp[0]}/{sp[1]} B")
    return ", ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default="", help="comma-separated names (default: all)")
    ap.add_argument("--baseline", default="",
                    help="other scatter_matmul.cu files to A/B against, comma-separated")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_sweep_k1: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import chip_smoke
    from chip_sweep_flash import build_sources, variant_source
    from plnlp_tpu_torch import _build, prepare_graph
    from plnlp_tpu_torch.data import make_synthetic_dataset
    from plnlp_tpu_torch.ops import scatter_matmul as sm
    from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel
    from plnlp_tpu_torch.parallel.mesh import Mesh
    from plnlp_tpu_torch.parallel.partition import partition_graph, with_halo

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    variants = [v for v in VARIANTS if v[0] == "source"
                or not args.variants or v[0] in args.variants.split(",")]
    src = (_build.CSRC / "scatter_matmul.cu").read_text()
    texts = {name: variant_source(src, knobs, {}, "scatter_matmul.cu")
             for name, knobs in variants}
    baselines = [f"baseline{i + 1 if i else ''}" for i, _ in
                 enumerate(args.baseline.split(",") if args.baseline else [])]
    for name, path in zip(baselines, args.baseline.split(",")):
        texts[name] = open(path).read()
    libs = build_sources(_build.BUILD_DIR.parent / "sweep_k1", "scatter_matmul", texts)
    for name, (_, report) in libs.items():
        print(f"[build] {name}: {build_report(report)}", flush=True)

    # the shapes
    ds = make_synthetic_dataset("hits", num_nodes=chip_smoke.N_NODES,
                                num_edges=chip_smoke.N_EDGES, seed=args.seed)
    graph, graph_t = prepare_graph(*ds["edge_index"], None, num_nodes=chip_smoke.N_NODES,
                                   symmetrize=True, block=chip_smoke.BLOCK, device=dev)
    data = chip_smoke.hybrid_data(chip_smoke.N_NODES, chip_smoke.N_EDGES,
                                  chip_smoke.N_COMMUNITIES, args.seed, dev)
    hg = data["hg"]
    n_pad = (hg.tile_rowptr.shape[0] - 1) * chip_smoke.TILE
    relabel = np.empty(hg.num_nodes, np.int64)
    relabel[data["est"]["order"]] = np.arange(hg.num_nodes)
    pg = partition_graph(*(relabel[e] for e in data["edges"]), None, num_nodes=hg.num_nodes,
                         num_shards=4, block=chip_smoke.BLOCK, reorder="labelprop",
                         tile=chip_smoke.TILE, min_fill=chip_smoke.MIN_FILL,
                         order=np.arange(hg.num_nodes, dtype=np.int64))
    sh = GraphParallel.place(pg, Mesh(1, 4, rank=0, device=dev))
    # phase 31b's halo partition of the collab graph: shard 0's remote pass
    # reads the rows the other shards send it (q each) and every shard's hubs
    hp = with_halo(partition_graph(*ds["edge_index"], None, num_nodes=chip_smoke.N_NODES,
                                   num_shards=4, block=chip_smoke.BLOCK, symmetrize=True,
                                   reorder="bfs"))
    hs = [GraphParallel.place(hp, Mesh(1, 4, rank=s, device=dev), "halo") for s in range(4)]
    rem = hs[0].fwd_halo["rem"]
    rem_rows = sum(h.fwd_halo["send_idx"].numel() // 4 + h.fwd_halo["hub_idx"].numel()
                   for h in hs)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    width = chip_smoke.WIDTH
    n = graph.num_nodes

    def blocks(g):
        return g.blk_src, g.blk_local, g.blk_weight, g.blk_rowptr, g.block_rows

    b = sh.fwd
    hub_ptr = graph.blk_rowptr.clone()
    hub_ptr[2:] = hub_ptr[1]
    rest_ptr = graph.blk_rowptr.clone()
    rest_ptr[0] = rest_ptr[1]
    shapes = {  # name: (x rows, (blk_src, blk_local, blk_weight, blk_rowptr, R), out rows)
        "graph": (n, blocks(graph), n),
        "graph_t": (n, blocks(graph_t), n),
        "SBM residual": (n_pad, blocks(hg.res_graph), hg.num_nodes),
        "shard residual": (4 * pg.rows_per_shard, (b["blk_src"], b["blk_local"],
                                                  b["blk_weight"], b["blk_rowptr"],
                                                  pg.block_rows), pg.rows_per_shard),
        "halo remote": (rem_rows, (rem["blk_src"], rem["blk_local"], rem["blk_weight"],
                                   rem["blk_rowptr"], hp.block_rows), hp.rows_per_shard),
        "hub alone": (n, (*blocks(graph)[:3], hub_ptr, graph.block_rows), n),
        "rest alone": (n, (*blocks(graph)[:3], rest_ptr, graph.block_rows), n),
    }
    xs = {}
    for name, (rows, _, _) in shapes.items():
        xs[name] = torch.randn(rows, width, device=dev, generator=gen)
    run_slots = 128

    def caller(name, shape, dtype, fill=False, zeroed=False):
        """The entry of variant ``name`` on ``shape`` as its wrapper calls it
        (``out`` zero-filled unless the kernel writes every row); returns a
        function giving the output."""
        lib = libs[name][0]
        x = xs[shape].to(dtype)
        _, (src_, loc, wgt, ptr, r), rows = shapes[shape]
        nblk, be = src_.shape
        n_runs = -(-nblk * be // run_slots)
        # this design's bf16 entry writes every row, and keeps a bitmap of
        # the rows it reached after the run rows
        writes_all = dtype == torch.bfloat16 and "scatter_carries_bf16_kernel" in texts[name]
        words = -(-rows // 32) if writes_all else 0
        fn = getattr(lib, sm._ENTRY[dtype])
        fn.argtypes = sm._ARGTYPES
        fn.restype = ctypes.c_int
        alloc = torch.empty if writes_all and not zeroed else torch.zeros
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            out = alloc((rows, width), dtype=dtype, device=dev)
            if fill and writes_all:  # the kernel must write every row
                out.fill_(float("nan"))
            carry = torch.empty((2 * n_runs, width), dtype=torch.float32, device=dev)
            run_rows = torch.empty(2 * n_runs + words, dtype=torch.int32, device=dev)
            err = fn(x.data_ptr(), src_.data_ptr(), loc.data_ptr(), wgt.data_ptr(),
                     ptr.data_ptr(), out.data_ptr(), carry.data_ptr(), run_rows.data_ptr(),
                     ptr.shape[0] - 1, rows, r, nblk, be, width, 1, stream)
            _build.check(lib, err, f"scatter_matmul sweep launch ({name}, {shape})")
            return out
        return call

    want = {(shape, dt): caller("source", shape, dt, fill=True)().clone()
            for shape in SHAPES for dt in (torch.bfloat16, torch.float32)}
    torch.cuda.synchronize()
    for shape in SHAPES:
        require_nan_free = not want[(shape, torch.bfloat16)].isnan().any()
        chip_smoke.require(require_nan_free, f"the bf16 kernel left rows unwritten on {shape}")
    order = [*baselines, *(name for name, *_ in variants), "source", *baselines[::-1]]
    for name in order:
        parts = []
        dtypes = (torch.bfloat16, torch.float32) if name == "source" or name in baselines else (
            torch.bfloat16,)
        for shape in SHAPES:
            for dt in dtypes:
                got = caller(name, shape, dt, fill=True)()
                torch.cuda.synchronize()
                chip_smoke.require(torch.equal(got, want[(shape, dt)]),
                                   f"variant {name}: the {dt} entry differs from the source's "
                                   f"bits on {shape}")
                ms = chip_smoke.cuda_ms(caller(name, shape, dt), reps=20, runs=5)
                bf16 = dt == torch.bfloat16
                parts.append(f"{shape} {'bf16' if bf16 else 'f32'} {ms:.4f} ms")
                if name == "source" and bf16:
                    # the same kernel with out from torch.zeros, as before the
                    # kernel wrote every row: what the memset costs
                    z = chip_smoke.cuda_ms(caller(name, shape, dt, zeroed=True), reps=20, runs=5)
                    parts[-1] += f" [{z:.4f} ms with out zero-filled]"
        print(f"[sweep] {name}: " + ", ".join(parts) + f" (same bits as the source); card {card}",
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
