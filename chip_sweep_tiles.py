#!/usr/bin/env python3
"""Time variants of the tile kernel K2 (``plnlp_tpu_torch/csrc/tile_matmul.cu``)
on one NVIDIA GPU, and an A/B of another commit's ``tile_matmul.cu`` in one
process.

    python3 chip_sweep_tiles.py [--seed 0] [--variants a,b]
                                [--store int8,bfloat16] [--shapes a,b]
                                [--baseline OTHER/tile_matmul.cu]
                                [--source OTHER/tile_matmul.cu]

Shapes, as ``chip_smoke.py`` makes them: the SBM operand's tiles and their
transpose (phases 11 and 21: 2,658 tiles, T = 256, x at the padded-carry
n_pad rows, D = 256), and shard 0's tiles of phase 31c's 4-shard tiled
partition (x the gathered buffer of 4 x rows_per_shard rows, the output
the shard's own rows), each on the int8 tile store and on the same tiles
stored in bf16 (``--store``).

Each variant is the source with some constexpr knobs of the bf16 kernel
replaced (x rows in flight, items loaded ahead, rows a warp, blocks an SM)
or a function replaced by another design, built with the port's nvcc
flags into ``build/sweep_tiles/``, one nvcc each, all started together,
and loaded with ctypes.  A variant must give the source's bits in bf16,
except the ``"time"`` variants, which compute a part of the bf16 kernel to
split its time and are only timed: the scan of the tile rows and the list
alone, and the scan and the list walked with no gather (``bf-*`` split the
bf16 kernel's drain; ``scan-only`` and ``no-gather`` split ``drain``, the
f32 kernel's, which the bf16 entry ran before it had its own: give them an
earlier commit's file with ``--source``).
``--baseline`` adds another ``tile_matmul.cu`` (an earlier commit's) as
the variant ``baseline``, run first and again last around the source, in
the order baseline, source, variants, source, baseline: its bf16 and f32
entries must give the source's bits, so the pair is an A/B of two commits
in one run.  ``--source`` takes the variants from another ``tile_matmul.cu``
(an earlier commit's, to split its time) in place of the repository's.
Prints each build's registers and spills, then each variant's bf16 time on
each shape and store (the source's and the baseline's f32 time beside it;
CUDA events, median of 5 runs of 10 calls), and the card's name and power
limit.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys

# The parts of drain (K2's f32 entry, and its bf16 entry before the bf16
# kernel; time an earlier commit's with --source): the scan and the list
# alone (each drain reads its last entry, so the lists are built); the
# scan and the list walked in order with no gather (each entry's weight
# times its row number in place of its x row)
SCAN_ONLY = """template <bool VEC, typename T>
__device__ __forceinline__ void drain(const int* lst_row, const float* lst_val, int n,
                                      const T* __restrict__ x, int c0, int lane, int d,
                                      float (&acc)[8]) {
  __syncwarp();
  if (n) acc[0] += lst_val[n - 1] + (float)lst_row[n - 1];
  __syncwarp();
}
"""
NO_GATHER = """template <bool VEC, typename T>
__device__ __forceinline__ void drain(const int* lst_row, const float* lst_val, int n,
                                      const T* __restrict__ x, int c0, int lane, int d,
                                      float (&acc)[8]) {
  __syncwarp();
  for (int b = 0; b < n; b += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b + u >= n) break;  // warp-uniform
      const float w = lst_val[b + u], r = (float)lst_row[b + u];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(w, r, acc[c]);
    }
  }
  __syncwarp();
}
"""

# The parts of the bf16 kernel's drain (drain_bf16): the scan and the list
# alone; the scan and the list walked in order with no gather
BF_SIG = """\
__device__ __forceinline__ void drain_bf16(const int* lst_row, const float* lst_val, int n,
                                           const bf16* __restrict__ x, int col, bool on,
                                           int d, float (&acc)[8]) {
"""
BF_SCAN_ONLY = BF_SIG + """  __syncwarp();
  if (n) acc[0] += lst_val[n - 1] + (float)lst_row[n - 1];
  __syncwarp();
}
"""
BF_NO_GATHER = BF_SIG + """  __syncwarp();
  for (int e = 0; e < n; ++e) {
    const float w = lst_val[e], r = (float)lst_row[e];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = fmaf(w, r, acc[c]);
  }
  __syncwarp();
}
"""

# (name, {knob: value}, {function name: replacement}, check): check is
# "bits" (the source's bits) or "time" (a part of the bf16 kernel, timed
# alone); the source as it stands comes first and again last
VARIANTS = [
    ("source", {}, {}, "bits"),
    ("bf-scan-only", {}, {"drain_bf16": BF_SCAN_ONLY}, "time"),
    ("bf-no-gather", {}, {"drain_bf16": BF_NO_GATHER}, "time"),
    ("depth3", {"kDepthBf": 3}, {}, "bits"),
    ("depth5", {"kDepthBf": 5}, {}, "bits"),
    ("depth6", {"kDepthBf": 6}, {}, "bits"),
    ("group2", {"kGroupBf": 2}, {}, "bits"),
    ("rows2", {"kRowsBf": 2}, {}, "bits"),
    ("rows8", {"kRowsBf": 8}, {}, "bits"),
    ("blocks3-depth6", {"kMinBlocksBf": 3, "kDepthBf": 6}, {}, "bits"),
    ("scan-only", {}, {"drain": SCAN_ONLY}, "time"),
    ("no-gather", {}, {"drain": NO_GATHER}, "time"),
]
SHAPES = ("SBM", "SBM transposed", "shard")


def build_report(report: str) -> str:
    """Registers and shared memory of each kernel of the 16-byte path on
    int8 tiles (bf16 and f32 x), and the spills of every kernel."""
    out, kern, main_path = [], None, False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d(tile_\w+?kernel)I(\w+?)EE", line)
            kern = f"{m.group(1)}<{m.group(2)}>" if m else None
            main_path = bool(m) and m.group(2).startswith("a") and (
                "Lb1" in m.group(2) or "bf16" in m.group(1))
        elif kern and main_path and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{kern} {re.search(r'Used (\d+) registers', line).group(1)} registers"
                       + (f" {smem.group(1)} B smem" if smem else ""))
        elif kern and "spill stores" in line:
            sp = re.findall(r"(\d+) bytes spill", line)
            if sp != ["0", "0"]:
                out.append(f"{kern} spill {sp[0]}/{sp[1]} B")
    return ", ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default="", help="comma-separated names (default: all)")
    ap.add_argument("--baseline", default="", help="another tile_matmul.cu to A/B against")
    ap.add_argument("--source", default="", help="another tile_matmul.cu to take variants of")
    ap.add_argument("--store", default="int8,bfloat16",
                    help="comma-separated tile stores: int8 (the SBM's), bfloat16 (the same "
                         "tiles in bf16)")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated: " + ", ".join(SHAPES))
    args = ap.parse_args()
    stores = args.store.split(",")
    shape_names = args.shapes.split(",")
    if not set(stores) <= {"int8", "bfloat16"} or not set(shape_names) <= set(SHAPES):
        ap.error("--store or --shapes names an unknown value")

    import torch

    if not torch.cuda.is_available():
        print("chip_sweep_tiles: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import chip_smoke
    from chip_sweep_flash import build_sources, card_name, shard_tiles, variant_source
    from plnlp_tpu_torch import _build
    from plnlp_tpu_torch.ops import tile_matmul as tm

    dev = torch.device("cuda")
    card = card_name()
    variants = [v for v in VARIANTS if v[0] == "source"
                or not args.variants or v[0] in args.variants.split(",")]
    src = open(args.source).read() if args.source else (_build.CSRC / "tile_matmul.cu").read_text()
    texts = {name: variant_source(src, knobs, functions, "tile_matmul.cu")
             for name, knobs, functions, _ in variants}
    if args.baseline:
        texts["baseline"] = open(args.baseline).read()
    libs = build_sources(_build.BUILD_DIR.parent / "sweep_tiles", "tile_matmul", texts)
    for name, (_, report) in libs.items():
        print(f"[build] {name}: {build_report(report)}", flush=True)

    data = chip_smoke.hybrid_data(chip_smoke.N_NODES, chip_smoke.N_EDGES,
                                  chip_smoke.N_COMMUNITIES, args.seed, dev)
    hg = data["hg"]
    width = chip_smoke.WIDTH
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # each shape: (tile set as vals, tile_col, tile_rowptr; x rows; out rows)
    shapes = {}
    n_pad = (hg.tile_rowptr.shape[0] - 1) * chip_smoke.TILE
    if "SBM" in shape_names:
        shapes["SBM"] = ((hg.tile_vals, hg.tile_col, hg.tile_rowptr), n_pad, n_pad)
    if "SBM transposed" in shape_names:
        shapes["SBM transposed"] = ((hg.tile_vals_t, hg.tile_col_t, hg.tile_rowptr_t), n_pad,
                                    n_pad)
    if "shard" in shape_names:
        rps, tiles, _ = shard_tiles(data, dev)
        shapes["shard"] = ((tiles["vals"], tiles["col"], tiles["rowptr"]), 4 * rps, rps)
    xs = {sname: torch.randn(rows, width, device=dev, generator=gen)
          for sname, (_, rows, _) in shapes.items()}

    def caller(name, sname, store, dtype):
        """The entry of variant ``name`` as the wrapper calls it (``out``
        from torch.empty: the kernel writes every row)."""
        lib = libs[name][0]
        (vals, tc, tp), n_x, out_rows = shapes[sname]
        vals = vals.to(getattr(torch, store))
        x = xs[sname].to(dtype)
        fn = getattr(lib, tm._ENTRY[dtype])
        fn.argtypes = tm._ARGTYPES
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            out = torch.empty((out_rows, width), dtype=dtype, device=dev)
            err = fn(vals.data_ptr(), tm._VALS_KIND[vals.dtype], tc.data_ptr(), tp.data_ptr(),
                     x.data_ptr(), out.data_ptr(), tp.shape[0] - 1, vals.shape[1], n_x, out_rows,
                     width, 1, stream)
            _build.check(lib, err, f"tile_matmul sweep launch ({name}, {sname})")
            return out
        return call

    combos = [(sname, store) for sname in shapes for store in stores]
    dts = (torch.bfloat16, torch.float32)
    want = {(c, dt): caller("source", *c, dt)().clone() for c in combos for dt in dts}
    check = {name: ch for name, _, _, ch in variants}
    check["baseline"] = "bits"
    order = [name for name, *_ in variants] + ["source"]
    if args.baseline:
        order = ["baseline", *order, "baseline"]
    for name in order:
        parts = []
        both = name in ("source", "baseline")
        for c in combos:
            for dt in dts if both else dts[:1]:
                call = caller(name, *c, dt)
                got = call()
                torch.cuda.synchronize()
                if check[name] == "bits":
                    chip_smoke.require(torch.equal(got, want[(c, dt)]),
                                       f"variant {name}: the {dt} entry differs from the "
                                       f"source's bits on {c[0]}, {c[1]} tiles")
                ms = chip_smoke.cuda_ms(call, reps=10, runs=5)
                parts.append(f"{c[0]} {c[1]} tiles {'bf16' if dt == dts[0] else 'f32'} "
                             f"{ms:.4f} ms")
        same = "timed, not checked" if check[name] == "time" else "same bits as the source"
        print(f"[sweep] {name}: " + ", ".join(parts) + f" ({same}); card {card}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
