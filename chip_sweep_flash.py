#!/usr/bin/env python3
"""Time variants of the flash backward kernels K4 (dq) and K5 (dk/dv) on one
NVIDIA GPU, at the collab SBM shape ``chip_smoke.py`` trains on.

    python3 chip_sweep_flash.py [--seed 0]

Each variant is ``plnlp_tpu_torch/csrc/flash_tiles.cu`` with some of its
compile-time knobs replaced (rows a warp owns, list entries in flight,
blocks an SM), built with the port's ``nvcc`` flags into
``build/sweep_flash/`` and loaded with ctypes.  Every variant must give
the same bits as the source as it stands (the knobs change no sum's
order).  Prints the compiler's register and spill report of each variant,
then each variant's K4 and K5 times (CUDA events; median of 5 runs of 10
calls), the source's own first and again last, and the card's name and
power limit.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys

# (name, {knob: value}) over the constexpr knobs of flash_tiles.cu; the
# source as it stands comes first and again last
VARIANTS = [
    ("source", {}),
    ("rows8/8", {"kRowsPerWarpDq": 8, "kRowsPerWarpDkv": 8}),
    ("rows2/2", {"kRowsPerWarpDq": 2}),
    ("rows1/1", {"kRowsPerWarpDkv": 1}),
    ("unroll2-blocks3/2", {"kUnroll": 2, "kMinBlocksDq": 3, "kMinBlocksDkv": 2}),
    ("blocks3/2", {"kMinBlocksDq": 3, "kMinBlocksDkv": 2}),
    ("blocks5/4", {"kMinBlocksDq": 5, "kMinBlocksDkv": 4}),
    ("group4", {"kGroup": 4}),
]


def path_report(report: str) -> str:
    """Registers and spills of the variant K4 and K5 run at the collab
    shape (int8 tiles, d = 256: 16-byte loads, one slice)."""
    out, kind = [], None
    for line in report.splitlines():
        m = re.search(r"flash_bwd_kernelIaLb1ELb0ELb([01])EE", line)
        if "Compiling entry function" in line:
            kind = ("K5" if m.group(1) == "1" else "K4") if m else None
        elif kind and "spill stores" in line:
            sp = re.findall(r"(\d+) bytes spill", line)
            out.append(f"{kind} spill {sp[0]}/{sp[1]} B")
        elif kind and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{kind} {regs} registers")
    return ", ".join(out)


def build_variants(dev_dir):
    """Compile every variant, one nvcc each, all started together; returns
    {name: (library, compiler report)}."""
    from plnlp_tpu_torch import _build

    src = (_build.CSRC / "flash_tiles.cu").read_text()
    dev_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, knobs in VARIANTS:
        text = src
        for knob, value in knobs.items():
            text, n = re.subn(rf"(constexpr int {knob} = )\d+;", rf"\g<1>{value};", text)
            if n != 1:
                raise RuntimeError(f"knob {knob} not found once in flash_tiles.cu")
        tag = re.sub(r"\W", "_", name)
        cu, so = dev_dir / f"flash_tiles_{tag}.cu", dev_dir / f"libflash_tiles_{tag}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{report}")
        lib = ctypes.CDLL(str(so))
        lib.plnlp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.plnlp_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, report)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_sweep_flash: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import chip_smoke
    from plnlp_tpu_torch import _build
    from plnlp_tpu_torch.ops import flash_tiles as ft

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    libs = build_variants(_build.BUILD_DIR.parent / "sweep_flash")
    for name, (_, report) in libs.items():
        print(f"[build] {name}: {path_report(report)}", flush=True)

    data = chip_smoke.hybrid_data(chip_smoke.N_NODES, chip_smoke.N_EDGES,
                                  chip_smoke.N_COMMUNITIES, args.seed, dev)
    hg = data["hg"]
    t = chip_smoke.TILE
    n_r = hg.tile_rowptr.shape[0] - 1
    n_pad = n_r * t
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q, k, v, g = (torch.randn(n_pad, chip_smoke.WIDTH, device=dev, generator=gen)
                  for _ in range(4))
    scale = 1.0 / math.sqrt(chip_smoke.WIDTH)
    num, ml = ft.flash_tiles_fwd(hg.tile_vals, hg.tile_row, hg.tile_col, hg.tile_rowptr,
                                 q, k, v, scale)
    m = torch.where(torch.isfinite(ml[:, 0]), ml[:, 0], 0.0)
    den = ml[:, 1].clamp(min=torch.finfo(torch.float32).tiny)
    stats = torch.stack([m, den, (g * num / den[:, None]).sum(-1)], 1).contiguous()
    sets = {"dq": (hg.tile_vals, hg.tile_col, hg.tile_rowptr),
            "dkv": (hg.tile_vals_t, hg.tile_col_t, hg.tile_rowptr_t)}

    def caller(lib, kind):
        fn = getattr(lib, f"plnlp_flash_tiles_{kind}")
        fn.argtypes = ft._ARGTYPES[kind]
        fn.restype = ctypes.c_int
        vals, tc, tp = sets[kind]
        outs = [torch.empty_like(q) for _ in range(1 if kind == "dq" else 2)]
        ptrs = [a.data_ptr() for a in (tc, tp, q, k, v, g, stats, *outs)]
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            err = fn(vals.data_ptr(), int(vals.dtype == torch.int8), *ptrs, n_r, t, n_pad,
                     chip_smoke.WIDTH, scale, stream)
            _build.check(lib, err, f"flash_tiles_{kind} sweep launch")
            return outs
        return call

    want = {kind: [o.clone() for o in caller(libs["source"][0], kind)()] for kind in sets}
    order = [name for name, _ in VARIANTS] + ["source"]
    for name in order:
        lib = libs[name][0]
        times = []
        for kind in sets:
            call = caller(lib, kind)
            got = call()
            torch.cuda.synchronize()
            chip_smoke.require(all(torch.equal(a, b) for a, b in zip(got, want[kind])),
                               f"variant {name}: flash_tiles_{kind} differs from the source")
            times.append(chip_smoke.cuda_ms(call, reps=10, runs=5))
        print(f"[sweep] {name}: K4 {times[0]:.4f} ms, K5 {times[1]:.4f} ms (same bits as "
              f"the source); card {card}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
