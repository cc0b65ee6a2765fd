#!/usr/bin/env python3
"""Time variants of the flash kernels K3 (forward), K4 (dq) and K5 (dk/dv)
on one NVIDIA GPU, at the collab SBM shape ``chip_smoke.py`` trains on.

    python3 chip_sweep_flash.py [--seed 0] [--dtype bfloat16] [--variants a,b]
                                [--baseline OTHER/flash_tiles.cu]

Each variant is ``plnlp_tpu_torch/csrc/flash_tiles.cu`` with some of its
compile-time knobs replaced (rows a warp owns, list entries in flight,
blocks an SM), or with a function of it replaced by another design, built
with the port's ``nvcc`` flags into ``build/sweep_flash/`` and loaded with
ctypes.  A variant that changes no sum's order must give the same bits as
the source as it stands; one that does (``exact`` False: K3 in one sweep,
rescaling whenever the running max grows) is held to the plain version
with ``chip_smoke.py``'s checks of K3.  Prints the compiler's register and
spill report of each variant, then each variant's K3, K4 and K5 times
(CUDA events; median of 5 runs of 10 calls), the source's own first and
again last, and the card's name and power limit.  ``--dtype bfloat16``
times the bf16 entry points on bf16 features instead; ``--variants`` runs
only the named ones.  ``--baseline`` adds another ``flash_tiles.cu`` (an
earlier commit's, whose entries may lack the gathered-row count) as the
variant ``baseline``, run first and again last around the source: it must
give the source's bits, so the pair is an A/B of two commits in one run.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys

# K3 in one sweep over each 32-entry chunk: for each entry in list order
# (kUnrollFwd v rows in flight), num and den are rescaled whenever the
# running max grows (the source takes the chunk's max first and rescales
# once)
ONE_SWEEP_FWD = """template <bool VEC, typename F>
__device__ __forceinline__ void drain_fwd(const int* lst, int n, FwdRow<F>& w,
                                          const F* __restrict__ k,
                                          const F* __restrict__ v, int rows_g, int c0,
                                          int lane, int d, float scale) {
  __syncwarp();
  for (int b = 0; b < n; b += 32) {
    const int n_b = n - b < 32 ? n - b : 32;
    float s = -INFINITY;
    if (lane < n_b) {
      const int row = lst[b + lane];
      s = (row < rows_g ? dot_seq<VEC>(w.q_row, k + (int64_t)row * d, d) : 0.f) * scale;
    }
    for (int u = 0; u < n_b; u += kUnrollFwd) {
      float x[kUnrollFwd][8], su[kUnrollFwd];
#pragma unroll
      for (int uu = 0; uu < kUnrollFwd; ++uu) {
        su[uu] = __shfl_sync(kFull, s, (u + uu) & 31);
#pragma unroll
        for (int c = 0; c < 8; ++c) x[uu][c] = 0.f;
        if (u + uu >= n_b) continue;  // warp-uniform
        const int row = lst[b + u + uu];
        if (row < rows_g) load_cols<VEC>(v + (int64_t)row * d, c0, lane, d, x[uu]);
      }
#pragma unroll
      for (int uu = 0; uu < kUnrollFwd; ++uu) {
        if (u + uu >= n_b) break;  // warp-uniform
        if (su[uu] > w.m) {  // the factor is 0 while the max is -inf
          const float r = isfinite(w.m) ? expf(w.m - su[uu]) : 0.f;
          w.den *= r;
#pragma unroll
          for (int c = 0; c < 8; ++c) w.num[c] *= r;
          w.m = su[uu];
        }
        const float p = expf(su[uu] - w.m);
        w.den += p;
        const float pv = round_to<F>(p);
#pragma unroll
        for (int c = 0; c < 8; ++c) w.num[c] = fmaf(pv, x[uu][c], w.num[c]);
      }
    }
  }
  __syncwarp();
}
"""

# (name, {knob: value}, {function name: replacement}, exact) over the
# constexpr knobs and functions of flash_tiles.cu; the source as it stands
# comes first and again last
VARIANTS = [
    ("source", {}, {}, True),
    ("fwd-one-sweep", {}, {"drain_fwd": ONE_SWEEP_FWD}, False),
    ("fwd-unroll1", {"kUnrollFwd": 1}, {}, True),
    ("fwd-unroll4", {"kUnrollFwd": 4}, {}, True),
    ("fwd-rows2", {"kRowsPerWarpFwd": 2}, {}, True),
    ("fwd-blocks3", {"kMinBlocksFwd": 3}, {}, True),
    ("fwd-blocks6", {"kMinBlocksFwd": 6}, {}, True),
    ("rows8/8", {"kRowsPerWarpDq": 8, "kRowsPerWarpDkv": 8}, {}, True),
    ("rows2/2", {"kRowsPerWarpDq": 2}, {}, True),
    ("rows1/1", {"kRowsPerWarpDkv": 1}, {}, True),
    ("unroll2-blocks3/2", {"kUnroll": 2, "kMinBlocksDq": 3, "kMinBlocksDkv": 2}, {}, True),
    ("blocks3/2", {"kMinBlocksDq": 3, "kMinBlocksDkv": 2}, {}, True),
    ("blocks5/4", {"kMinBlocksDq": 5, "kMinBlocksDkv": 4}, {}, True),
    ("group4", {"kGroup": 4}, {}, True),
]
KINDS = ("fwd", "dq", "dkv")
LABELS = {"fwd": "K3", "dq": "K4", "dkv": "K5"}


def path_report(report: str) -> str:
    """Registers and spills of the variant K3, K4 and K5 run at the collab
    shape (int8 tiles, d = 256: 16-byte loads, one slice)."""
    out, kind = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fwd = re.search(r"flash_fwd_kernelIaLb1EE", line)
            bwd = re.search(r"flash_bwd_kernelIaLb1ELb0ELb([01])EE", line)
            kind = "K3" if fwd else ("K5" if bwd.group(1) == "1" else "K4") if bwd else None
        elif kind and "spill stores" in line:
            sp = re.findall(r"(\d+) bytes spill", line)
            out.append(f"{kind} spill {sp[0]}/{sp[1]} B")
        elif kind and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{kind} {regs} registers")
    return ", ".join(out)


def variant_source(src: str, knobs, functions) -> str:
    """``src`` with each knob's value and each named function replaced; each
    must be found exactly once."""
    for knob, value in knobs.items():
        src, n = re.subn(rf"(constexpr int {knob} = )\d+;", rf"\g<1>{value};", src)
        if n != 1:
            raise RuntimeError(f"knob {knob} not found once in flash_tiles.cu")
    for name, text in functions.items():
        # from the template line before the definition to the closing brace
        # in column 0
        pat = re.compile(rf"template <[^>]*>\n__device__ __forceinline__ void {name}\(.*?\n}}\n",
                         re.S)
        src, n = pat.subn(lambda _: text, src)
        if n != 1:
            raise RuntimeError(f"function {name} not found once in flash_tiles.cu")
    return src


def build_variants(dev_dir, variants, baseline=None):
    """Compile every variant (and ``baseline``'s source, if given), one nvcc
    each, all started together; returns {name: (library, compiler
    report)}."""
    from plnlp_tpu_torch import _build

    src = (_build.CSRC / "flash_tiles.cu").read_text()
    dev_dir.mkdir(parents=True, exist_ok=True)
    texts = {name: variant_source(src, knobs, functions) for name, knobs, functions, _ in variants}
    if baseline is not None:
        texts["baseline"] = baseline
    procs = {}
    for name, text in texts.items():
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
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--variants", default="", help="comma-separated names (default: all)")
    ap.add_argument("--baseline", default="", help="another flash_tiles.cu to A/B against")
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
    variants = [v for v in VARIANTS if v[0] == "source"
                or not args.variants or v[0] in args.variants.split(",")]
    baseline = open(args.baseline).read() if args.baseline else None
    libs = build_variants(_build.BUILD_DIR.parent / "sweep_flash", variants, baseline)
    for name, (_, report) in libs.items():
        print(f"[build] {name}: {path_report(report)}", flush=True)

    data = chip_smoke.hybrid_data(chip_smoke.N_NODES, chip_smoke.N_EDGES,
                                  chip_smoke.N_COMMUNITIES, args.seed, dev)
    hg = data["hg"]
    t = chip_smoke.TILE
    n_r = hg.tile_rowptr.shape[0] - 1
    n_pad = n_r * t
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bf16 = args.dtype == "bfloat16"
    q, k, v, g = (torch.randn(n_pad, chip_smoke.WIDTH, device=dev, generator=gen
                              ).to(getattr(torch, args.dtype)) for _ in range(4))
    scale = 1.0 / math.sqrt(chip_smoke.WIDTH)
    fwd_set = (hg.tile_vals, hg.tile_row, hg.tile_col, hg.tile_rowptr)
    num_r, ml_r = ft.flash_tiles_fwd_reference(*fwd_set[:3], q, k, v, n_r, scale)
    num_a, _ = ft.flash_tiles_fwd_reference(*fwd_set[:3], q, k, v.abs(), n_r, scale)
    m = torch.where(torch.isfinite(ml_r[:, 0]), ml_r[:, 0], 0.0)
    den = ml_r[:, 1].clamp(min=torch.finfo(torch.float32).tiny)
    stats = torch.stack([m, den, (g.float() * num_r / den[:, None]).sum(-1)], 1).contiguous()
    sets = {"fwd": (hg.tile_vals, hg.tile_col, hg.tile_rowptr),
            "dq": (hg.tile_vals, hg.tile_col, hg.tile_rowptr),
            "dkv": (hg.tile_vals_t, hg.tile_col_t, hg.tile_rowptr_t)}

    def caller(name, kind):
        lib = libs[name][0]
        fn = getattr(lib, f"plnlp_flash_tiles_{kind}" + ("_bf16" if bf16 else ""))
        # a baseline from before the gathered-row count (rows_g, the fourth
        # argument from the end) takes one count
        split = name != "baseline" or "int rows_g" in baseline
        types = ft._ARGTYPES[kind]
        fn.argtypes = types if split else types[:-4] + types[-3:]
        fn.restype = ctypes.c_int
        vals, tc, tp = sets[kind]
        f32 = dict(dtype=torch.float32, device=dev)
        if kind == "fwd":
            outs = [torch.empty((n_pad, chip_smoke.WIDTH), **f32), torch.empty((n_pad, 2), **f32)]
            ptrs = [a.data_ptr() for a in (tc, tp, q, k, v, *outs)]
        else:
            outs = [torch.empty((n_pad, chip_smoke.WIDTH), **f32)
                    for _ in range(1 if kind == "dq" else 2)]
            ptrs = [a.data_ptr() for a in (tc, tp, q, k, v, g, stats, *outs)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows = (n_pad, n_pad) if split else (n_pad,)

        def call():
            err = fn(vals.data_ptr(), int(vals.dtype == torch.int8), *ptrs, n_r, t, *rows,
                     chip_smoke.WIDTH, scale, stream)
            _build.check(lib, err, f"flash_tiles_{kind} sweep launch")
            return outs
        return call

    want = {kind: [o.clone() for o in caller("source", kind)()] for kind in KINDS}
    exact = {name: ex for name, _, _, ex in variants}
    exact["baseline"] = True
    order = [name for name, *_ in variants] + ["source"]
    if baseline is not None:
        order = ["baseline", *order, "baseline"]
    for name in order:
        times, notes = [], []
        for kind in KINDS:
            call = caller(name, kind)
            got = call()
            torch.cuda.synchronize()
            if exact[name] or kind != "fwd":
                chip_smoke.require(all(torch.equal(a, b) for a, b in zip(got, want[kind])),
                                   f"variant {name}: flash_tiles_{kind} differs from the source")
            else:
                ratio, empty_ok, _ = chip_smoke.fwd_errors(
                    *got, num_r, ml_r, num_a,
                    chip_smoke.SUM_RTOL + (chip_smoke.BF16_RTOL if bf16 else 0.0))
                chip_smoke.require(ratio <= 1.0 and empty_ok,
                                   f"variant {name}: flash_tiles_fwd disagrees with its plain "
                                   f"version (max err/tol {ratio:.3f})")
                notes.append(f"K3 max err/tol {ratio:.3f} against the plain version")
            times.append(chip_smoke.cuda_ms(call, reps=10, runs=5))
        same = "; ".join(notes) or "same bits as the source"
        print(f"[sweep] {name} ({args.dtype}): " + ", ".join(f"{LABELS[kd]} {ms:.4f} ms" for kd, ms in
                                              zip(KINDS, times))
              + f" ({same}); card {card}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
