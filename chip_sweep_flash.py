#!/usr/bin/env python3
"""Time variants of the flash kernels K3 (forward), K4 (dq) and K5 (dk/dv)
on one NVIDIA GPU, at the collab SBM shape ``chip_smoke.py`` trains on and
on shard 0 of its 4-shard tiled partition.

    python3 chip_sweep_flash.py [--seed 0] [--dtype float32,bfloat16]
                                [--store int8,bfloat16] [--shapes SBM,shard]
                                [--variants a,b]
                                [--baseline OTHER/flash_tiles.cu]
                                [--source OTHER/flash_tiles.cu] [--f64]

Each variant is ``plnlp_tpu_torch/csrc/flash_tiles.cu`` with some of its
compile-time knobs replaced (rows a warp owns, list entries in flight,
blocks an SM), a function of it replaced by another design, or lines of it
edited (``EDITS``), built with the port's ``nvcc`` flags into
``build/sweep_flash/``, one nvcc each, all started together, and loaded
with ctypes.  A variant that changes no sum's order must give the same
bits as the source as it stands; one that does (``check`` "plain": K3 in
one sweep, rescaling whenever the running max grows) is held to the plain
version with ``chip_smoke.py``'s checks of K3; one that computes only a
part of a kernel to split its time (``check`` "time"; ``PARTS`` names the
kernels it splits, K3 by default) is timed there and not checked: the
list scan alone, the scan with the gathers and no math, the scan with the
math on rows in registers and no gather (``dq-*`` K4-bf16's own drain,
``dkv-*`` K5-bf16's; ``bwd-*`` ``drain_bwd``, which since K4-bf16 and
K5-bf16 have kernels of their own runs only the f32 K4 and K5 and the
bf16 wide and scalar paths, and the bf16 entries of an earlier commit's
file given with ``--source``), K3's scores or v rows alone.  Prints the
compiler's register and spill report of each variant, then each variant's
K3, K4 and K5 times (CUDA events; median of 5 runs of 10 calls) on each
shape, feature type and tile store, the source's own first and again
last, and the card's name and power limit.  Shapes: ``SBM`` (2,658 int8
tiles, T = 256, d = 256, every array at the padded-carry n_pad rows) and
``shard`` (shard 0 of phase 31c's partition at split row counts: the own
arrays at rows_per_shard rows, the gathered ones at 4 x rows_per_shard,
as phase 31d launches them); the stats come from the plain forward.
``--dtype`` names the feature types (bf16 times the bf16 entry points);
``--store bfloat16`` the same tiles stored in bf16 in place of int8.
``--variants`` runs only the named ones.  ``--baseline`` adds another
``flash_tiles.cu`` (an earlier commit's, whose entries may lack the
gathered-row count: then only the SBM shape runs) as the variant
``baseline``, run first and again last around the source: it must give
the source's bits, so the pair is an A/B of two commits in one run.
``--source`` takes the variants from another ``flash_tiles.cu`` (an
earlier commit's, to split its time) in place of the repository's.
``--f64`` then prints, at the SBM shape on the int8 tiles, the largest
error of K4's dq and of K5's dv (the source's kernels, and their plain
versions) against a float64 evaluation of the same function, each also
as a share of ``chip_smoke.py``'s tolerance for the kernel against the
plain version (which stays as it is).  Imports nothing of JAX, of the
JAX package or of ``tests/``.
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

# The parts of the lane-per-entry K3 (drain_fwd: the f32 entry's, and the
# bf16 entry's before the packed kernel; time an earlier commit's with
# --source): the list scan alone (each drain reads its last entry, so the
# lists are built); the scores, the chunk max and the weights without the
# v rows (den takes the weights' warp sum); the v rows and the weights
# without the scores (every score 0)
SCAN_ONLY_FWD = """template <bool VEC, typename F>
__device__ __forceinline__ void drain_fwd(const int* lst, int n, FwdRow<F>& w,
                                          const F* __restrict__ k,
                                          const F* __restrict__ v, int rows_g, int c0,
                                          int lane, int d, float scale) {
  __syncwarp();
  if (n) w.den += (float)lst[n - 1];
  __syncwarp();
}
"""
SCORES_ONLY_FWD = """template <bool VEC, typename F>
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
    const float m_new = fmaxf(w.m, warp_max(s));
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float r = isfinite(w.m) ? expf(w.m - m_safe) : 0.f;
    w.m = m_new;
    w.den = w.den * r + warp_sum(expf(s - m_safe));
  }
  __syncwarp();
}
"""
V_ONLY_FWD = """template <bool VEC, typename F>
__device__ __forceinline__ void drain_fwd(const int* lst, int n, FwdRow<F>& w,
                                          const F* __restrict__ k,
                                          const F* __restrict__ v, int rows_g, int c0,
                                          int lane, int d, float scale) {
  __syncwarp();
  for (int b = 0; b < n; b += 32) {
    const int n_b = n - b < 32 ? n - b : 32;
    const float s = lane < n_b ? 0.f : -INFINITY;
    const float m_new = fmaxf(w.m, warp_max(s));
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float r = isfinite(w.m) ? expf(w.m - m_safe) : 0.f;
    w.m = m_new;
    w.den *= r;
#pragma unroll
    for (int c = 0; c < 8; ++c) w.num[c] *= r;
    const float p_lane = expf(s - m_safe);
    for (int u = 0; u < n_b; u += kUnrollFwd) {
      float x[kUnrollFwd][8], p[kUnrollFwd];
#pragma unroll
      for (int uu = 0; uu < kUnrollFwd; ++uu) {
        p[uu] = __shfl_sync(kFull, p_lane, (u + uu) & 31);
#pragma unroll
        for (int c = 0; c < 8; ++c) x[uu][c] = 0.f;
        if (u + uu >= n_b) continue;  // warp-uniform
        const int row = lst[b + u + uu];
        if (row < rows_g) load_cols<VEC>(v + (int64_t)row * d, c0, lane, d, x[uu]);
      }
#pragma unroll
      for (int uu = 0; uu < kUnrollFwd; ++uu) {
        if (u + uu >= n_b) break;  // warp-uniform
        w.den += p[uu];
        const float pv = round_to<F>(p[uu]);
#pragma unroll
        for (int c = 0; c < 8; ++c) w.num[c] = fmaf(pv, x[uu][c], w.num[c]);
      }
    }
  }
  __syncwarp();
}
"""

# The parts of the packed K3 (the bf16 entry with 16-byte rows): the list
# scan alone (no pass), the passes without the v rows' loads, the passes
# without the scores (every score 0); the packed K3 with each pass's k and
# v rows asked into L1 first; bf16 features on drain_fwd (the lane-per-entry
# design) in place of the packed kernel.  Each a line edit of flash_tiles.cu.
PK_SCAN_ONLY = [("      pass_pk(lst, tag, head, n_b, w, q, k, v, num, ml, grow0, rows_g, c0, "
                 "lane, d, scale);", "      w.den += (float)lst[head & (kRing - 1)];")]
PK_NO_V = [("        x[uu] = __ldg(reinterpret_cast<const uint4*>("
            "v + (int64_t)row * d + vc));", "        x[uu] = make_uint4(row, 0u, 0u, 0u);")]
PK_NO_SCORES = [("  if (scored) s = dot_seq<true>(q + (grow0 + lr) * d, "
                 "k + (int64_t)jrow * d, d);", "")]
PK_PREFETCH = [("  const int crow_lane = scored ? jrow : -1;\n",
                """  const int crow_lane = scored ? jrow : -1;
  if (scored) {
    const char* kr = reinterpret_cast<const char*>(k + (int64_t)jrow * d);
    const char* vr = reinterpret_cast<const char*>(v + (int64_t)jrow * d);
    for (int c = 0; c < d * 2; c += 128) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(kr + c));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(vr + c));
    }
  }
""")]
# The parts of drain_bwd (K4 and K5 in f32, the bf16 wide and scalar
# paths, and K4 and K5 in bf16 before their own drains; time an earlier
# commit's with --source): the list scan alone (each drain reads its last
# entry, so the lists are built); the scan, the list and the gathers of
# the two rows and the stats with no dot
# product, butterfly or expf (the registers take the rows as they come);
# the scan, the list and the math on the warp's own rows in registers in
# place of the gathered ones (no gather; each entry's terms depend on its
# row, so nothing is hoisted out of the loop)
SCAN_ONLY_BWD = """template <typename F, bool VEC, bool WIDE, bool DKV>
__device__ __forceinline__ void drain_bwd(const int* lst, int n, BwdRow<F>& w,
                                          const F* __restrict__ gat_a,
                                          const F* __restrict__ gat_b,
                                          const float* __restrict__ stats, int c0, int lane,
                                          int d, float scale) {
  __syncwarp();
  if (n) w.acc_a[0] += (float)lst[n - 1];
  __syncwarp();
}
"""
NO_MATH_BWD = """template <typename F, bool VEC, bool WIDE, bool DKV>
__device__ __forceinline__ void drain_bwd(const int* lst, int n, BwdRow<F>& w,
                                          const F* __restrict__ gat_a,
                                          const F* __restrict__ gat_b,
                                          const float* __restrict__ stats, int c0, int lane,
                                          int d, float scale) {
  __syncwarp();
  for (int b = 0; b < n; b += kUnroll) {
    float xa[kUnroll][8], xb[kUnroll][8], st[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = b + u < n;  // warp-uniform
      const int64_t row = live ? lst[b + u] : 0;
      st[u] = 0.f;
      if (DKV && live)
        st[u] = __ldg(stats + row * 3) + __ldg(stats + row * 3 + 1) + __ldg(stats + row * 3 + 2);
#pragma unroll
      for (int c = 0; c < 8; ++c) xa[u][c] = xb[u][c] = 0.f;
      if (live) {
        load_cols<VEC>(gat_a + row * d, c0, lane, d, xa[u]);
        load_cols<VEC>(gat_b + row * d, c0, lane, d, xb[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b + u >= n) break;  // warp-uniform
      w.acc_a[0] += st[u];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        w.acc_a[c] += xa[u][c];
        w.acc_b[c] += xb[u][c];
      }
    }
  }
  __syncwarp();
}
"""
NO_GATHER_BWD = """template <typename F, bool VEC, bool WIDE, bool DKV>
__device__ __forceinline__ void drain_bwd(const int* lst, int n, BwdRow<F>& w,
                                          const F* __restrict__ gat_a,
                                          const F* __restrict__ gat_b,
                                          const float* __restrict__ stats, int c0, int lane,
                                          int d, float scale) {
  __syncwarp();
  for (int b = 0; b < n; b += kUnroll) {
    float s[kUnroll], dav[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = (float)(b + u < n ? lst[b + u] : 0) * 1e-30f;
      s[u] = dot8(w.oa, w.oa, r[u]);
      dav[u] = dot8(w.ob, w.ob, r[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = warp_sum(s[u]);
      dav[u] = warp_sum(dav[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b + u >= n) break;  // warp-uniform
      const float a = expf(s[u] * scale - (w.m + r[u])) / (w.den + r[u]);
      const float ds = round_to<F>(a * (dav[u] - w.delta) * scale);
      const float ar = round_to<F>(a);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        w.acc_a[c] = fmaf(ds, w.oa[c], w.acc_a[c]);
        if (DKV) w.acc_b[c] = fmaf(ar, w.ob[c], w.acc_b[c]);
      }
    }
  }
  __syncwarp();
}
"""
# The parts of K5-bf16's own drain (drain_dkv_bf): the list scan alone;
# the scan, the list, the stats and the gathers of the two rows in flight
# as the drain issues them, with no dot product, butterfly or expf; the
# scan, the list and the math on the warp's own rows in place of the
# gathered ones (no gather and no stats load)
DKV_SIG = """\
__device__ __forceinline__ void drain_dkv_bf(const int* lst, int n, DkvRowBf& w,
                                             const bf16* __restrict__ q,
                                             const bf16* __restrict__ g,
                                             const float* __restrict__ stats, int lane, int d,
                                             float scale) {
"""
DKV_SCAN_ONLY = DKV_SIG + """  __syncwarp();
  if (n) w.dk[0] += (float)lst[n - 1];
  __syncwarp();
}
"""
DKV_NO_MATH = DKV_SIG + """  __syncwarp();
  const int col = 8 * lane;
  const bool on = col < d;
  float m_l, den_l, del_l;
  load_stats_bf(lst, lane, n, stats, m_l, den_l, del_l);
  for (int b = 0; b < n; b += kUnrollDkvBf) {
    uint4 qa[kUnrollDkvBf], ga[kUnrollDkvBf];
    issue_rows_bf(lst, b, n, q, g, col, on, d, qa, ga);
    if (b && (b & 31) == 0) load_stats_bf(lst, b + lane, n, stats, m_l, den_l, del_l);
#pragma unroll
    for (int u = 0; u < kUnrollDkvBf; ++u) {
      const int e = b + u;
      const float st = __shfl_sync(kFull, m_l + den_l + del_l, e & 31);
      if (e >= n) break;  // warp-uniform
      float xq[8], xg[8];
      unpack8(qa[u], xq);
      unpack8(ga[u], xg);
      w.dk[0] += st;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        w.dk[c] += xq[c];
        w.dv[c] += xg[c];
      }
    }
  }
  __syncwarp();
}
"""
DKV_NO_GATHER = DKV_SIG + """  __syncwarp();
  float ok[8], ov[8];
  unpack8(w.k, ok);
  unpack8(w.v, ov);
  for (int b = 0; b < n; b += kUnrollDkvBf) {
    float x[2 * kUnrollDkvBf], r[kUnrollDkvBf];
#pragma unroll
    for (int u = 0; u < kUnrollDkvBf; ++u) {
      r[u] = (float)(b + u < n ? lst[b + u] : 0) * 1e-30f;
      x[2 * u] = dot8(ok, ok, r[u]);
      x[2 * u + 1] = dot8(ov, ov, r[u]);
    }
    warp_sums(x, lane);
#pragma unroll
    for (int u = 0; u < kUnrollDkvBf; ++u) {
      if (b + u >= n) break;  // warp-uniform
      const float a = expf(x[2 * u] * scale - r[u]) / (1.f + r[u]);
      const float ds = round_to<bf16>(a * (x[2 * u + 1] - r[u]) * scale);
      const float ar = round_to<bf16>(a);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        w.dk[c] = fmaf(ds, ok[c], w.dk[c]);
        w.dv[c] = fmaf(ar, ov[c], w.dv[c]);
      }
    }
  }
  __syncwarp();
}
"""
# The parts of K4-bf16's own drain (drain_dq_bf), as K5-bf16's: the list
# scan alone; the scan, the list and the gathers of the two rows in flight
# as the drain issues them, with no dot product, butterfly or expf; the
# scan, the list and the math on the warp's own rows in place of the
# gathered ones (no gather)
DQ_SIG = """\
__device__ __forceinline__ void drain_dq_bf(const int* lst, int n, DqRowBf& w,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v, int lane, int d,
                                            float scale) {
"""
DQ_SCAN_ONLY = DQ_SIG + """  __syncwarp();
  if (n) w.dq[0] += (float)lst[n - 1];
  __syncwarp();
}
"""
DQ_NO_MATH = DQ_SIG + """  __syncwarp();
  const int col = 8 * lane;
  const bool on = col < d;
  for (int b = 0; b < n; b += kUnrollDqBf) {
    uint4 ka[kUnrollDqBf], va[kUnrollDqBf];
    issue_rows_bf(lst, b, n, k, v, col, on, d, ka, va);
#pragma unroll
    for (int u = 0; u < kUnrollDqBf; ++u) {
      if (b + u >= n) break;  // warp-uniform
      float xk[8], xv[8];
      unpack8(ka[u], xk);
      unpack8(va[u], xv);
#pragma unroll
      for (int c = 0; c < 8; ++c) w.dq[c] += xk[c] + xv[c];
    }
  }
  __syncwarp();
}
"""
DQ_NO_GATHER = DQ_SIG + """  __syncwarp();
  float oq[8], og[8];
  unpack8(w.q, oq);
  unpack8(w.g, og);
  for (int b = 0; b < n; b += kUnrollDqBf) {
    float x[2 * kUnrollDqBf], r[kUnrollDqBf];
#pragma unroll
    for (int u = 0; u < kUnrollDqBf; ++u) {
      r[u] = (float)(b + u < n ? lst[b + u] : 0) * 1e-30f;
      x[2 * u] = dot8(oq, oq, r[u]);
      x[2 * u + 1] = dot8(og, og, r[u]);
    }
    warp_sums(x, lane);
#pragma unroll
    for (int u = 0; u < kUnrollDqBf; ++u) {
      if (b + u >= n) break;  // warp-uniform
      const float a = expf(x[2 * u] * scale - (w.m + r[u])) / (w.den + r[u]);
      const float ds = round_to<bf16>(a * (x[2 * u + 1] - w.delta) * scale);
#pragma unroll
      for (int c = 0; c < 8; ++c) w.dq[c] = fmaf(ds, oq[c], w.dq[c]);
    }
  }
  __syncwarp();
}
"""
LANE_PER_ENTRY = [("    if constexpr (sizeof(F) == 2 && VEC) {", "    if constexpr (false) {")]
EDITS = {"pk-scan-only": PK_SCAN_ONLY, "pk-no-v": PK_NO_V, "pk-no-scores": PK_NO_SCORES,
         "pk-prefetch": PK_PREFETCH, "lpe": LANE_PER_ENTRY}

# (name, {knob: value}, {function name: replacement}, check) over the
# constexpr knobs and functions of flash_tiles.cu (and the line edits of
# EDITS), where check is "bits" (the source's bits), "plain" (K3 within its
# checks against the plain version: the variant changes a sum's order) or
# "time" (a part of the kernels PARTS names, timed alone; the others keep
# the source's bits); the source as it stands comes first and again last
VARIANTS = [
    ("source", {}, {}, "bits"),
    ("pk-scan-only", {}, {}, "time"),
    ("pk-no-v", {}, {}, "time"),
    ("pk-no-scores", {}, {}, "time"),
    ("pk-prefetch", {}, {}, "bits"),
    ("lpe", {}, {}, "bits"),
    ("pk-rows1", {"kRowsPk": 1}, {}, "bits"),
    ("pk-rows3", {"kRowsPk": 3}, {}, "bits"),
    ("pk-rows4", {"kRowsPk": 4}, {}, "bits"),
    ("pk-blocks6", {"kMinBlocksPk": 6}, {}, "bits"),
    ("pk-blocks8", {"kMinBlocksPk": 8}, {}, "bits"),
    ("pk-unroll4", {"kUnrollPk": 4}, {}, "bits"),
    ("pk-unroll4-blocks6", {"kUnrollPk": 4, "kMinBlocksPk": 6}, {}, "bits"),
    ("pk-group1", {"kGroupPk": 1}, {}, "bits"),
    ("pk-warps8-blocks3", {"kWarpsPk": 8, "kMinBlocksPk": 3}, {}, "bits"),
    ("dq-scan-only", {}, {"drain_dq_bf": DQ_SCAN_ONLY}, "time"),
    ("dq-no-math", {}, {"drain_dq_bf": DQ_NO_MATH}, "time"),
    ("dq-no-gather", {}, {"drain_dq_bf": DQ_NO_GATHER}, "time"),
    ("dq-u1", {"kUnrollDqBf": 1}, {}, "bits"),
    ("dq-u4-blocks2", {"kUnrollDqBf": 4, "kMinBlocksDqBf": 2, "kGroupDqBfWideVals": 2}, {},
     "bits"),
    ("dq-group1", {"kGroupDqBf": 1}, {}, "bits"),
    ("dq-group2", {"kGroupDqBfWideVals": 2}, {}, "bits"),
    ("dq-rows2", {"kRowsDqBf": 2}, {}, "bits"),
    ("dq-rows8", {"kRowsDqBf": 8}, {}, "bits"),
    ("dq-blocks2", {"kMinBlocksDqBf": 2}, {}, "bits"),
    ("dq-blocks4", {"kMinBlocksDqBf": 4}, {}, "bits"),
    ("dkv-scan-only", {}, {"drain_dkv_bf": DKV_SCAN_ONLY}, "time"),
    ("dkv-no-math", {}, {"drain_dkv_bf": DKV_NO_MATH}, "time"),
    ("dkv-no-gather", {}, {"drain_dkv_bf": DKV_NO_GATHER}, "time"),
    ("dkv-u2", {"kUnrollDkvBf": 2}, {}, "bits"),
    ("dkv-u8", {"kUnrollDkvBf": 8}, {}, "bits"),
    ("dkv-group1", {"kGroupDkvBf": 1}, {}, "bits"),
    ("dkv-rows2", {"kRowsDkvBf": 2}, {}, "bits"),
    ("dkv-rows8", {"kRowsDkvBf": 8}, {}, "bits"),
    ("dkv-blocks3", {"kMinBlocksDkvBf": 3}, {}, "bits"),
    ("dkv-u2-blocks3", {"kUnrollDkvBf": 2, "kMinBlocksDkvBf": 3}, {}, "bits"),
    ("bwd-scan-only", {}, {"drain_bwd": SCAN_ONLY_BWD}, "time"),
    ("bwd-no-math", {}, {"drain_bwd": NO_MATH_BWD}, "time"),
    ("bwd-no-gather", {}, {"drain_bwd": NO_GATHER_BWD}, "time"),
    ("fwd-scan-only", {}, {"drain_fwd": SCAN_ONLY_FWD}, "time"),
    ("fwd-scores-only", {}, {"drain_fwd": SCORES_ONLY_FWD}, "time"),
    ("fwd-v-only", {}, {"drain_fwd": V_ONLY_FWD}, "time"),
    ("fwd-one-sweep", {}, {"drain_fwd": ONE_SWEEP_FWD}, "plain"),
    ("fwd-unroll1", {"kUnrollFwd": 1}, {}, "bits"),
    ("fwd-unroll4", {"kUnrollFwd": 4}, {}, "bits"),
    ("fwd-rows2", {"kRowsPerWarpFwd": 2}, {}, "bits"),
    ("fwd-blocks3", {"kMinBlocksFwd": 3}, {}, "bits"),
    ("fwd-blocks6", {"kMinBlocksFwd": 6}, {}, "bits"),
    ("rows8/8", {"kRowsPerWarpDq": 8, "kRowsPerWarpDkv": 8}, {}, "bits"),
    ("rows2/2", {"kRowsPerWarpDq": 2}, {}, "bits"),
    ("rows1/1", {"kRowsPerWarpDkv": 1}, {}, "bits"),
    ("unroll2-blocks3/2", {"kUnroll": 2, "kMinBlocksDq": 3, "kMinBlocksDkv": 2}, {}, "bits"),
    ("blocks3/2", {"kMinBlocksDq": 3, "kMinBlocksDkv": 2}, {}, "bits"),
    ("blocks5/4", {"kMinBlocksDq": 5, "kMinBlocksDkv": 4}, {}, "bits"),
    ("group4", {"kGroup": 4}, {}, "bits"),
]
KINDS = ("fwd", "dq", "dkv")
# the kernels a "time" variant computes a part of, by the first word of its
# name (K3 otherwise; the rest are checked)
PARTS = {"dq": ("dq",), "dkv": ("dkv",), "bwd": ("dq", "dkv")}
LABELS = {"fwd": "K3", "dq": "K4", "dkv": "K5"}


def path_report(report: str) -> str:
    """Registers, spills and shared memory of the variant's K3, K4 and K5
    at the collab shape (int8 tiles, d = 256: 16-byte loads, one slice), f32
    and bf16 features (in bf16 K3's packed kernel, K4's and K5's own, these
    two also on the bf16 and f32 tile stores)."""
    out, kind = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fwd = re.search(r"flash_fwd_kernelIa(f|13__nv_bfloat16)Lb1EE", line)
            pk = re.search(r"flash_fwd_packed_kernelIaEE", line)
            bwd = re.search(r"flash_bwd_kernelIa(f|13__nv_bfloat16)Lb1ELb0ELb([01])EE", line)
            own = re.search(r"flash_(dq|dkv)_bf16_kernelI(a|13__nv_bfloat16|f)EE", line)
            dt = lambda m: "" if m.group(1) == "f" else "-bf16"  # noqa: E731
            kind = (f"K3{dt(fwd)}" if fwd else "K3-bf16" if pk
                    else f"{'K4' if own.group(1) == 'dq' else 'K5'}-bf16"
                         + {"a": "", "f": " (f32 tiles)"}.get(own.group(2), " (bf16 tiles)")
                    if own
                    else f"{'K5' if bwd.group(2) == '1' else 'K4'}{dt(bwd)}" if bwd else None)
        elif kind and "spill stores" in line:
            sp = re.findall(r"(\d+) bytes spill", line)
            if sp != ["0", "0"]:
                out.append(f"{kind} spill {sp[0]}/{sp[1]} B")
        elif kind and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{kind} {regs} registers" + (f" {smem.group(1)} B smem" if smem else ""))
    return ", ".join(out)


def variant_source(src: str, knobs, functions, what: str = "flash_tiles.cu", edits=()) -> str:
    """``src`` with each knob's value, each named function and each (old,
    new) line edit replaced; each must be found exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"edit {old.strip()[:40]!r} not found once in {what}")
        src = src.replace(old, new)
    for knob, value in knobs.items():
        src, n = re.subn(rf"(constexpr int {knob} = )\d+;", rf"\g<1>{value};", src)
        if n != 1:
            raise RuntimeError(f"knob {knob} not found once in {what}")
    for name, text in functions.items():
        # from the template line before the definition, if any, to the
        # closing brace in column 0
        pat = re.compile(rf"(?:template <[^>]*>\n)?__device__ __forceinline__ void {name}\("
                         rf".*?\n}}\n", re.S)
        src, n = pat.subn(lambda _: text, src)
        if n != 1:
            raise RuntimeError(f"function {name} not found once in {what}")
    return src


def build_sources(dev_dir, stem: str, texts: dict) -> dict:
    """Compile each {name: source text} with the port's nvcc flags into
    ``dev_dir``, one nvcc each, all started together; returns {name:
    (library, compiler report)}."""
    from plnlp_tpu_torch import _build

    dev_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        tag = re.sub(r"\W", "_", name)
        cu, so = dev_dir / f"{stem}_{tag}.cu", dev_dir / f"lib{stem}_{tag}.so"
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


def build_variants(dev_dir, variants, baseline=None, src=None):
    """Compile every variant of ``src`` (the repository's flash_tiles.cu by
    default), and ``baseline``'s source if given; returns {name: (library,
    compiler report)}."""
    from plnlp_tpu_torch import _build

    if src is None:
        src = (_build.CSRC / "flash_tiles.cu").read_text()
    texts = {name: variant_source(src, knobs, functions, edits=EDITS.get(name, ()))
             for name, knobs, functions, _ in variants}
    if baseline is not None:
        texts["baseline"] = baseline
    return build_sources(dev_dir, "flash_tiles", texts)


def shard_tiles(data, dev):
    """Shard 0 of phase 31c's 4-shard tiled partition of the SBM (labelprop
    over the relabeled ids with the identity order, T = 256, min_fill = 96,
    as the CLI builds it): (rows_per_shard, its row-sorted tile set, its
    transposed one), each as {"vals", "row", "col", "rowptr"}.  Its own
    rows are slots [0, rows_per_shard) of the gathered buffer of 4 x
    rows_per_shard rows."""
    import numpy as np

    import chip_smoke
    from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel
    from plnlp_tpu_torch.parallel.mesh import Mesh
    from plnlp_tpu_torch.parallel.partition import partition_graph

    n = data["hg"].num_nodes
    relabel = np.empty(n, np.int64)
    relabel[data["est"]["order"]] = np.arange(n)
    pg = partition_graph(*(relabel[e] for e in data["edges"]), None, num_nodes=n,
                         num_shards=4, block=chip_smoke.BLOCK, reorder="labelprop",
                         tile=chip_smoke.TILE, min_fill=chip_smoke.MIN_FILL,
                         order=np.arange(n, dtype=np.int64))
    sh = GraphParallel.place(pg, Mesh(1, 4, rank=0, device=dev))
    return pg.rows_per_shard, sh.tiles, sh.tiles_t


def f64_backward(vals, tile_row, tile_col, q, k, v, g, stats, n_r, scale, transposed):
    """K4's dq over the row-sorted tiles, or K5's dv over the transposed
    ones (``transposed``), evaluated in float64 from the same inputs, chunk
    by chunk as the plain versions run: the dot products, exp and divide in
    f64, and with bf16 features each second product's weight rounded to
    bf16 (as the TPU kernels cast it) from its f64 value."""
    import torch

    from plnlp_tpu_torch.ops.flash_tiles import _chunks, _gathered_tiles

    t, d = vals.shape[1], q.shape[1]
    bf16 = q.dtype == torch.bfloat16

    def tiles(a, n):  # (rows, D) -> (n, T, D) float64, rows past the end zero
        a = a.double()
        pad = n * t - a.shape[0]
        if pad:
            a = torch.cat([a, a.new_zeros((pad, d))])
        return a.reshape(n, t, d)

    def weight(w):
        return w.to(torch.bfloat16).double() if bf16 else w

    own, gathered = ((k, v), (q, g)) if transposed else ((q, g), (k, v))
    n_g = _gathered_tiles(gathered[0].shape[0], t)
    at, bt = tiles(own[0], n_r), tiles(own[1], n_r)
    ct, dt = tiles(gathered[0], n_g), tiles(gathered[1], n_g)
    n_s = n_g if transposed else n_r  # the stats are the gathered rows' in K5
    st = stats.double()
    if n_s * t > st.shape[0]:  # rows past the end read (0, 1, 0)
        fill = st.new_zeros((n_s * t - st.shape[0], 3))
        fill[:, 1] = 1.0
        st = torch.cat([st, fill])
    st = st.reshape(n_s, t, 3)
    out = at.new_zeros((n_r, t, d))
    for c in _chunks(vals.shape[0]):
        r, cc = tile_row[c].long(), tile_col[c].long()
        s = torch.bmm(at[r], ct[cc].transpose(1, 2)) * scale
        if transposed:
            m, den = st[cc][:, None, :, 0], st[cc][:, None, :, 1]
        else:
            m, den, delta = (st[r][:, :, None, i] for i in range(3))
        alpha = torch.where(vals[c] != 0, torch.exp(s - m) / den, 0.0)
        if transposed:
            out.index_add_(0, r, torch.bmm(weight(alpha), dt[cc]))
        else:
            ds = alpha * (torch.bmm(bt[r], dt[cc].transpose(1, 2)) - delta) * scale
            out.index_add_(0, r, torch.bmm(weight(ds), ct[cc]))
    return out.reshape(-1, d)[:own[0].shape[0]]


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    help="comma-separated feature types: float32, bfloat16")
    ap.add_argument("--variants", default="", help="comma-separated names (default: all)")
    ap.add_argument("--baseline", default="", help="another flash_tiles.cu to A/B against")
    ap.add_argument("--source", default="", help="another flash_tiles.cu to take variants of")
    ap.add_argument("--store", default="int8",
                    help="comma-separated tile stores: int8 (the SBM's), bfloat16 (the same "
                         "tiles in bf16)")
    ap.add_argument("--shapes", default="SBM,shard",
                    help="comma-separated: SBM (the single operand), shard (shard 0 of the "
                         "4-shard tiled partition at split row counts)")
    ap.add_argument("--f64", action="store_true",
                    help="then print K4's dq and K5's dv errors, the kernels' and the plain "
                         "versions', against a float64 evaluation at the SBM shape")
    args = ap.parse_args()
    dtypes = args.dtype.split(",")
    stores = args.store.split(",")
    shape_names = args.shapes.split(",")
    if (not set(dtypes) <= {"float32", "bfloat16"} or not set(stores) <= {"int8", "bfloat16"}
            or not set(shape_names) <= {"SBM", "shard"}):
        ap.error("--dtype, --store or --shapes names an unknown value")
    if args.f64 and "SBM" not in shape_names:
        ap.error("--f64 runs at the SBM shape")

    import torch

    if not torch.cuda.is_available():
        print("chip_sweep_flash: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import chip_smoke
    from plnlp_tpu_torch import _build
    from plnlp_tpu_torch.ops import flash_tiles as ft

    dev = torch.device("cuda")
    card = card_name()
    variants = [v for v in VARIANTS if v[0] == "source"
                or not args.variants or v[0] in args.variants.split(",")]
    baseline = open(args.baseline).read() if args.baseline else None
    source = open(args.source).read() if args.source else None
    libs = build_variants(_build.BUILD_DIR.parent / "sweep_flash", variants, baseline, source)
    for name, (_, report) in libs.items():
        print(f"[build] {name}: {path_report(report)}", flush=True)

    data = chip_smoke.hybrid_data(chip_smoke.N_NODES, chip_smoke.N_EDGES,
                                  chip_smoke.N_COMMUNITIES, args.seed, dev)
    hg = data["hg"]
    t, width = chip_smoke.TILE, chip_smoke.WIDTH
    scale = 1.0 / math.sqrt(width)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # each shape: (rows, rows_g, fwd set, bwd set, stats of the rows_g rows)
    shapes = {}
    if "SBM" in shape_names:
        n_pad = (hg.tile_rowptr.shape[0] - 1) * t
        shapes["SBM"] = (n_pad, n_pad, (hg.tile_vals, hg.tile_col, hg.tile_rowptr),
                         (hg.tile_vals_t, hg.tile_col_t, hg.tile_rowptr_t))
    if "shard" in shape_names:
        rps, tiles, tiles_t = shard_tiles(data, dev)
        shapes["shard"] = (rps, 4 * rps, (tiles["vals"], tiles["col"], tiles["rowptr"]),
                           (tiles_t["vals"], tiles_t["col"], tiles_t["rowptr"]))
    # the features at the gathered rows (the own rows are the first `rows`),
    # and the stats from the plain forward over each shape's own rows (K5's
    # stats of the gathered rows: the own rows' beside rows of (0, 1, 0)
    # stats for the rest of the buffer, whose rows no launch here owns)
    inputs = {}
    for sname, (rows, rows_g, fwd, bwd) in shapes.items():
        n_r = fwd[2].shape[0] - 1
        base = [torch.randn(rows_g, width, device=dev, generator=gen) for _ in range(4)]
        vals_r = fwd[0]
        # the plain forward takes (vals, tile_row, tile_col): tile_row from the
        # row pointer
        tile_row = torch.repeat_interleave(torch.arange(n_r, device=dev, dtype=torch.int32),
                                           fwd[2].diff().long())
        for dt in dtypes:
            q, k, v, g = (a.to(getattr(torch, dt)) for a in base)
            num_r, ml_r = ft.flash_tiles_fwd_reference(vals_r, tile_row, fwd[1], q[:rows], k, v,
                                                       n_r, scale)
            num_a, _ = ft.flash_tiles_fwd_reference(vals_r, tile_row, fwd[1], q[:rows], k,
                                                    v.abs(), n_r, scale)
            m = torch.where(torch.isfinite(ml_r[:, 0]), ml_r[:, 0], 0.0)
            den = ml_r[:, 1].clamp(min=torch.finfo(torch.float32).tiny)
            st = torch.stack([m, den, (g[:rows].float() * num_r / den[:, None]).sum(-1)], 1)
            stats = torch.cat([st, st.new_tensor([0.0, 1.0, 0.0]).expand(rows_g - rows, 3)])
            inputs[(sname, dt)] = (q, k, v, g, stats.contiguous(), num_r, ml_r, num_a)

    def caller(name, kind, sname, dt, store):
        lib = libs[name][0]
        bf16 = dt == "bfloat16"
        fn = getattr(lib, f"plnlp_flash_tiles_{kind}" + ("_bf16" if bf16 else ""))
        # a baseline from before the gathered-row count (rows_g, the fourth
        # argument from the end) takes one count
        split = name != "baseline" or "int rows_g" in baseline
        types = ft._ARGTYPES[kind]
        fn.argtypes = types if split else types[:-4] + types[-3:]
        fn.restype = ctypes.c_int
        rows, rows_g, fwd, bwd = shapes[sname]
        vals_k, tc, tp = fwd if kind != "dkv" else bwd
        vals_k = vals_k.to(getattr(torch, store))
        n_r = tp.shape[0] - 1
        q, k, v, g, stats = inputs[(sname, dt)][:5]
        f32 = dict(dtype=torch.float32, device=dev)
        if kind == "fwd":
            outs = [torch.empty((rows, width), **f32), torch.empty((rows, 2), **f32)]
            ptrs = [a.data_ptr() for a in (tc, tp, q, k, v, *outs)]
        elif kind == "dq":
            outs = [torch.empty((rows, width), **f32)]
            ptrs = [a.data_ptr() for a in (tc, tp, q, k, v, g, stats, *outs)]
        else:
            outs = [torch.empty((rows, width), **f32) for _ in range(2)]
            ptrs = [a.data_ptr() for a in (tc, tp, q, k, v, g, stats, *outs)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        counts = (rows, rows_g) if split else (rows,)

        def call():
            err = fn(vals_k.data_ptr(), ft._VALS_KIND[vals_k.dtype], *ptrs, n_r, t, *counts,
                     width, scale, stream)
            _build.check(lib, err, f"flash_tiles_{kind} sweep launch")
            return outs
        return call

    combos = [(sname, dt, store) for sname in shapes for dt in dtypes for store in stores]
    if baseline is not None and "int rows_g" not in baseline:
        combos = [c for c in combos if shapes[c[0]][0] == shapes[c[0]][1]]
    want = {(kind, *c): [o.clone() for o in caller("source", kind, *c)()]
            for kind in KINDS for c in combos}
    check = {name: ch for name, _, _, ch in variants}
    check["baseline"] = "bits"
    order = [name for name, *_ in variants] + ["source"]
    if baseline is not None:
        order = ["baseline", *order, "baseline"]
    for name in order:
        for sname, dt, store in combos:
            times, notes = [], []
            for kind in KINDS:
                call = caller(name, kind, sname, dt, store)
                got = call()
                torch.cuda.synchronize()
                if check[name] == "time" and kind in PARTS.get(name.split("-")[0], ("fwd",)):
                    notes.append(f"{LABELS[kind]} computes a part: timed, not checked")
                elif check[name] != "plain" or kind != "fwd":
                    chip_smoke.require(all(torch.equal(a, b) for a, b in
                                           zip(got, want[(kind, sname, dt, store)])),
                                       f"variant {name}: flash_tiles_{kind} differs from the "
                                       f"source ({sname}, {dt}, {store} tiles)")
                else:
                    num_r, ml_r, num_a = inputs[(sname, dt)][5:]
                    ratio, empty_ok, _ = chip_smoke.fwd_errors(
                        *got, num_r, ml_r, num_a,
                        chip_smoke.SUM_RTOL + (chip_smoke.BF16_RTOL if dt == "bfloat16" else 0.0))
                    chip_smoke.require(ratio <= 1.0 and empty_ok,
                                       f"variant {name}: flash_tiles_fwd disagrees with its "
                                       f"plain version (max err/tol {ratio:.3f})")
                    notes.append(f"K3 max err/tol {ratio:.3f} against the plain version")
                times.append(chip_smoke.cuda_ms(call, reps=10, runs=5))
            same = "; ".join(notes) or "same bits as the source"
            parts = ", ".join(f"{LABELS[kd]} {ms:.4f} ms" for kd, ms in zip(KINDS, times))
            print(f"[sweep] {name} ({sname}, {dt}, {store} tiles): {parts} ({same}); "
                  f"card {card}", flush=True)
    if args.f64:
        # the SBM's own int8 tiles; tile_row of each set from its row pointer
        _, _, fwd, bwd = shapes["SBM"]
        n_r = fwd[2].shape[0] - 1
        sets = {kind: (ts[0], torch.repeat_interleave(
                    torch.arange(n_r, device=dev, dtype=torch.int32), ts[2].diff().long()),
                    ts[1]) for kind, ts in (("dq", fwd), ("dkv", bwd))}
        for dt in dtypes:
            q, k, v, g, stats = inputs[("SBM", dt)][:5]
            sum_rtol = chip_smoke.SUM_RTOL + (chip_smoke.BF16_RTOL if dt == "bfloat16" else 0.0)
            for kind, name in (("dq", "dq"), ("dkv", "dv")):
                got = caller("source", kind, "SBM", dt, "int8")()[-1].clone()
                plain = (ft.flash_tiles_dq_reference(*sets[kind], q, k, v, g, stats, n_r, scale)
                         if kind == "dq" else
                         ft.flash_tiles_dkv_reference(*sets[kind], q, k, v, g, stats, n_r,
                                                      scale)[1])
                exact = f64_backward(*sets[kind], q, k, v, g, stats, n_r, scale, kind == "dkv")
                mags = chip_smoke.flash_bwd_magnitudes(*sets[kind], q, k, v, g, stats, scale,
                                                       kind == "dkv")[-1]
                tol = (chip_smoke.SUM_ATOL + sum_rtol * mags).double()
                errs = {who: (a.double() - exact).abs() for who, a in (("kernel", got),
                                                                          ("plain", plain))}
                _, ratio, _ = chip_smoke.sum_errors(got, plain, mags, sum_rtol=sum_rtol)
                parts = "; ".join(f"{who} max abs {float(e.max()):.4e} (max err/tol "
                                  f"{float((e / tol).max()):.4f})" for who, e in errs.items())
                print(f"[f64] {LABELS[kind]}{'-bf16' if dt == 'bfloat16' else ''} {name} (SBM, "
                      f"int8 tiles) against float64: {parts}; kernel against plain max err/tol "
                      f"{ratio:.4f} (tol {chip_smoke.SUM_ATOL} + {sum_rtol:.4g}*sum|terms|); "
                      f"card {card}", flush=True)
                del got, plain, exact, mags, tol, errs
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
