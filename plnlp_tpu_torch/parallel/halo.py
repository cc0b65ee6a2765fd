"""Halo exchange: boundary-row communication for the partitioned SpMM
(port of plnlp_tpu/parallel/halo.py, host NumPy).

The all-gather body gathers every rank's rows per layer, whatever a shard
reads.  The plan built here sends only the rows read across shard
boundaries:

* Local/remote split: a shard's edges whose source it owns aggregate
  straight from its own rows (no communication, so the local K1 launch
  overlaps the exchange); the rest read the exchanged buffer.
* Hub replication: rows read by at least ``hub_k`` remote shards leave the
  per-peer sets and are gathered once through a small all_gather, so one
  hub read by every shard does not inflate every peer quota (the
  all_to_all needs one chunk size).
* Per-peer quota after hub removal: q = max unique non-hub boundary rows
  over (dst shard, owner shard) pairs; the halo buffer is (S·q, D), the
  hub buffer (S·qh, D), against the all-gather's (S·rows_per_shard, D).

Plan (per shard, unpadded blocks in the port's layout):

  send_idx[s, d, :]  local rows shard s sends to shard d   (padded to q)
  hub_idx[s, :]      local rows of s that are hubs          (padded to qh)
  buffer             concat([all_to_all halo (S·q), all_gather hubs (S·qh)])
  rem[d]             remote edges, sources remapped into the buffer
  loc[d]             local edges, sources as shard-local rows

The same plan is built for the backward structure.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from plnlp_tpu_torch.graph import _blocks_np

__all__ = ["build_halo_plan", "estimate_halo_quotas"]


def _csr_blocks(src_ids, dst_local, w, rows: int, R: int, B: int):
    """Blocked metadata for one shard's edge subset (src ids already in the
    target index space: local rows or buffer slots)."""
    from plnlp_tpu_torch.parallel.partition import _shard_csr

    return _blocks_np(_shard_csr(src_ids, dst_local, w, rows), R, B)


def _boundary_sets(
    blk_src: Sequence[np.ndarray],
    blk_weight: Sequence[np.ndarray],
    rows_per_shard: int,
    num_shards: int,
    hub_k: Optional[int] = None,
):
    """Hub rows and per-(dst, owner) unique non-hub boundary sets.

    Returns (hubs, hub_owner, qh, H, q): H[d][s] the sorted global non-hub
    rows shard d reads from owner s, q the per-peer quota, qh the per-owner
    hub quota.  Shared by ``build_halo_plan`` and ``estimate_halo_quotas``,
    so the comm='auto' decision never drifts from the built plan."""
    S = num_shards
    padded_nodes = S * rows_per_shard
    if hub_k is None:
        hub_k = max(3, S // 2 + 1)

    uniq_remote = []
    for d in range(S):
        src = blk_src[d][blk_weight[d] != 0].astype(np.int64)
        uniq_remote.append(np.unique(src[src // rows_per_shard != d]))

    # hubs: rows read remotely by >= hub_k shards
    readers = np.zeros(padded_nodes, np.int32)
    for rem in uniq_remote:
        readers[rem] += 1
    hubs = np.nonzero(readers >= hub_k)[0]
    hub_owner = hubs // rows_per_shard
    per_owner = np.bincount(hub_owner, minlength=S)
    qh = max(int(per_owner.max()) if len(hubs) else 0, 1)
    is_hub = np.zeros(padded_nodes, bool)
    is_hub[hubs] = True

    H: List[List[np.ndarray]] = []
    q = 1
    for d in range(S):
        rem = uniq_remote[d]
        rem = rem[~is_hub[rem]]
        bounds = np.searchsorted(rem // rows_per_shard, np.arange(S + 1))
        Hd = [rem[bounds[s] : bounds[s + 1]] for s in range(S)]
        H.append(Hd)
        q = max(q, max((len(h) for h in Hd), default=1))
    return hubs, hub_owner, qh, H, q


def estimate_halo_quotas(
    blk_src, blk_weight, rows_per_shard: int, num_shards: int, hub_k: Optional[int] = None
) -> Tuple[int, int]:
    """(q, qh) of one direction without building the plan."""
    _, _, qh, _, q = _boundary_sets(blk_src, blk_weight, rows_per_shard, num_shards, hub_k)
    return q, qh


def build_halo_plan(
    blk_src: Sequence[np.ndarray],  # per shard (nblk, B) int32, GLOBAL source slots
    blk_weight: Sequence[np.ndarray],  # per shard (nblk, B) f32, 0 = padding
    blk_local: Sequence[np.ndarray],  # per shard (nblk, B) int32
    blk_rowblock: Sequence[np.ndarray],  # per shard (nblk,) int32
    rows_per_shard: int,
    num_shards: int,
    R: int,
    B: int,
    hub_k: Optional[int] = None,
) -> Tuple[Dict[str, object], int, int]:
    """Returns (plan, q, qh); plan holds ``loc`` and ``rem`` (a block dict
    per shard), ``send_idx`` (S, S, q) and ``hub_idx`` (S, qh) int32."""
    S = num_shards
    padded_nodes = S * rows_per_shard
    edges = []
    for d in range(S):
        valid = blk_weight[d] != 0
        dst_local = blk_rowblock[d][:, None].astype(np.int64) * R + blk_local[d]
        edges.append((blk_src[d][valid].astype(np.int64), dst_local[valid], blk_weight[d][valid]))

    hubs, hub_owner, qh, H, q = _boundary_sets(blk_src, blk_weight, rows_per_shard, S, hub_k)
    hub_idx = np.zeros((S, qh), np.int32)
    hub_slot = np.full(padded_nodes, -1, np.int64)
    for s in range(S):
        hs = hubs[hub_owner == s]
        hub_idx[s, : len(hs)] = (hs - s * rows_per_shard).astype(np.int32)
        hub_slot[hs] = s * qh + np.arange(len(hs))
    is_hub = hub_slot >= 0

    send_idx = np.zeros((S, S, q), np.int32)
    loc, rem = [], []
    for d in range(S):
        slot_map = np.zeros(padded_nodes, np.int64)
        for s in range(S):
            rows = H[d][s]
            send_idx[s, d, : len(rows)] = (rows - s * rows_per_shard).astype(np.int32)
            slot_map[rows] = s * q + np.arange(len(rows))
        slot_map[is_hub] = S * q + hub_slot[is_hub]

        src, dst_local, w = edges[d]
        loc_sel = src // rows_per_shard == d
        loc.append(_csr_blocks(src[loc_sel] - d * rows_per_shard, dst_local[loc_sel],
                               w[loc_sel], rows_per_shard, R, B))
        rem_sel = ~loc_sel
        rem.append(_csr_blocks(slot_map[src[rem_sel]], dst_local[rem_sel], w[rem_sel],
                               rows_per_shard, R, B))
    plan = {"loc": tuple(loc), "rem": tuple(rem), "send_idx": send_idx, "hub_idx": hub_idx}
    return plan, q, qh
