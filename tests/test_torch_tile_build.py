"""plnlp_tpu_torch's host build of the hybrid dense-tile operand against
plnlp_tpu (CPU): ``build_hybrid``, ``estimate_hybrid`` and the label-prop
orders give the same arrays as the JAX package's, exactly.  The tile
kernel's plain version and ``hybrid_spmm`` are in
tests/test_torch_tile_spmm.py.
"""

import numpy as np
import pytest
import torch

import plnlp_tpu.ops.tile_spmm as jts
from plnlp_tpu_torch.ops import tile_spmm as tts
from tests.test_torch_tile_spmm import CASES, N, _np, _pair, _sbm
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)


def _same_graph(tg, jg):
    e = jg.num_edges
    assert tg.num_edges == e and tg.num_nodes == jg.num_nodes
    for k in ("senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(_np(getattr(tg, k)), _np(getattr(jg, k))[:e])
    np.testing.assert_array_equal(_np(tg.indptr), _np(jg.indptr))
    # the JAX blocks may end in one all-padding sub-block (a TPU gather
    # alignment the port leaves out)
    nblk = tg.blk_src.shape[0]
    assert tg.block_rows == jg.block_rows and tg.block_edges == jg.block_edges == 128
    for k in ("blk_src", "blk_weight", "blk_local", "blk_rowblock"):
        np.testing.assert_array_equal(_np(getattr(tg, k)), _np(getattr(jg, k))[:nblk])
    assert not np.asarray(jg.blk_weight)[nblk:].any()
    np.testing.assert_array_equal(
        np.repeat(np.arange(len(tg.blk_rowptr) - 1), np.diff(_np(tg.blk_rowptr))),
        _np(tg.blk_rowblock),
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_hybrid_matches_jax(case):
    th, jh = _pair(case)
    for k in ("num_nodes", "tile", "num_tiles", "dense_edges", "res_edges", "reorder"):
        assert getattr(th, k) == getattr(jh, k), k
    assert th.tile_vals.dtype == {np.dtype(np.int8): torch.int8,
                                  np.dtype(np.float32): torch.float32}[jh.tile_vals.dtype]
    for k in ("tile_vals", "tile_row", "tile_col", "tile_vals_t", "tile_row_t", "tile_col_t",
              "in_degrees", "perm_in", "perm_out"):
        a, b = _np(getattr(th, k)), _np(getattr(jh, k))
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    n_r = -(-N // th.tile)
    for rows, ptr, mask in ((th.tile_row, th.tile_rowptr, jh.row_mask),
                            (th.tile_row_t, th.tile_rowptr_t, jh.row_mask_t)):
        counts = np.diff(_np(ptr))
        np.testing.assert_array_equal(np.bincount(_np(rows), minlength=n_r), counts)
        # the JAX row mask (None when every row tile is covered) is the
        # port's non-empty tile_rowptr ranges
        covered = counts > 0
        np.testing.assert_array_equal(covered, np.ones(n_r, bool) if mask is None else _np(mask))
        assert (mask is None) == bool(covered.all())
    assert (th.res_graph is None) == (jh.res_graph is None)
    if th.res_graph is not None:
        _same_graph(th.res_graph, jh.res_graph)
        _same_graph(th.res_graph_t, jh.res_graph_t)
    if case == "no_tiles":
        assert th.num_tiles == 1 and th.dense_edges == 0 and not th.tile_vals.any()
    if case == "budget":
        assert th.num_tiles == 5
    if case == "relabeled":
        assert th.tile_vals.dtype == torch.float32 and th.perm_in is None


def test_estimate_and_orders_match_jax():
    src, dst, _ = _sbm()
    for mode in ("labelprop", "multilevel", "none"):
        kw = dict(num_nodes=N, tile=32, min_fill=12, symmetrize=True, reorder=mode)
        got, want = tts.estimate_hybrid(src, dst, **kw), jts.estimate_hybrid(src, dst, **kw)
        for k in ("coverage", "num_tiles", "num_edges"):
            assert got[k] == want[k], (mode, k)
        np.testing.assert_array_equal(_np(got["order"]), _np(want["order"]))
    # the port's NumPy sweep against the JAX package's (native) one
    np.testing.assert_array_equal(
        tts.label_prop_order(src, dst, N), jts.label_prop_order(src, dst, N)
    )
    np.testing.assert_array_equal(
        tts.multilevel_order(src, dst, N), jts.multilevel_order(src, dst, N)
    )
    counts = tts.tile_stats(src, dst, N, tile=32)
    np.testing.assert_array_equal(counts, jts.tile_stats(src, dst, N, tile=32))
