"""plnlp_tpu_torch host graph prep and data against plnlp_tpu (CPU).

The port drops two TPU layout artefacts: COO edge padding and
``_align_blocks``' trailing all-padding sub-block.  So CSR arrays compare
over the real edges and blocked arrays over the port's sub-blocks, with any
extra JAX sub-block required to be all padding.  Everything else is exact.
"""

import numpy as np
import pytest

import plnlp_tpu.graph as jgraph
from plnlp_tpu.data.synthetic import make_synthetic_dataset as jax_make_dataset
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.data.synthetic import make_synthetic_dataset
from tests.conftest import random_graph_np

CASES = [
    # n, e, R, B, symmetrize, weighted
    (70, 500, 16, 32, False, True),
    (90, 400, 16, 32, True, False),
    (48, 4, 16, 32, False, False),  # holes: empty row-blocks
    (130, 900, 64, 128, True, True),
]


def _check_blocks(tg, jg):
    nblk = tg.blk_src.shape[0]
    for name in ("blk_src", "blk_weight", "blk_local", "blk_rowblock"):
        np.testing.assert_array_equal(
            getattr(tg, name).numpy(), np.asarray(getattr(jg, name))[:nblk], err_msg=name
        )
    np.testing.assert_array_equal(np.asarray(jg.blk_weight)[nblk:], 0.0)
    assert (tg.block_rows, tg.block_edges) == (jg.block_rows, jg.block_edges)
    # blk_rowptr: first sub-block of each row-block, consistent with the
    # per-sub-block row-block ids; every row-block has >= 1 sub-block
    rowptr = tg.blk_rowptr.numpy()
    n_rb = -(-tg.num_nodes // tg.block_rows)
    assert rowptr.shape == (n_rb + 1,) and rowptr[0] == 0 and rowptr[-1] == nblk
    assert (np.diff(rowptr) >= 1).all()
    np.testing.assert_array_equal(
        np.repeat(np.arange(n_rb), np.diff(rowptr)), tg.blk_rowblock.numpy()
    )


def _check_csr(tg, jg):
    e = jg.num_edges
    assert (tg.num_nodes, tg.num_edges, tg.max_degree) == (
        jg.num_nodes, e, jg.max_degree
    )
    for name in ("senders", "receivers", "edge_weight"):
        got = getattr(tg, name).numpy()
        assert got.shape == (e,)
        np.testing.assert_allclose(
            got, np.asarray(getattr(jg, name))[:e], rtol=1e-6, err_msg=name
        )
    np.testing.assert_array_equal(tg.indptr.numpy(), np.asarray(jg.indptr))


@pytest.mark.parametrize("n,e,R,B,sym,weighted", CASES)
def test_prepare_graph_matches_jax(rng, n, e, R, B, sym, weighted):
    src, dst, w = random_graph_np(rng, n, e, weighted=weighted)
    if e == 4:
        src, dst = np.array([0, 1, 2, 40]), np.array([3, 3, 40, 41])
    tg, tgt = tgraph.prepare_graph(
        src, dst, w, num_nodes=n, symmetrize=sym, block=(R, B), device="cpu"
    )
    jg, jgt = jgraph.prepare_graph(src, dst, w, num_nodes=n, symmetrize=sym, block=(R, B))
    for t, j in ((tg, jg), (tgt, jgt)):
        _check_csr(t, j)
        _check_blocks(t, j)


def test_build_graph_and_with_blocks_match_jax(rng):
    src, dst, w = random_graph_np(rng, 60, 300, weighted=True)
    tg = tgraph.build_graph(src, dst, w, num_nodes=60, device="cpu")
    jg = jgraph.build_graph(src, dst, w, num_nodes=60)
    _check_csr(tg, jg)
    assert tg.blk_src is None
    _check_blocks(tgraph.with_blocks(tg, 16, 32), jgraph.with_blocks(jg, 16, 32))
    _check_blocks(
        tgraph.build_graph(src, dst, w, num_nodes=60, block=(16, 32), device="cpu"),
        jgraph.build_graph(src, dst, w, num_nodes=60, block=(16, 32)),
    )


@pytest.mark.parametrize(
    "fn,kw",
    [
        ("coalesce_edges", {"reduce": "add"}),
        ("coalesce_edges", {"reduce": "mean"}),
        ("coalesce_edges", {"reduce": "max"}),
        ("coalesce_edges", {"reduce": "min"}),
        ("to_undirected_edges", {}),
        ("add_self_loop_edges", {"fill_value": 2.0}),
        ("gcn_normalize_edges", {}),
        ("row_normalize_edges", {}),
    ],
)
def test_edge_transforms_match_jax(rng, fn, kw):
    src, dst, w = random_graph_np(rng, 50, 300, weighted=True)
    got = getattr(tgraph, fn)(src, dst, w, 50, **kw)
    want = getattr(jgraph, fn)(src, dst, w, 50, **kw)
    for g, j in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(j), rtol=1e-6)


def test_graph_to_moves_every_tensor(rng):
    src, dst, _ = random_graph_np(rng, 40, 200)
    g, _ = tgraph.prepare_graph(src, dst, num_nodes=40, block=(16, 32), device="cpu")
    moved = g.to("meta")
    assert moved.device.type == "meta" and moved.blk_rowptr.device.type == "meta"
    assert moved.num_edges == g.num_edges


@pytest.mark.parametrize("kind", ["hits", "mrr", "hits-sbm"])
def test_synthetic_dataset_byte_identical(kind):
    kw = dict(num_nodes=300, num_edges=2000, seed=3, weighted=True, with_year=True)
    got, want = make_synthetic_dataset(kind, **kw), jax_make_dataset(kind, **kw)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        return {prefix: tree}

    fg, fw = flat(got), flat(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        if isinstance(fw[k], np.ndarray):
            assert fg[k].dtype == fw[k].dtype and fg[k].tobytes() == fw[k].tobytes(), k
        else:
            assert fg[k] == fw[k], k
