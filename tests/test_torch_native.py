"""plnlp_tpu_torch's native host library (csrc/graphcore.cpp) against the
port's NumPy plain versions, bit for bit (mirrors tests/test_native.py).

Every function is held to its plain version with ``np.array_equal`` on the
raw bits (float32 arrays viewed as uint32), at small sizes with duplicate
edges, self loops, isolated nodes and disconnected components.  The
label-prop order, native and NumPy, is also held to the JAX package's
``label_prop_order``; a ``build_graph``, ``prepare_dense`` and
``estimate_hybrid`` through the native path equal the same calls through
NumPy field for field.
"""

import numpy as np
import pytest

from plnlp_tpu.ops.tile_spmm import label_prop_order as jax_label_prop_order
from plnlp_tpu_torch import dense, native
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.ops import tile_spmm as ts
from plnlp_tpu_torch.parallel import partition as tpart
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)


def _edges(seed, n, e, weighted=True):
    r = np.random.default_rng(seed)
    src, dst = r.integers(0, n, e), r.integers(0, n, e)
    w = (r.random(e) + 0.1).astype(np.float32) if weighted else None
    return src, dst, w


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bits(got, want, what=""):
    assert got is None and want is None or np.asarray(got).dtype == np.asarray(want).dtype, what
    if got is not None:
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def test_native_library_builds_and_runs():
    assert native.available()
    assert native.get_lib() is native.get_lib()


@pytest.mark.parametrize("weights", ["f32", "f64", "none", "signed_zero"])
def test_coalesce_add_matches_plain(weights):
    src, dst, w = _edges(1, 50, 400)
    if weights == "f64":
        w = w.astype(np.float64) / 3.0  # float64 input: summed as given
    elif weights == "none":
        w = None
    elif weights == "signed_zero":
        w[:20] = -0.0
    got = native.coalesce_add(src, dst, w, 50)
    want = tgraph._coalesce_plain(src, dst, w, 50)
    for k, (a, b) in enumerate(zip(got, want)):
        _assert_bits(a, b, f"field {k}")
    assert len(got[0]) < 400  # duplicates merged


def test_build_indptr_matches_numpy():
    dst = np.sort(np.random.default_rng(2).integers(0, 20, 100))
    want = np.zeros(21, np.int64)
    want[1:] = np.cumsum(np.bincount(dst, minlength=20))
    np.testing.assert_array_equal(native.build_indptr(dst, 20), want)


def test_densify_matches_plain():
    for coalesce in (True, False):  # without coalescing a cell sums duplicates
        csr = tgraph._csr_np(*_edges(3, 30, 300), 30, False, coalesce)
        got = native.densify(csr["senders"], csr["receivers"], csr["edge_weight"], 30)
        want = dense._dense_plain(csr)
        for a, b in zip(got, want):
            _assert_bits(a, b, f"coalesce={coalesce}")
    with pytest.raises(ValueError, match="sorted"):
        native.densify(np.array([0, 1]), np.array([1, 0]), np.ones(2, np.float32), 2)


@pytest.mark.parametrize("n,e,R,B", [(64, 300, 8, 32), (100, 1000, 16, 64), (33, 7, 8, 16), (10, 0, 4, 8)])
def test_blocks_build_matches_plain(n, e, R, B):
    csr = tgraph._csr_np(*_edges(4, n, e), n, False, True)
    got = native.blocks_build(csr["senders"], csr["receivers"], csr["edge_weight"],
                              csr["indptr"], n, R, B)
    want = tgraph._blocks_plain(csr, R, B)
    assert set(got) == set(want)
    for k in want:
        _assert_bits(got[k], want[k], k)


def test_label_prop_matches_plain_and_jax():
    for seed in range(4):
        r = np.random.default_rng(100 + seed)
        n = int(r.integers(20, 200))
        e = int(r.integers(n, 6 * n))
        src, dst, _ = _edges(200 + seed, n, e, weighted=False)
        indptr, indices = tgraph._undirected_csr_np(src, dst, n)
        labels = native.label_prop(indptr, indices, n, 20)
        np.testing.assert_array_equal(labels, ts._label_prop_plain(src, dst, n, 20))
        order = ts.label_prop_order(src, dst, n)  # native dispatch
        np.testing.assert_array_equal(order, np.argsort(labels, kind="stable"))
        np.testing.assert_array_equal(order, jax_label_prop_order(src, dst, n), err_msg=str(seed))


def test_bfs_order_matches_plain():
    for seed in range(4):
        r = np.random.default_rng(300 + seed)
        n = int(r.integers(20, 200))
        src, dst, _ = _edges(seed, n, int(r.integers(n // 2, 5 * n)), weighted=False)
        indptr, d2 = tgraph._undirected_csr_np(src, dst, n)
        seeds = np.argsort(-np.diff(indptr), kind="stable")
        got = native.bfs_order(indptr, d2, n, seeds)
        np.testing.assert_array_equal(got, tpart._bfs_order_plain(indptr, d2, n, seeds))
        np.testing.assert_array_equal(tpart._bfs_order(src, dst, n), got)
        assert np.array_equal(np.sort(got), np.arange(n))  # a permutation


def test_builds_through_native_equal_numpy(monkeypatch):
    """build_graph (coalesce + blocks), prepare_dense (densify) and
    estimate_hybrid (label-prop) give the same arrays either way."""
    src, dst, w = _edges(5, 64, 500)
    sbm_src, sbm_dst, _ = _edges(6, 300, 2000, weighted=False)

    def run():
        g = tgraph.build_graph(src, dst, w, num_nodes=64, block=(8, 32), device="cpu")
        d = dense.prepare_dense(src, dst, w, num_nodes=64, device="cpu")
        est = ts.estimate_hybrid(sbm_src, sbm_dst, num_nodes=300, tile=32, min_fill=4)
        return g, d, est

    g1, d1, e1 = run()
    monkeypatch.setattr(native, "available", lambda: False)
    g2, d2, e2 = run()
    for f in ("senders", "receivers", "edge_weight", "indptr", "blk_src", "blk_weight",
              "blk_local", "blk_rowblock", "blk_rowptr"):
        _assert_bits(getattr(g1, f).numpy(), getattr(g2, f).numpy(), f)
    assert (g1.num_edges, g1.max_degree) == (g2.num_edges, g2.max_degree)
    _assert_bits(d1.adj.numpy(), d2.adj.numpy(), "adj")
    _assert_bits(d1.in_degrees.numpy(), d2.in_degrees.numpy(), "in_degrees")
    np.testing.assert_array_equal(e1["order"], e2["order"])
    assert (e1["coverage"], e1["num_tiles"]) == (e2["coverage"], e2["num_tiles"])


def test_missing_compiler_warns_once_and_falls_back(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.warns(UserWarning, match="g[+][+] not found"):
        assert not native.available()
    assert not native.available()  # decided once, no second warning
    with pytest.raises(RuntimeError, match="not available"):
        native.coalesce_add(np.zeros(1), np.zeros(1), None, 1)
    # the callers run the plain versions
    src, dst, w = _edges(7, 20, 60)
    for a, b in zip(tgraph.coalesce_edges(src, dst, w, 20), tgraph._coalesce_plain(src, dst, w, 20)):
        _assert_bits(a, b)


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "graphcore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g[+][+] failed"):
        native._build(native.shutil.which("g++"))
    assert native.available()
