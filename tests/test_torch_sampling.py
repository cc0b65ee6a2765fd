"""plnlp_tpu_torch negative samplers (CPU).

``edges_exist`` must equal plnlp_tpu's membership test exactly.  The
samplers draw from a ``torch.Generator``, the JAX package from
``jax.random``, so they are held to the invariants both guarantee: shape,
no self-loops, no true edge while non-edges exist, uniform coverage, the
perm-copy structure and the local samplers' sources.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.graph as jgraph
from plnlp_tpu.sampling import degree_unigram_table as jax_unigram
from plnlp_tpu.sampling import edges_exist as jax_edges_exist
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch import sampling as ts


def _graphs(n=300, e=2500, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n // 3, e)  # skewed
    tg = tgraph.build_graph(src, dst, num_nodes=n, symmetrize=True, device="cpu")
    jg = jgraph.build_graph(src, dst, num_nodes=n, symmetrize=True)
    return tg, jg


def _is_edge(tg):
    s, r = tg.senders.numpy(), tg.receivers.numpy()
    return set(zip(s.tolist(), r.tolist()))


def test_edges_exist_matches_jax_exactly():
    tg, jg = _graphs()
    rng = np.random.default_rng(1)
    q_src = np.concatenate([rng.integers(0, 300, 5000), tg.senders.numpy()[:2000]])
    q_dst = np.concatenate([rng.integers(0, 300, 5000), tg.receivers.numpy()[:2000]])
    got = ts.edges_exist(tg, torch.from_numpy(q_src), torch.from_numpy(q_dst)).numpy()
    want = np.asarray(jax_edges_exist(jg, jnp.asarray(q_src, jnp.int32), jnp.asarray(q_dst, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    assert got[5000:].all() and 0 < got[:5000].sum() < 5000
    empty = tgraph.build_graph(np.zeros(0, int), np.zeros(0, int), num_nodes=5, device="cpu")
    assert not ts.edges_exist(empty, torch.tensor([0, 1]), torch.tensor([1, 2])).any()


@pytest.mark.parametrize("sampler", ["global", "global_perm"])
@pytest.mark.parametrize("num_neg", [1, 3])
def test_global_samplers_avoid_edges_and_self_loops(sampler, num_neg):
    tg, _ = _graphs()
    gen = torch.Generator().manual_seed(0)
    fn = ts.global_neg_sample if sampler == "global" else ts.global_perm_neg_sample
    neg = fn(gen, tg, 2000, num_neg)
    assert neg.shape == (2000, num_neg, 2) and neg.dtype == torch.int64
    flat = neg.reshape(-1, 2).numpy()
    assert (flat >= 0).all() and (flat < 300).all()
    assert (flat[:, 0] != flat[:, 1]).all()
    edges = _is_edge(tg)
    assert not any((int(s), int(d)) in edges for s, d in flat)
    # uniform draws reach most nodes on both sides
    assert len(np.unique(flat[:, 0])) > 250 and len(np.unique(flat[:, 1])) > 250
    if sampler == "global_perm" and num_neg > 1:
        # each appended copy re-shuffles the pool's own pairs
        chunks = neg.reshape(num_neg, 2000, 2)
        pool = sorted(map(tuple, chunks[0].tolist()))
        for j in range(1, num_neg):
            assert sorted(map(tuple, chunks[j].tolist())) == pool


def test_complete_graph_passes_candidates_through():
    # no non-edge exists: every candidate is bad, and the sampler still
    # returns the requested shape (the reference's undershoot fallback)
    n = 6
    s, d = np.meshgrid(np.arange(n), np.arange(n))
    tg = tgraph.build_graph(s.ravel(), d.ravel(), num_nodes=n, device="cpu")
    neg = ts.global_neg_sample(torch.Generator().manual_seed(0), tg, 50, 2)
    assert neg.shape == (50, 2, 2)


def test_sample_perm_copy_structure():
    pairs = torch.arange(20).reshape(10, 2)
    out = ts.sample_perm_copy(torch.Generator().manual_seed(0), pairs, 3)
    flat = out.reshape(-1, 2)
    assert torch.equal(flat[:10], pairs)
    for j in (1, 2):
        chunk = flat[10 * j: 10 * (j + 1)]
        assert sorted(chunk[:, 0].tolist()) == pairs[:, 0].tolist()
        assert torch.equal(chunk[:, 1], chunk[:, 0] + 1)  # src and dst permuted together


@pytest.mark.parametrize("random_src", [False, True])
def test_local_samplers_keep_positive_sources(random_src):
    tg, jg = _graphs()
    pos = torch.from_numpy(np.random.default_rng(2).integers(0, 300, (500, 2)))
    gen = torch.Generator().manual_seed(0)
    neg = ts.local_neg_sample(gen, pos, 300, 4, random_src=random_src)
    assert neg.shape == (500, 4, 2)
    src = neg[:, :, 0]
    assert (src == src[:, :1]).all()
    if random_src:
        assert ((src[:, 0] == pos[:, 0]) | (src[:, 0] == pos[:, 1])).all()
        assert (src[:, 0] == pos[:, 1]).any() and (src[:, 0] == pos[:, 0]).any()
    else:
        assert torch.equal(src[:, 0], pos[:, 0])
    assert ((neg[..., 1] >= 0) & (neg[..., 1] < 300)).all()

    table = ts.degree_unigram_table(tg, table_size=10_000)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jax_unigram(jg, table_size=10_000)))
    dist = ts.local_dist_neg_sample(gen, pos, table, 4, random_src=random_src)
    assert dist.shape == (500, 4, 2)
    assert np.isin(dist[..., 1].numpy(), table.numpy()).all()
