"""The generator: the same seed gives the same inputs, another seed others,
with the configuration's counts."""

import torch

from h100_bench import inputs
from h100_bench.tests import small


def _flat(x):
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    return [x] if isinstance(x, torch.Tensor) else []


def test_same_seed_same_inputs_other_seed_other_inputs():
    for name in ("collab-sage-dot.train", "citation2-gcn.train"):
        d = small.spec(name, small.SCALES[name])["config"]["dataset"]
        a, b = inputs.make(d, 2**31 + 5, "cpu"), inputs.make(d, 2**31 + 5, "cpu")
        c = inputs.make(d, 2**31 + 6, "cpu")
        fa, fb, fc = _flat(a), _flat(b), _flat(c)
        assert len(fa) == len(fb) == len(fc) > 3
        assert all(torch.equal(x, y) for x, y in zip(fa, fb))
        assert not all(torch.equal(x, y) for x, y in zip(fa, fc))


def test_counts_and_no_self_loops():
    d = small.spec("collab-sage-dot.train", 0.01)["config"]["dataset"]
    x = inputs.make(d, 3, "cpu")
    s = x["split_edge"]
    assert s["train"]["edge"].shape == (d["num_train"], 2)
    assert s["valid"]["edge"].shape == (d["num_valid"], 2)
    assert s["test"]["edge_neg"].shape == (d["num_neg_eval"], 2)
    assert bool((s["train"]["edge"][:, 0] != s["train"]["edge"][:, 1]).all())
    assert int(s["train"]["year"].min()) >= 2000 and int(s["train"]["year"].max()) <= 2019
    d = small.spec("citation2-gcn.train", 0.002)["config"]["dataset"]
    x = inputs.make(d, 3, "cpu")
    assert x["split_edge"]["valid"]["target_node_neg"].shape == (d["num_valid"], 20)
    assert x["node_feat"].shape == (d["num_nodes"], 128)


def test_weights_follow_the_seed():
    shapes = [("a", (5, 3)), ("b", (3,))]
    w1, w2 = inputs.weights(shapes, 9, "cpu"), inputs.weights(shapes, 9, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a"], inputs.weights(shapes, 10, "cpu")["a"])
    assert float(w1["a"].abs().max()) <= (6 / 8) ** 0.5
