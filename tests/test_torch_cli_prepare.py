"""plnlp_tpu_torch's CLI set-up against plnlp_tpu's (CPU), without a run.

* The flag surface: every field of ``argument([])`` and of the reference
  README commands is equal in both packages.
* Dataset surgery, the train and eval edges (hits and mrr layouts) and the
  hybrid id-space relabel are equal array for array.
* ``prepare_experiment`` chooses the backend the JAX CLI chooses: dense,
  auto -> hybrid on a community graph, auto -> csr, serving -> csr; over
  csr the TRANSFORMER operand carries ``tconv_map`` as the JAX one does.

The runs are in tests/test_torch_cli.py.
"""

import contextlib
import io

import numpy as np
import pytest

import plnlp_tpu.cli as jcli
from plnlp_tpu.data import load_dataset as jax_load_dataset
from plnlp_tpu_torch import cli
from plnlp_tpu_torch.data import load_dataset
from plnlp_tpu_torch.dense import DenseAdj
from plnlp_tpu_torch.graph import Graph
from plnlp_tpu_torch.ops.tile_spmm import HybridGraph
from tests.test_cli import README_COMMANDS
from tests.test_torch_cli import SBM, TILES, _args, _assert_tree_equal
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)


def test_flag_surface_matches_jax():
    assert vars(cli.argument([])) == vars(jcli.argument([]))
    for config, flags in README_COMMANDS.items():
        argv = ["--data_name=ogbl-collab"] + flags.split()
        assert vars(cli.argument(argv)) == vars(jcli.argument(argv)), config
    extras = ["--prng_impl", "threefry2x32", "--resume", "--remat", "--reset_optimizer",
              "--adj_backend", "hybrid", "--tile_reorder", "multilevel"]
    assert vars(cli.argument(extras)) == vars(jcli.argument(extras))
    for bad in (["--adj_backend", "sparse"], ["--compute_dtype", "f16"]):
        with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
            cli.argument(bad)


@pytest.mark.parametrize("encoder", ["SAGE", "GCN", "WSAGE", "TRANSFORMER"])
def test_surgery_and_edges_match_jax(encoder):
    name = "synthetic:hits:num_nodes=300,num_edges=3000,weighted=1,with_year=1"
    ds = load_dataset(name)
    _assert_tree_equal(ds["split_edge"], jax_load_dataset(name)["split_edge"])
    for kw in (dict(year=2010, use_valedges_as_input=True, use_coalesce=True),
               dict(year=2010), dict(data_name="ogbl-ddi", year=2010)):
        args = _args(**dict(dict(data_name=name, encoder=encoder), **kw))
        got = cli.apply_dataset_surgery(ds, args)
        _assert_tree_equal(got, jcli.apply_dataset_surgery(ds, args))
        for a, b in zip(cli.get_train_edges(got["split_edge"]),
                        jcli.get_train_edges(got["split_edge"])):
            _assert_tree_equal(a, b)
        for split in ("valid", "test"):
            _assert_tree_equal(cli.get_eval_edges(got["split_edge"], split),
                               jcli.get_eval_edges(got["split_edge"], split))
        relabel = np.random.default_rng(0).permutation(300)
        _assert_tree_equal(cli._relabel_split_edge(got["split_edge"], relabel),
                           jcli._relabel_split_edge(got["split_edge"], relabel))
    mrr = load_dataset("synthetic:mrr:num_nodes=200,num_edges=1500,neg_per_source=7")
    args = _args(data_name="synthetic:mrr", encoder=encoder)
    got = cli.apply_dataset_surgery(mrr, args)
    _assert_tree_equal(got, jcli.apply_dataset_surgery(mrr, args))
    ev = cli.get_eval_edges(got["split_edge"], "valid")
    _assert_tree_equal(ev, jcli.get_eval_edges(got["split_edge"], "valid"))
    assert ev["neg"].shape == (7 * len(ev["pos"]), 2)
    relabel = np.random.default_rng(1).permutation(200)
    _assert_tree_equal(cli._relabel_split_edge(got["split_edge"], relabel),
                       jcli._relabel_split_edge(got["split_edge"], relabel))


@pytest.mark.parametrize("case,kw,serving,want", [
    ("dense", dict(dense_threshold=5000), False, DenseAdj),
    ("auto->hybrid", dict(data_name=SBM, **TILES), False, HybridGraph),
    ("auto->csr", dict(data_name=SBM, tile_auto_coverage=1.5, **TILES), False, Graph),
    ("serving auto->csr", dict(data_name=SBM, **TILES), True, Graph),
])
def test_backend_choice_matches_jax(case, kw, serving, want):
    args = _args(**kw)
    lines, jlines = [], []
    got = cli.prepare_experiment(args, log=lines.append, serving=serving, device="cpu")
    ref = jcli.prepare_experiment(args, log=jlines.append, serving=serving)
    assert isinstance(got["graph"], want)
    assert type(got["graph"]).__name__ == type(ref["graph"]).__name__
    decision = [line for line in lines if "auto backend" in line]
    assert decision == [line for line in jlines if "auto backend" in line]
    if want is HybridGraph:
        assert "-> hybrid" in decision[0]
        np.testing.assert_array_equal(got["node_relabel"], ref["node_relabel"])
        assert got["graph"].perm_in is None and isinstance(got["sample_graph"], Graph)


@pytest.mark.parametrize("encoder", ["TRANSFORMER", "SAGE"])
def test_prepare_experiment_couples_the_transpose_for_transformer(encoder):
    """Over csr the TRANSFORMER operand carries tconv_map, as the JAX
    CLI's does, so the encoder takes the blocked hand VJP; other encoders'
    do not."""
    args = _args(encoder=encoder, adj_backend="csr", block_rows=64, block_edges=64)
    got = cli.prepare_experiment(args, log=lambda *_: None, device="cpu")
    ref = jcli.prepare_experiment(args, log=lambda *_: None)
    assert (got["graph"].tconv_map is not None) == (encoder == "TRANSFORMER")
    assert (ref["graph"].tconv_map is not None) == (encoder == "TRANSFORMER")
    if encoder == "TRANSFORMER":
        assert got["graph"].tconv_map.shape == got["graph_t"].blk_src.shape
