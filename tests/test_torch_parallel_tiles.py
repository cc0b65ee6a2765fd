"""The tiled partition and the partitioned TransformerConv of
plnlp_tpu_torch.parallel on the CPU, against the JAX package (mirrors the
tiled and TransformerConv cases of tests/test_graph_parallel.py).

One module-scoped fixture spawns gloo process groups of 2 and 4 ranks at
once; rank 0 writes its arrays to a file the test process reads.  Each
process group has a 60 s timeout and the spawn a wall-clock limit.  The
JAX side runs only host builds and single-device functions (its own tests
hold its mesh functions to those).

* The tiled partition's metadata equals JAX's ``partition_graph(tile=16,
  min_fill=3, block=(8, 32))`` per shard with JAX's padding tiles and row
  masks stripped (S = 2, 4; weighted: float32 tiles, unweighted: int8).
* ``partitioned_spmm`` over the tiled partition, sum and mean, values and
  input gradients at S = 2 and 4, against JAX's ``spmm_segment`` on the
  whole graph within 1e-4 |y| + 1e-5: min_fill 3, 1 (everything tiled)
  and 10**9 (everything residual), an unweighted graph (int8 tiles), and
  bfloat16 (x and the tile store) against the f32 function of the
  bf16-rounded inputs within 1e-5 + 2**-6 sum|terms| (the f32 sums'
  tolerance, the output's bf16 rounding, and the mean scale's); S = 1
  still runs labelprop; comm='halo' and ``with_halo`` raise.
* ``partitioned_transformer_conv`` at S = 2 and 4, reorders edges and bfs,
  over all_gather and a halo operand, on a graph with rows of no in-edge,
  of one in-edge, self loops and duplicate edges: values (1e-5), input
  gradients and the four linears' gradients summed over the ranks (rtol
  1e-4, atol 1e-5) against the JAX package's single-device TRANSFORMER
  layer (``models.encoders._transformer_conv`` over a JAX ``Graph``).
* The same layer over the tiled partition (``parallel/tile_transformer.py``:
  K3-K5's plain versions on each shard with its own and the gathered row
  counts, K1 on its residual) at S = 2 and 4, min_fill 3, 1 (no residual)
  and 10**9 (no tile on any shard), on that graph with its duplicates
  coalesced (a tile holds an edge once) and rows in row tiles no tile
  covers, to the same tolerances.
* One train step (DOT + AUC, Adam, dropout 0) at (data, node) = (1, 2),
  SAGE and TRANSFORMER over the tiled partition and TRANSFORMER over the
  blocked one, against the port's own single-device step on the same graph and
  parameters: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5,
  parameters rtol 1e-4 / atol 1e-6, except TRANSFORMER's key bias: its
  gradient is exactly 0 (the softmax cancels q_i . b_k), both sides hold
  rounding residue within the gradients' atol, and Adam turns residue into
  steps of up to lr, so its parameters are held within 2 lr.
* The CLI at ``--num_shards 2`` for one epoch, ``--adj_backend hybrid``
  (SAGE), ``--encoder TRANSFORMER --adj_backend csr`` and ``--encoder
  TRANSFORMER --adj_backend hybrid``, against the port's single-device
  CLI: epoch loss within rtol 1e-5.
* The launches a pass (1 K2 and 1 K1 over tiles; TransformerConv 1 K1
  forward, 3 backward over blocks; over tiles K3 1 and K1 1 forward, K4 1,
  K5 1 and K1 3 backward).
"""

import contextlib
import copy
import io
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)
from tests.torch_ranks import spawn

N, D = 100, 16  # the tiled SpMM graph (tests/test_graph_parallel.py's setup)
TILE, MIN_FILL, BLOCK = 16, 3, (8, 32)
SPMM_VARIANTS = {  # name: (weighted, min_fill, dtype)
    "w3": (True, MIN_FILL, "float32"),
    "w1": (True, 1, "float32"),
    "wbig": (True, 10**9, "float32"),
    "u3": (False, MIN_FILL, "float32"),
    "bf16": (True, MIN_FILL, "bfloat16"),
}
TCONV_CASES = [(c, r) for c in ("all_gather", "halo") for r in ("edges", "bfs")]
TILED_MIN_FILLS = (MIN_FILL, 1, 10**9)
NS, ES, B, LR = 64, 400, 64, 1e-2  # the train step
CLI_DATA = "synthetic:hits:num_nodes=300,num_edges=3000"
CLI_FLAGS = {
    "hybrid": dict(adj_backend="hybrid", tile_size=16, tile_min_fill=3, block_rows=16,
                   block_edges=32),
    "transformer": dict(encoder="TRANSFORMER", adj_backend="csr", block_rows=16,
                        block_edges=32),
    "transformer-hybrid": dict(encoder="TRANSFORMER", adj_backend="hybrid", tile_size=16,
                               tile_min_fill=3, block_rows=16, block_edges=32),
}


def _spmm_graph(weighted, seed=0):
    """N nodes, ~600 distinct edges (no duplicates: the bf16 reference
    rounds each edge's weight), and x, a cotangent."""
    r = np.random.default_rng(seed)
    key = np.unique(r.integers(0, N * N, 700))[:600]
    r.shuffle(key)
    src, dst = key % N, key // N
    w = (r.random(len(key)) + 0.1).astype(np.float32) if weighted else None
    return (src, dst, w, r.standard_normal((N, D)).astype(np.float32),
            r.standard_normal((N, D)).astype(np.float32))


def _tconv_graph():
    """96 nodes: rows 0..59 ~8 in-edges, 60..79 one, 80..95 none; self
    loops and duplicate edges kept (no coalesce)."""
    r = np.random.default_rng(5)
    n = 96
    src = np.concatenate([r.integers(0, n, 480), r.integers(0, n, 20), np.arange(10)])
    dst = np.concatenate([r.integers(0, 60, 480), np.arange(60, 80), np.arange(10)])
    src, dst = np.concatenate([src, src[:30]]), np.concatenate([dst, dst[:30]])
    return (n, src, dst, r.standard_normal((n, D)).astype(np.float32),
            r.standard_normal((n, D)).astype(np.float32))


def _step_data():
    r = np.random.default_rng(0)
    src, dst = r.integers(0, NS, ES), r.integers(0, NS, ES)
    pos = np.stack([src[:B], dst[:B]], 1).astype(np.int64)
    neg = np.random.default_rng(1).integers(0, NS, (B, 1, 2)).astype(np.int64)
    return src, dst, pos, neg


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _cli_argv(tmp, tag, **kw):
    flags = dict(data_name=CLI_DATA, epochs=1, eval_steps=1, runs=1, batch_size=512,
                 emb_hidden_channels=8, gnn_hidden_channels=8, mlp_hidden_channels=8,
                 predictor="DOT", metrics_file=os.path.join(tmp, tag, "metrics.jsonl"))
    flags.update(kw)
    return [f"--{k}={v}" for k, v in flags.items()]


def _run_cli(argv):
    """The CLI on the CPU; its log lines."""
    from plnlp_tpu_torch import cli

    lines = []
    with contextlib.redirect_stdout(io.StringIO()):
        cli.run_experiment(cli.argument(argv), log=lambda m: lines.append(str(m)), device="cpu")
    return lines


def _epoch_loss(tmp, tag):
    with open(os.path.join(tmp, tag, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1  # rank 0 alone writes metrics
    return json.loads(lines[0])["loss"]


# --- the ranks' side (no JAX here: the spawned processes import this module) --


def _tiled_spmm_cases(world):
    from plnlp_tpu_torch.parallel import (
        gather_node_features, make_graph_parallel, make_mesh, partitioned_spmm,
        shard_node_features,
    )

    mesh = make_mesh(1, world)
    out = {}
    for name, (weighted, min_fill, dtype) in SPMM_VARIANTS.items():
        src, dst, w, x, cot = _spmm_graph(weighted)
        dt = getattr(torch, dtype)
        gp = make_graph_parallel(src, dst, w, num_nodes=N, mesh=mesh, block=BLOCK, tile=TILE,
                                 min_fill=min_fill, tile_dtype=dtype)
        for reduce in ("sum", "mean"):
            xl = shard_node_features(torch.from_numpy(x).to(dt), gp).requires_grad_(True)
            yl = partitioned_spmm(gp, xl, reduce)
            assert yl.dtype == dt
            (yl * shard_node_features(torch.from_numpy(cot).to(dt), gp)).sum().backward()
            out[(name, reduce)] = tuple(
                gather_node_features(v, gp).float().numpy() for v in (yl.detach(), xl.grad))
        out[name] = {"comm": gp.comm, "reorder": gp.pg.reorder,
                     "dense_edges": gp.pg.tile_dense_edges, "store": gp.tiles["vals"].dtype}
    return out


def _tconv_layer(layer):
    from plnlp_tpu_torch.convert import _load
    from plnlp_tpu_torch.models import Encoder

    enc = Encoder(torch.Generator().manual_seed(0), "TRANSFORMER", D, D, 1)
    with torch.no_grad():
        _load(enc, {"layers": [layer]}, "encoder", set())
    return enc.layers[0]


def _tconv_run(lp, gp, x, cot):
    """One layer over ``gp`` and its backward: values, the input gradient
    (in node order) and the linears' gradients summed over the ranks."""
    from plnlp_tpu_torch.models.encoders import _transformer_conv
    from plnlp_tpu_torch.parallel import gather_node_features, shard_node_features

    lp.zero_grad()
    xl = shard_node_features(torch.from_numpy(x), gp).requires_grad_(True)
    yl = _transformer_conv(lp, gp, None, xl)
    (yl * shard_node_features(torch.from_numpy(cot), gp)).sum().backward()
    grads = {}
    for name, p in lp.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)  # each rank's partial sums
        grads[name] = g.t().numpy() if name.endswith("weight") else g.numpy()
    return (gather_node_features(yl.detach(), gp).numpy(),
            gather_node_features(xl.grad, gp).numpy(), grads)


def _tconv_cases(world, layer):
    from plnlp_tpu_torch.parallel import make_mesh, partition_graph
    from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel
    from plnlp_tpu_torch.parallel.partition import with_halo

    n, src, dst, x, cot = _tconv_graph()
    mesh = make_mesh(1, world)
    lp = _tconv_layer(layer)
    out = {}
    for comm, reorder in TCONV_CASES:
        # duplicate edges kept: the partition without its coalesce
        pg = partition_graph(src, dst, None, num_nodes=n, num_shards=world, block=BLOCK,
                             coalesce=False, reorder=reorder)
        gp = GraphParallel.place(with_halo(pg) if comm == "halo" else pg, mesh, comm)
        out[(comm, reorder)] = (*_tconv_run(lp, gp, x, cot), gp.comm, gp.pg.reorder)
    return out


def _tiled_tconv_cases(world, layer):
    """The layer over the tiled partition at each of TILED_MIN_FILLS, with
    each shard's tile count and its row tiles no tile covers."""
    from plnlp_tpu_torch.parallel import make_graph_parallel, make_mesh

    n, src, dst, x, cot = _tconv_graph()
    mesh = make_mesh(1, world)
    lp = _tconv_layer(layer)
    out = {}
    for min_fill in TILED_MIN_FILLS:
        gp = make_graph_parallel(src, dst, None, num_nodes=n, mesh=mesh, block=BLOCK, tile=TILE,
                                 min_fill=min_fill)
        uncovered = [int((np.diff(t["rowptr"]) == 0).sum()) for t in gp.pg.tiles]
        out[min_fill] = (*_tconv_run(lp, gp, x, cot), gp.pg.tile_dense_edges,
                         list(gp.pg.shard_tiles), uncovered)
    return out


def _step(model, graph, graph_t, pos, neg, mesh):
    from plnlp_tpu_torch.parallel.graph_parallel import gather_node_features

    opt = model.make_optimizer()
    loss = model.train_step(opt, graph, graph_t, None, torch.as_tensor(pos),
                            torch.as_tensor(neg), None, torch.ones(len(pos)), LR, mesh=mesh)
    grads, params = {}, {}
    for name, p in model.named_parameters():
        g, v = p.grad, p.detach()
        if name == "emb" and model.row_placement is not None:
            g, v = (gather_node_features(t, model.row_placement) for t in (g, v))
        grads[name], params[name] = g.numpy(), v.numpy()
    return {"loss": float(loss), "grads": grads, "params": params}


def _step_cases():
    """SAGE and TRANSFORMER over the tiled partition and TRANSFORMER over
    the blocked one at (data, node) = (1, 2), each beside the single-device
    step (every rank runs it; rank 0's is returned)."""
    from plnlp_tpu_torch.graph import prepare_graph
    from plnlp_tpu_torch.parallel import make_graph_parallel, make_mesh, shard_params
    from plnlp_tpu_torch.training import Model, ModelConfig

    src, dst, pos, neg = _step_data()
    mesh = make_mesh(1, 2)
    out = {}
    for case, encoder, tile in (("SAGE", "SAGE", TILE), ("TRANSFORMER", "TRANSFORMER", 0),
                                ("TRANSFORMER-tiled", "TRANSFORMER", TILE)):
        cfg = ModelConfig(encoder=encoder, emb_hidden_channels=16, gnn_hidden_channels=16,
                          mlp_hidden_channels=16, batch_size=B, dropout=0.0, predictor="DOT",
                          loss_func="AUC")
        model = Model(cfg, NS, seed=3, device="cpu")
        twin = copy.deepcopy(model)
        gp = make_graph_parallel(src, dst, None, num_nodes=NS, mesh=mesh, block=BLOCK,
                                 comm="all_gather", reorder="bfs", tile=tile, min_fill=20)
        shard_params(model, gp)
        g, g_t = prepare_graph(src, dst, num_nodes=NS, block=BLOCK, device="cpu",
                               couple_transpose=encoder == "TRANSFORMER")
        out[case] = (_step(model, gp, None, pos, neg, mesh), _step(twin, g, g_t, pos, neg, None),
                     gp.pg.tile_dense_edges)
    return out


def _cli_case(tmp, tag):
    lines = _run_cli(_cli_argv(tmp, f"s2_{tag}", num_shards=2, **CLI_FLAGS[tag]))
    return [line for line in lines if line.startswith("partition:")]


# --- the test process's side ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_layer():
    """One JAX TRANSFORMER layer's parameters as numpy."""
    import jax

    from plnlp_tpu.models.encoders import init_encoder

    return jax.tree_util.tree_map(
        np.asarray, init_encoder(jax.random.PRNGKey(0), "TRANSFORMER", D, D, 1)["layers"][0])


@pytest.fixture(scope="module")
def cli_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cli"))


@pytest.fixture(scope="module")
def ranks(jax_layer, cli_tmp, tmp_path_factory):
    """Rank 0's results of the 2-rank and the 4-rank group, run at once."""
    return spawn({
        2: [
            ("spmm", "_tiled_spmm_cases", (2,)),
            ("tconv", "_tconv_cases", (2, jax_layer)),
            ("tconv_tiled", "_tiled_tconv_cases", (2, jax_layer)),
            ("step", "_step_cases", ()),
            *((f"cli_{tag}", "_cli_case", (cli_tmp, tag)) for tag in CLI_FLAGS),
        ],
        4: [
            ("spmm", "_tiled_spmm_cases", (4,)),
            ("tconv", "_tconv_cases", (4, jax_layer)),
            ("tconv_tiled", "_tiled_tconv_cases", (4, jax_layer)),
        ],
    }, tmp_path_factory.mktemp("ranks"), __name__)


def _strip(stacked, n):
    """The first n entries of a JAX per-shard array; the rest padding."""
    a = np.asarray(stacked)
    assert not a[n:].any()
    return a[:n]


@pytest.mark.parametrize("weighted", [True, False])
def test_tiled_partition_metadata_matches_jax(weighted):
    from plnlp_tpu.parallel import partition as jpart
    from plnlp_tpu_torch.parallel import partition as tpart

    src, dst, w, _, _ = _spmm_graph(weighted)
    for shards in (2, 4):
        kw = dict(num_nodes=N, num_shards=shards, block=BLOCK, reorder="labelprop", tile=TILE,
                  min_fill=MIN_FILL)
        jp = jpart.partition_graph(src, dst, w, **kw)
        tp = tpart.partition_graph(src, dst, w, **kw)
        for f in ("num_nodes", "num_shards", "rows_per_shard", "block_rows", "block_edges",
                  "reorder", "shard_edges", "tile", "tile_dense_edges", "shard_tiles"):
            assert getattr(tp, f) == getattr(jp, f), f
        assert tp.tile_dense_edges > 0 and tp.block_edges == 32
        assert tp.tile_store == ("float32" if weighted else "int8")
        assert str(np.asarray(jp.tile_vals).dtype) == tp.tile_store
        for f in ("perm_in", "perm_out", "local_in_degrees"):
            np.testing.assert_array_equal(getattr(tp, f), np.asarray(getattr(jp, f)), err_msg=f)
        nrl = tp.rows_per_shard // TILE
        for s in range(shards):
            for suf, mine in (("", tp.tiles[s]), ("_t", tp.tiles_t[s])):
                n = mine["vals"].shape[0]
                what = f"S={shards} shard {s} tiles{suf}"
                if suf == "":
                    assert n == tp.shard_tiles[s], what
                np.testing.assert_array_equal(
                    mine["vals"], _strip(np.asarray(getattr(jp, "tile_vals" + suf))[s], n),
                    err_msg=what)
                assert mine["vals"].dtype == np.asarray(getattr(jp, "tile_vals" + suf)).dtype
                for k in ("row", "col"):
                    np.testing.assert_array_equal(
                        mine[k], np.asarray(getattr(jp, f"tile_{k}{suf}"))[s][:n],
                        err_msg=f"{what} {k}")
                np.testing.assert_array_equal(  # the row pointer names the same row tiles
                    np.repeat(np.arange(nrl), np.diff(mine["rowptr"])), mine["row"], err_msg=what)
                # JAX's row mask: the row tiles of the real tiles, and row
                # nrl - 1 where its zero padding tiles sit
                mask = getattr(jp, "tile_row_mask" + suf)
                covered = np.diff(mine["rowptr"]) > 0
                covered[-1] |= n < np.asarray(getattr(jp, "tile_vals" + suf)).shape[1]
                np.testing.assert_array_equal(
                    covered, np.ones(nrl, bool) if mask is None else np.asarray(mask)[s],
                    err_msg=f"{what}: row mask")
            for d in ("fwd", "bwd"):
                ours = getattr(tp, d)[s]
                nb = ours["blk_src"].shape[0]
                for k in ("blk_src", "blk_weight", "blk_local", "blk_rowblock"):
                    theirs = np.asarray(getattr(jp, f"{d}_{k}"))[s]
                    np.testing.assert_array_equal(ours[k], theirs[:nb], err_msg=f"{d} {s} {k}")
                assert not np.asarray(getattr(jp, f"{d}_blk_weight"))[s][nb:].any()


def _jax_spmm(name, reduce):
    """JAX's spmm_segment over the whole graph: values, the input
    gradient and the sums' magnitudes (of each, through |w| and |x|)."""
    import jax
    import jax.numpy as jnp

    from plnlp_tpu.graph import build_graph
    from plnlp_tpu.ops.spmm import spmm_segment

    weighted, _, dtype = SPMM_VARIANTS[name]
    src, dst, w, x, cot = _spmm_graph(weighted)
    if dtype == "bfloat16":  # the f32 function of the bf16-rounded inputs
        w, x, cot = (None if w is None else _bf16(w)), _bf16(x), _bf16(cot)
    g = build_graph(src, dst, w, num_nodes=N)
    gabs = build_graph(src, dst, None if w is None else np.abs(w), num_nodes=N)

    def run(graph, v, c):
        y, vjp = jax.vjp(lambda u: spmm_segment(graph, u, reduce), jnp.asarray(v))
        return np.asarray(y), np.asarray(vjp(jnp.asarray(c))[0])

    y, gx = run(g, x, cot)
    ya, gxa = run(gabs, np.abs(x), np.abs(cot))
    return (y, ya), (gx, gxa)


@pytest.mark.parametrize("world", [2, 4])
def test_tiled_partitioned_spmm_matches_jax(world, ranks):
    got = ranks[world]["spmm"]
    for name, (weighted, min_fill, dtype) in SPMM_VARIANTS.items():
        info = got[name]
        assert info["comm"] == "all_gather" and info["reorder"] == "labelprop", name
        exact = not weighted or min_fill == 10**9  # no tile: stored int8, as JAX's
        assert info["store"] == (torch.int8 if exact else getattr(torch, dtype)), name
        if min_fill == 10**9:
            assert info["dense_edges"] == 0
        elif min_fill == 1:
            assert info["dense_edges"] == 600
        else:
            assert 0 < info["dense_edges"] < 600, name
        for reduce in ("sum", "mean"):
            for mine, (want, mag), what in zip(got[(name, reduce)], _jax_spmm(name, reduce),
                                               ("values", "input gradient")):
                msg = f"S={world} {name} {reduce} {what}"
                if dtype == "bfloat16":
                    assert np.all(np.abs(mine - want) <= 1e-5 + 2.0**-6 * mag), msg
                else:
                    np.testing.assert_allclose(mine, want, rtol=1e-4, atol=1e-5, err_msg=msg)


def test_tiled_single_shard_still_reorders():
    """S = 1 with tiles still runs the labelprop relabel: on the id order
    the tile sets would degenerate (JAX's
    test_tiled_partition_single_shard_still_reorders)."""
    import jax.numpy as jnp

    from plnlp_tpu.graph import build_graph
    from plnlp_tpu.ops.spmm import spmm_segment
    from plnlp_tpu_torch.parallel import (
        gather_node_features, make_graph_parallel, make_mesh, partitioned_spmm,
        shard_node_features,
    )

    r = np.random.default_rng(2)
    perm = r.permutation(120)  # 6 communities of 20, ids shuffled
    comm = r.integers(0, 6, 900)
    src, dst = perm[comm * 20 + r.integers(0, 20, 900)], perm[comm * 20 + r.integers(0, 20, 900)]
    gp = make_graph_parallel(src, dst, None, num_nodes=120, mesh=make_mesh(1, 1), block=BLOCK,
                             tile=TILE)
    assert gp.pg.reorder == "labelprop" and gp.pg.tile_dense_edges > 0
    x = r.standard_normal((120, D)).astype(np.float32)
    y = gather_node_features(partitioned_spmm(gp, shard_node_features(torch.from_numpy(x), gp)),
                             gp)
    want = spmm_segment(build_graph(src, dst, None, num_nodes=120), jnp.asarray(x), "sum")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_tiled_partition_rejects_halo():
    from plnlp_tpu_torch.parallel import make_graph_parallel, make_mesh
    from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel
    from plnlp_tpu_torch.parallel.partition import partition_graph, with_halo

    src, dst, w, _, _ = _spmm_graph(True)
    with pytest.raises(ValueError, match="all_gather"):
        make_graph_parallel(src, dst, w, num_nodes=N, mesh=make_mesh(1, 1), block=BLOCK,
                            tile=TILE, comm="halo")
    pg = partition_graph(src, dst, w, num_nodes=N, num_shards=2, block=BLOCK, tile=TILE,
                         reorder="labelprop")
    with pytest.raises(ValueError, match="all_gather"):
        with_halo(pg)
    pg1 = partition_graph(src, dst, w, num_nodes=N, num_shards=1, block=BLOCK, tile=TILE,
                          reorder="labelprop")
    with pytest.raises(ValueError, match="all_gather"):
        GraphParallel.place(pg1, make_mesh(1, 1), "halo")


def _flat_grads(lp):
    return {f"{k}.{'weight' if p == 'w' else 'bias'}": np.asarray(v)
            for k, sub in lp.items() for p, v in sub.items()}


def _jax_tconv(jax_layer, coalesce):
    """The JAX package's single-device TRANSFORMER layer over the test
    graph: values, input gradient and the linears' gradients."""
    import jax
    import jax.numpy as jnp

    from plnlp_tpu.graph import build_graph
    from plnlp_tpu.models.encoders import _transformer_conv

    n, src, dst, x, cot = _tconv_graph()
    g = build_graph(src, dst, None, num_nodes=n, coalesce=coalesce)
    lp = jax.tree_util.tree_map(jnp.asarray, jax_layer)
    y, vjp = jax.vjp(lambda p, v: _transformer_conv(p, g, None, v), lp, jnp.asarray(x))
    dlp, dx = vjp(jnp.asarray(cot))
    return np.asarray(y), np.asarray(dx), _flat_grads(jax.tree_util.tree_map(np.asarray, dlp))


def _assert_tconv(got, want, msg):
    (got_y, got_dx, got_grads), (y, dx, want_grads) = got, want
    np.testing.assert_allclose(got_y, y, rtol=1e-5, atol=1e-5, err_msg=msg)
    np.testing.assert_allclose(got_dx, dx, rtol=1e-4, atol=1e-5, err_msg=msg)
    assert set(got_grads) == set(want_grads)
    for k, w in want_grads.items():
        np.testing.assert_allclose(got_grads[k], w, rtol=1e-4, atol=1e-5, err_msg=f"{msg} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_partitioned_transformer_matches_jax(world, ranks, jax_layer):
    want = _jax_tconv(jax_layer, coalesce=False)
    for comm, reorder in TCONV_CASES:
        *got, got_comm, got_reorder = ranks[world]["tconv"][(comm, reorder)]
        msg = f"S={world} {comm} {reorder}"
        assert (got_comm, got_reorder) == (comm, reorder), msg
        _assert_tconv(got, want, msg)


@pytest.mark.parametrize("world", [2, 4])
def test_tiled_partitioned_transformer_matches_jax(world, ranks, jax_layer):
    """K3-K5 on each shard at split row counts plus K1 on its residual
    against JAX's single-device layer over the coalesced edges; min_fill 1
    leaves no residual edge, 10**9 no tile on any shard, and at min_fill 3
    some shard has a row tile no tile covers (its rows come out of K3 as
    (0, 0, -inf) and K4/K5 write 0 there)."""
    want = _jax_tconv(jax_layer, coalesce=True)
    n, src, dst, _, _ = _tconv_graph()
    n_edges = len(np.unique(dst * n + src))
    for min_fill in TILED_MIN_FILLS:
        *got, dense_edges, shard_tiles, uncovered = ranks[world]["tconv_tiled"][min_fill]
        msg = f"S={world} min_fill={min_fill}"
        if min_fill == 1:
            assert dense_edges == n_edges, msg
        elif min_fill == 10**9:
            assert dense_edges == 0 and not any(shard_tiles), msg
        else:
            assert 0 < dense_edges < n_edges and any(uncovered), msg
        _assert_tconv(got, want, msg)


@pytest.mark.parametrize("encoder", ["SAGE", "TRANSFORMER", "TRANSFORMER-tiled"])
def test_train_step_matches_single_device(encoder, ranks):
    got, want, dense_edges = ranks[2]["step"][encoder]
    if encoder != "TRANSFORMER":  # a tiled partition
        assert 0 < dense_edges < ES
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(want["grads"])
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, rtol=1e-4, atol=1e-5, err_msg=f"grad {k}")
    for k, v in want["params"].items():
        if k.endswith("lin_key.bias"):
            # its gradient is exactly 0 (the softmax cancels q_i . b_k), so
            # both hold rounding residue (held above at atol 1e-5), which
            # Adam's m / sqrt(v) turns into steps of up to lr in either sign
            assert np.abs(got["params"][k] - v).max() <= 2 * LR, k
            continue
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-4, atol=1e-6, err_msg=f"param {k}")


@pytest.mark.parametrize("tag", list(CLI_FLAGS))
def test_cli_s2_matches_single_device(tag, ranks, cli_tmp):
    _run_cli(_cli_argv(cli_tmp, f"s1_{tag}", **CLI_FLAGS[tag]))
    (line,) = ranks[2][f"cli_{tag}"]
    assert line.startswith("partition: S=2")
    assert ("tiles/shard=" in line) == tag.endswith("hybrid"), line
    np.testing.assert_allclose(_epoch_loss(cli_tmp, f"s2_{tag}"),
                               _epoch_loss(cli_tmp, f"s1_{tag}"), rtol=1e-5)


def test_launches_a_pass(monkeypatch):
    """Over tiles a pass launches K2 once and K1 once (the residual); the
    partitioned TransformerConv launches K1 once forward and three times
    backward over blocks, and over tiles K3 once and K1 once forward, K4,
    K5 once and K1 three times backward.  (Counting stubs stand in for the
    wrappers, which count only on the card.)"""
    from plnlp_tpu_torch.models.encoders import _transformer_conv
    from plnlp_tpu_torch.nn import linear
    from plnlp_tpu_torch.parallel import graph_parallel as G
    from plnlp_tpu_torch.parallel import make_graph_parallel, make_mesh, shard_node_features
    from plnlp_tpu_torch.parallel import tile_transformer as TT

    counts = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)

    def counting(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(G, "scatter_matmul", counting("K1", G.scatter_matmul))
    monkeypatch.setattr(G, "tile_matmul", counting("K2", G.tile_matmul))
    for name, fn in (("K3", "flash_tiles_fwd"), ("K4", "flash_tiles_dq"),
                     ("K5", "flash_tiles_dkv")):
        monkeypatch.setattr(TT, fn, counting(name, getattr(TT, fn)))

    def launched(**want):
        return {k: want.get(k, 0) for k in counts}

    src, dst, w, x, _ = _spmm_graph(True)
    mesh = make_mesh(1, 1)
    tiled = make_graph_parallel(src, dst, w, num_nodes=N, mesh=mesh, block=BLOCK, tile=TILE,
                                min_fill=MIN_FILL)
    xl = shard_node_features(torch.from_numpy(x), tiled).requires_grad_(True)
    y = G.partitioned_spmm(tiled, xl, "mean")
    assert counts == launched(K1=1, K2=1)
    y.sum().backward()
    assert counts == launched(K1=2, K2=2)
    lp = {k: linear(D, D) for k in ("lin_query", "lin_key", "lin_value", "lin_skip")}
    counts.update(launched())
    xt = shard_node_features(torch.from_numpy(x), tiled).requires_grad_(True)
    y = _transformer_conv(lp, tiled, None, xt)
    assert counts == launched(K1=1, K3=1)
    y.sum().backward()
    assert counts == launched(K1=4, K3=1, K4=1, K5=1)
    plain = make_graph_parallel(src, dst, None, num_nodes=N, mesh=mesh, block=BLOCK)
    xp = shard_node_features(torch.from_numpy(x), plain).requires_grad_(True)
    counts.update(launched())
    y = _transformer_conv(lp, plain, None, xp)
    assert counts == launched(K1=1)
    y.sum().backward()
    assert counts == launched(K1=4)
