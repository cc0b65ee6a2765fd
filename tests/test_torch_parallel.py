"""plnlp_tpu_torch.parallel on the CPU: gloo process groups against the JAX
package on the 8-virtual-device mesh of tests/conftest.py (mirrors
tests/test_graph_parallel.py and tests/test_parallel.py).

Two process groups, of 2 and 4 ranks, spawned at once in one
module-scoped fixture, run every multi-rank case; rank 0 writes its
arrays to a file the test process reads.  Each process group has a 60 s timeout and each spawn a wall-clock
limit of its own, so a rank that raises cannot hang the suite.

* The partition metadata equals JAX's ``partition_graph`` exactly, per
  shard with JAX's padding stripped (S = 2, 4; reorders none, edges,
  degree, bfs; the halo plans too); ``choose_comm`` equals JAX's.
* ``partitioned_spmm``, sum and mean, values and input gradients, at S = 2
  and S = 4 over all_gather and halo with reorders edges, degree and bfs,
  against JAX's ``spmm_segment`` on the whole graph (JAX's own tests hold
  its ``partitioned_spmm`` to the same function; running it here would
  cost 6-20 s a case): within 1e-5 + 1e-5 |y| (f32 sums of ~6 terms in
  another order).
* A full train step (SAGE + DOT + Adam, with the AUC loss, a sum, and the
  CE loss, a mean that each rank rescales to the global count) at (data,
  node) = (1, 2), (2, 1) and (2, 2) against JAX's
  ``make_sharded_train_step`` on its mesh: loss within rtol 1e-5, the
  clipped gradients within rtol 1e-4 / atol 1e-5, the parameters after
  the step within rtol 1e-4 / atol 1e-6 (Adam with DOT, where every
  gradient entry is real: ROADMAP §3); every rank draws the same
  negatives.
* The step over what each CLI prepares at ``--num_shards 2``,
  ``--mesh_data 2`` and both: the port's ``cli.prepare_experiment`` on
  the ranks against the JAX package's on its mesh (its operand, mesh and
  placed state, its ``_train_step``), from the same parameters and pairs,
  with the tolerances above.
* ``batch_predict`` and ``Scorer.score`` with data = 2 against JAX's
  ``batch_predict`` within 1e-5.
* The CLI at ``--num_shards 2``, ``--mesh_data 2`` and (2, 2) for one
  epoch on a small ``synthetic:*`` graph against the single-device CLI
  (the two packages' CLIs draw batches and negatives from different
  generators, so whole epochs are held to the port's own single-device
  run, and single steps to the JAX package's above):
  epoch loss within rtol 1e-5, parameters within 1e-4, and rank 0 logs
  the parameter count with the table counted whole (2672); the S = 2
  checkpoint restored at S = 1 gives the trained parameters' bits and the
  run resumes from it; a single-device checkpoint resumes at S = 2 over
  halo and ends its next epoch where the single-device resume does.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)
from tests.torch_ranks import spawn

N, D, E = 100, 16, 600  # the partitioned_spmm graph (tests/test_graph_parallel.py)
NS, ES, B = 64, 400, 64  # the train step (tests/test_parallel.py)
CLI_DATA = "synthetic:hits:num_nodes=300,num_edges=3000"
SPMM_CASES = [(c, r) for c in ("all_gather", "halo") for r in ("edges", "degree", "bfs")]
STEP_REORDER = {(1, 2): "bfs", (2, 2): "degree"}
STEP_LOSSES = ("AUC", "CE")  # a sum and a mean
CLI_MESHES = {"s2": (dict(num_shards=2), 2), "d2": (dict(mesh_data=2), 2),
              "d2s2": (dict(num_shards=2, mesh_data=2), 4)}


def _graph(seed=0, n=N, e=E):
    r = np.random.default_rng(seed)
    return (r.integers(0, n, e), r.integers(0, n, e), (r.random(e) + 0.1).astype(np.float32),
            r.standard_normal((n, D)).astype(np.float32),
            r.standard_normal((n, D)).astype(np.float32))


def _step_data():
    r = np.random.default_rng(0)
    src, dst = r.integers(0, NS, ES), r.integers(0, NS, ES)
    pos = np.stack([src[:B], dst[:B]], 1).astype(np.int64)
    neg = np.random.default_rng(1).integers(0, NS, (B, 1, 2)).astype(np.int64)
    return src, dst, pos, neg


def _step_cfg(loss_func="AUC"):
    from plnlp_tpu_torch.training import ModelConfig

    return ModelConfig(emb_hidden_channels=16, gnn_hidden_channels=16, mlp_hidden_channels=16,
                       batch_size=B, dropout=0.0, predictor="DOT", loss_func=loss_func)


def _cli_pairs():
    """The pair batch both CLIs' prepared steps train on."""
    r = np.random.default_rng(0)
    return r.integers(0, 300, (B, 2)), r.integers(0, 300, (B, 1, 2))


def _cli_argv(tmp, tag, **kw):
    flags = dict(data_name=CLI_DATA, epochs=1, eval_steps=1, runs=1, batch_size=512,
                 emb_hidden_channels=8, gnn_hidden_channels=8, mlp_hidden_channels=8,
                 predictor="DOT", checkpoint_dir=os.path.join(tmp, tag, "ck"),
                 metrics_file=os.path.join(tmp, tag, "metrics.jsonl"), checkpoint_every=1)
    flags.update(kw)
    return [f"--{k}={v}" for k, v in flags.items()]


def _run_cli(argv, log=lambda *_: None):
    from plnlp_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        loggers = cli.run_experiment(cli.argument(argv), log=log, device="cpu")
    return {k: lg.results for k, lg in loggers.items()}


# --- the ranks' side (no JAX here: the spawned processes import this module) --


def _spmm_cases(world):
    from plnlp_tpu_torch.parallel import (
        gather_node_features, make_graph_parallel, make_mesh, partitioned_spmm,
        shard_node_features,
    )

    src, dst, w, x, cot = _graph()
    x, cot = torch.from_numpy(x), torch.from_numpy(cot)
    mesh = make_mesh(1, world)
    out = {}
    for comm, reorder in SPMM_CASES:
        gp = make_graph_parallel(src, dst, w, num_nodes=N, mesh=mesh, block=(8, 128),
                                 comm=comm, reorder=reorder)
        for reduce in ("sum", "mean"):
            xl = shard_node_features(x, gp).requires_grad_(True)
            yl = partitioned_spmm(gp, xl, reduce)
            # each rank's loss covers its own rows: a distinct share
            (yl * shard_node_features(cot, gp)).sum().backward()
            out[(comm, reorder, reduce)] = (
                gather_node_features(yl.detach(), gp).numpy(),
                gather_node_features(xl.grad, gp).numpy(),
                gp.pg.reorder,
            )
    return out


def _grads_jax_layout(model):
    """{port parameter name: gradient in the JAX layout}, the table whole."""
    from plnlp_tpu_torch.parallel.graph_parallel import gather_node_features

    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        if name == "emb" and model.row_placement is not None:
            g = gather_node_features(g, model.row_placement)
        out[name] = g.t().numpy() if name.endswith("weight") else g.numpy()
    return out


def _one_step(model, jax_params, graph, graph_t, node_feats, pos, neg, mesh):
    """One train step from the JAX parameters: loss, gradients, parameters."""
    from plnlp_tpu_torch.convert import params_from_jax, params_to_jax

    params_from_jax(jax_params, model)
    opt = model.make_optimizer()
    loss = model.train_step(opt, graph, graph_t, node_feats, torch.as_tensor(pos),
                            torch.as_tensor(neg), None, torch.ones(len(pos)), 1e-2, mesh=mesh)
    return {"loss": float(loss), "grads": _grads_jax_layout(model),
            "params": params_to_jax(model)}


def _step_case(data, node, jax_params):
    from plnlp_tpu_torch.graph import prepare_graph
    from plnlp_tpu_torch.parallel import make_graph_parallel, make_mesh, shard_params
    from plnlp_tpu_torch.parallel.mesh import gather_rows
    from plnlp_tpu_torch.training import Model

    src, dst, pos, neg = _step_data()
    mesh = make_mesh(data, node)
    graph_t = None
    if node > 1:
        graph = make_graph_parallel(src, dst, None, num_nodes=NS, mesh=mesh, block=(8, 128),
                                    comm="all_gather", reorder=STEP_REORDER[(data, node)])
    else:
        graph, graph_t = prepare_graph(src, dst, num_nodes=NS, block=(8, 128), device="cpu")
    out = {}
    for loss_func in STEP_LOSSES:
        model = Model(_step_cfg(loss_func), NS, device="cpu")
        shard_params(model, graph)
        out[loss_func] = _one_step(model, jax_params, graph, graph_t, None, pos, neg, mesh)
    # every rank draws the same negatives from the same seed (the global
    # sampler over the replicated CSR twin, as train_epoch does)
    twin, _ = prepare_graph(src, dst, num_nodes=NS, block=None, device="cpu")
    drawn = model.sample_negatives(torch.Generator().manual_seed(3), twin, torch.as_tensor(pos))
    out["same_negatives"] = bool((gather_rows(drawn[None], dist.group.WORLD) == drawn).all())
    return out


def _cli_step_case(tmp, tag, jax_params):
    """One step over the operand, mesh and model the CLI prepares."""
    from plnlp_tpu_torch import cli

    args = cli.argument(_cli_argv(tmp, f"prep_{tag}", dropout=0.0, **CLI_MESHES[tag][0]))
    prep = cli.prepare_experiment(args, log=lambda *_: None, device="cpu")
    return _one_step(prep["model"], jax_params, prep["graph"], prep["graph_t"],
                     prep["node_feats"], *_cli_pairs(), prep["mesh"])


def _predict_case(jax_params, pairs):
    from plnlp_tpu_torch.convert import params_from_jax
    from plnlp_tpu_torch.graph import prepare_graph
    from plnlp_tpu_torch.parallel import make_mesh
    from plnlp_tpu_torch.serve import Scorer
    from plnlp_tpu_torch.training import Model

    src, dst, _, _ = _step_data()
    mesh = make_mesh(2, 1)
    graph, graph_t = prepare_graph(src, dst, num_nodes=NS, block=(8, 128), device="cpu")
    model = params_from_jax(jax_params, Model(_step_cfg(), NS, device="cpu"))
    h = model.encode(graph, graph_t)
    return {
        "batch_predict": model.batch_predict(h, pairs, mesh=mesh).numpy(),
        "score": Scorer(model, graph, graph_t, mesh=mesh).score(pairs),
    }


def _cli_case(tmp, tag, flags):
    from plnlp_tpu_torch.checkpoint import CheckpointManager

    lines = []
    results = _run_cli(_cli_argv(tmp, tag, **flags), log=lambda m: lines.append(str(m)))
    if dist.get_rank() != 0:  # rank 0 alone writes checkpoints
        return None
    ck = CheckpointManager(os.path.join(tmp, tag, "ck"))
    state, _, _ = ck.restore(device="cpu")
    return {"results": results, "state": {k: v.numpy() for k, v in state.items()}, "log": lines}


# --- the test process's side ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    import dataclasses

    import jax

    from plnlp_tpu.training import Model as JModel
    from plnlp_tpu.training import ModelConfig as JConfig

    jm = JModel(JConfig(**dataclasses.asdict(_step_cfg())), num_nodes=NS)
    return jm, jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def cli_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cli"))


PAIRS = np.random.default_rng(5).integers(-1, NS, (301, 2))


@pytest.fixture(scope="module")
def single(cli_tmp):
    """The single-device CLI run every multi-rank run is held to; its
    checkpoint is the one the S = 2 resume starts from."""
    import shutil

    results = _run_cli(_cli_argv(cli_tmp, "single"))
    with open(os.path.join(cli_tmp, "single", "metrics.jsonl")) as f:
        loss = json.loads(f.readline())["loss"]
    shutil.copytree(os.path.join(cli_tmp, "single", "ck"), os.path.join(cli_tmp, "s1_s2", "ck"))
    return results, loss


@pytest.fixture(scope="module")
def ranks(jax_params, jax_cli, cli_tmp, single, tmp_path_factory):
    """Rank 0's results of the 2-rank and the 4-rank group, run at once."""
    p, pc = jax_params[1], jax_cli["params"]
    return spawn({
        2: [
            ("spmm", "_spmm_cases", (2,)),
            ("step_1_2", "_step_case", (1, 2, p)),
            ("step_2_1", "_step_case", (2, 1, p)),
            ("predict", "_predict_case", (p, PAIRS)),
            ("cli_s2", "_cli_case", (cli_tmp, "s2", dict(num_shards=2))),
            ("cli_d2", "_cli_case", (cli_tmp, "d2", dict(mesh_data=2))),
            ("cli_s1_s2", "_cli_case", (cli_tmp, "s1_s2", dict(
                num_shards=2, partition_comm="halo", partition_reorder="bfs", epochs=2,
                resume=True))),
            ("cli_step_s2", "_cli_step_case", (cli_tmp, "s2", pc)),
            ("cli_step_d2", "_cli_step_case", (cli_tmp, "d2", pc)),
        ],
        4: [
            ("spmm", "_spmm_cases", (4,)),
            ("step_2_2", "_step_case", (2, 2, p)),
            ("cli_d2s2", "_cli_case", (cli_tmp, "d2s2", dict(num_shards=2, mesh_data=2))),
            ("cli_step_d2s2", "_cli_step_case", (cli_tmp, "d2s2", pc)),
        ],
    }, tmp_path_factory.mktemp("ranks"), __name__)


@pytest.mark.parametrize("reorder", [None, "edges", "degree", "bfs"])
def test_partition_metadata_matches_jax(reorder):
    for shards in (2, 4):
        _check_partition_metadata(shards, reorder)


def _check_partition_metadata(shards, reorder):
    from plnlp_tpu.parallel import partition as jpart
    from plnlp_tpu.parallel.graph_parallel import choose_comm as jchoose
    from plnlp_tpu_torch.parallel import partition as tpart
    from plnlp_tpu_torch.parallel.graph_parallel import choose_comm

    src, dst, w, _, _ = _graph()
    kw = dict(num_nodes=N, num_shards=shards, block=(8, 128), reorder=reorder)
    jp = jpart.with_halo(jpart.partition_graph(src, dst, w, **kw))
    tp = tpart.with_halo(tpart.partition_graph(src, dst, w, **kw))
    for f in ("num_nodes", "num_shards", "rows_per_shard", "block_rows", "block_edges",
              "reorder", "shard_edges", "halo_quota", "halo_hubs"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("perm_in", "perm_out", "local_in_degrees"):
        a, b = getattr(tp, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)

    def same_blocks(ours, theirs, what):
        n = ours["blk_src"].shape[0]
        for k in ("blk_src", "blk_weight", "blk_local", "blk_rowblock"):
            np.testing.assert_array_equal(ours[k], theirs[k][:n], err_msg=f"{what} {k}")
        assert not theirs["blk_weight"][n:].any(), f"{what}: JAX's rows past ours are padding"
        np.testing.assert_array_equal(  # the port's row pointer names the same row-blocks
            np.repeat(np.arange(len(ours["blk_rowptr"]) - 1), np.diff(ours["blk_rowptr"])),
            ours["blk_rowblock"], err_msg=what)

    nf_j = np.asarray(jp.fwd_blk_src).shape[1] * tp.block_edges
    offsets = np.cumsum([0] + [b["blk_src"].size for b in tp.fwd])
    for s in range(shards):
        for d in ("fwd", "bwd"):
            same_blocks(getattr(tp, d)[s], {k: np.asarray(getattr(jp, f"{d}_{k}"))[s] for k in (
                "blk_src", "blk_weight", "blk_local", "blk_rowblock")}, f"{d} shard {s}")
            plan_j = {k: np.asarray(v) for k, v in getattr(jp, f"{d}_halo").items()}
            plan_t = getattr(tp, f"{d}_halo")
            for part in ("loc", "rem"):
                same_blocks(plan_t[part][s], {k: plan_j[f"{part}_{k.split('_', 1)[1]}"][s]
                                              for k in ("blk_src", "blk_weight", "blk_local",
                                                        "blk_rowblock")}, f"{d} {part} {s}")
            for k in ("send_idx", "hub_idx"):
                np.testing.assert_array_equal(plan_t[k], plan_j[k], err_msg=f"{d} {k}")
        # the bwd -> fwd slot map names the same edges (JAX's flat index runs
        # over shards padded to a common sub-block count)
        jmap = np.asarray(jp.bwd_gather_fwd)[s][: tp.bwd[s]["blk_src"].shape[0]]
        live = tp.bwd[s]["blk_weight"] != 0
        j = jmap[live]
        np.testing.assert_array_equal(tp.bwd_gather_fwd[s][live], offsets[j // nf_j] + j % nf_j)
    plain = tpart.partition_graph(src, dst, w, **kw)
    jplain = jpart.partition_graph(src, dst, w, **kw)
    for rows in (0, 8, 64, 1e4):
        assert choose_comm(plain, rows) == jchoose(jplain, rows)


def _jax_spmm(reduce):
    import jax
    import jax.numpy as jnp

    from plnlp_tpu.graph import build_graph
    from plnlp_tpu.ops.spmm import spmm_segment

    src, dst, w, x, cot = _graph()
    g = build_graph(src, dst, w, num_nodes=N)
    y, vjp = jax.vjp(lambda v: spmm_segment(g, v, reduce), jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("world", [2, 4])
def test_partitioned_spmm_matches_jax(world, ranks):
    got = ranks[world]["spmm"]
    for reduce in ("sum", "mean"):
        want_y, want_g = _jax_spmm(reduce)
        for comm, reorder in SPMM_CASES:
            y, gx, resolved = got[(comm, reorder, reduce)]
            assert resolved == reorder
            for a, b, what in ((y, want_y, "values"), (gx, want_g, "input gradient")):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=f"S={world} {comm} {reorder} {reduce} {what}")


def _clip(tree, max_norm=2.0):
    """The step's per-group clip (encoder, predictor; the table is not)."""
    out = dict(tree)
    for group in ("encoder", "predictor"):
        keys = [k for k in tree if k.startswith(group + ".")]
        norm = np.sqrt(sum(np.sum(np.square(tree[k].astype(np.float64))) for k in keys))
        scale = min(max_norm / (norm + 1e-6), 1.0)
        for k in keys:
            out[k] = tree[k] * scale
    return out


def _flat_jax(tree, prefix=""):
    """The JAX params pytree as {port parameter name: array (in, out)}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            name = {"w": "weight", "b": "bias"}.get(k, k)
            out.update(_flat_jax(v, f"{prefix}{name}" if not isinstance(v, (dict, list))
                                 else f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_jax(v, f"{prefix}{i}."))
        return out
    return {prefix: np.asarray(tree)}


def _jax_grads(jm, params, g, node_feats, pos, neg):
    """The single-device gradient of the step's loss, clipped as the step
    clips it."""
    import jax
    import jax.numpy as jnp

    mask = jnp.ones((pos.shape[0],), jnp.float32)
    grads = jax.jit(jax.grad(lambda p: jm._loss_impl(
        p, g, None, node_feats, pos, neg, None, mask, jax.random.PRNGKey(42))))(
        jax.tree_util.tree_map(jnp.asarray, params))
    return _clip(_flat_jax(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.fixture(scope="module")
def jax_steps(jax_params):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from plnlp_tpu.graph import build_graph
    from plnlp_tpu.parallel import make_mesh, make_sharded_train_step, shard_batch, shard_graph
    from plnlp_tpu.parallel.sharded import shard_state
    from plnlp_tpu.training import Model as JModel
    from plnlp_tpu.training import ModelConfig as JConfig

    params = jax_params[1]
    src, dst, pos, neg = _step_data()
    g = build_graph(src, dst, None, num_nodes=NS)
    pos, neg = jnp.asarray(pos.astype(np.int32)), jnp.asarray(neg.astype(np.int32))
    mask, margin = jnp.ones((B,), jnp.float32), jnp.zeros((B,), jnp.float32)
    out = {}
    for loss_func in STEP_LOSSES:
        jm = JModel(JConfig(**dataclasses.asdict(_step_cfg(loss_func))), num_nodes=NS)
        out[loss_func] = {"grads": _jax_grads(jm, params, g, None, pos, neg)}
        for data, node in ((1, 2), (2, 1), (2, 2)):
            mesh = make_mesh(data=data, node=node)
            fresh = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), params)
            sp, so = shard_state(jm, mesh, fresh, jm.init_opt_state(fresh))
            spos, sneg = shard_batch((pos, neg), mesh)
            p2, _, loss = make_sharded_train_step(jm, mesh)(
                sp, so, shard_graph(g, mesh), None, None, spos, sneg, margin, mask,
                jnp.asarray(1e-2, jnp.float32), jax.random.PRNGKey(42))
            out[loss_func][(data, node)] = (
                float(loss), _flat_jax(jax.tree_util.tree_map(np.asarray, p2)))
    return out


@pytest.fixture(scope="module")
def jax_cli(cli_tmp):
    """The JAX package's CLI-prepared step at each of CLI_MESHES: its
    operand, mesh and placed state, and the epoch's ``_train_step`` with the
    batch over 'data' as its epoch places it; the initial parameters and the
    single-device gradient."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from plnlp_tpu import cli as jcli
    from plnlp_tpu.parallel.sharded import shard_state

    def prepare(**flags):
        args = jcli.argument(_cli_argv(cli_tmp, "jax", dropout=0.0, **flags))
        return jcli.prepare_experiment(args, log=lambda *_: None)

    single = prepare()
    params = jax.tree_util.tree_map(np.asarray, single["model"].init_params(jax.random.PRNGKey(0)))
    pos, neg = (jnp.asarray(a.astype(np.int32)) for a in _cli_pairs())
    out = {"params": params,
           "grads": _jax_grads(single["model"], params, single["graph"], single["node_feats"],
                               pos, neg)}
    for tag, (flags, _) in CLI_MESHES.items():
        prep = prepare(**flags)
        jm, mesh = prep["model"], prep["mesh"]
        fresh = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), params)
        sp, so = shard_state(jm, mesh, fresh, jm.init_opt_state(fresh))
        batch = [pos, neg, jnp.zeros((B,), jnp.float32), jnp.ones((B,), jnp.float32)]
        if mesh.shape["data"] > 1:
            batch = [jax.device_put(x, NamedSharding(
                mesh, PartitionSpec("data", *[None] * (x.ndim - 1)))) for x in batch]
        p2, _, loss = jm._train_step(sp, so, prep["graph"], prep["graph_t"], prep["node_feats"],
                                     *batch, jnp.asarray(1e-2, jnp.float32),
                                     jax.random.PRNGKey(42), False)
        out[tag] = (float(loss), _flat_jax(jax.tree_util.tree_map(np.asarray, p2)))
    return out


def _assert_step(got, loss, grads, params, what):
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5, err_msg=f"{what} loss")
    assert set(got["grads"]) == set(grads), what
    for k, want in grads.items():
        np.testing.assert_allclose(got["grads"][k], want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} grad {k}")
    mine = _flat_jax(got["params"])
    for k, want in params.items():
        np.testing.assert_allclose(mine[k], want, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} param {k}")


@pytest.mark.parametrize("data,node", [(1, 2), (2, 1), (2, 2)])
def test_train_step_matches_jax_sharded_step(data, node, ranks, jax_steps):
    got = ranks[data * node][f"step_{data}_{node}"]
    assert got["same_negatives"]
    for loss_func in STEP_LOSSES:
        loss, params = jax_steps[loss_func][(data, node)]
        _assert_step(got[loss_func], loss, jax_steps[loss_func]["grads"], params, loss_func)


def test_cli_step_matches_jax_cli_step(ranks, jax_cli):
    """``--num_shards 2``, ``--mesh_data 2`` and both: one step over the
    operand, mesh and model each package's CLI prepares, from the same
    parameters and pairs."""
    for tag, (_, world) in CLI_MESHES.items():
        loss, params = jax_cli[tag]
        _assert_step(ranks[world][f"cli_step_{tag}"], loss, jax_cli["grads"], params, tag)


def test_batch_predict_and_score_with_data_axis(ranks, jax_params):
    import jax.numpy as jnp

    from plnlp_tpu.graph import build_graph

    got, pairs = ranks[2]["predict"], PAIRS
    jm, params = jax_params
    src, dst, _, _ = _step_data()
    g = build_graph(src, dst, None, num_nodes=NS)
    jp = {k: v for k, v in params.items()}
    h = jm._encode(jp, g, None, None)
    want = np.asarray(jm.batch_predict(jp, h, jnp.asarray(pairs.astype(np.int32))))
    np.testing.assert_allclose(got["batch_predict"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["score"], got["batch_predict"])


@pytest.mark.parametrize("tag,world", [("s2", 2), ("d2", 2), ("d2s2", 4)])
def test_cli_multi_rank_matches_single_device(tag, world, ranks, single, cli_tmp):
    from plnlp_tpu_torch.checkpoint import CheckpointManager

    got = ranks[world][f"cli_{tag}"]
    # the table counted whole (300 x 8 + 272), whatever rows rank 0 holds
    assert "Total number of model parameters is 2672" in got["log"]
    want_results, want_loss = single
    with open(os.path.join(cli_tmp, tag, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1  # rank 0 alone writes metrics
    np.testing.assert_allclose(json.loads(lines[0])["loss"], want_loss, rtol=1e-5)
    want_state, _, _ = CheckpointManager(os.path.join(cli_tmp, "single", "ck")).restore(
        device="cpu")
    for k, v in want_state.items():
        np.testing.assert_allclose(got["state"][k], v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    for k in want_results:
        np.testing.assert_allclose(np.asarray(got["results"][k]), np.asarray(want_results[k]),
                                   atol=2e-2, err_msg=k)


def test_checkpoint_written_at_s2_resumes_at_s1(ranks, cli_tmp):
    """The S = 2 run's checkpoint holds the whole table in original node
    order: a single-device model restores the trained parameters' bits,
    and the CLI resumes from it for the next epoch."""
    from plnlp_tpu_torch.checkpoint import CheckpointManager
    from plnlp_tpu_torch.parallel.sharded import load_full_state
    from plnlp_tpu_torch.training import Model, ModelConfig

    got = ranks[2]["cli_s2"]
    ck = os.path.join(cli_tmp, "s2", "ck")
    state, opt_state, extra = CheckpointManager(ck).restore(device="cpu")
    assert state["emb"].shape == (300, 8) and extra["epoch"] == 1
    model = Model(ModelConfig(emb_hidden_channels=8, gnn_hidden_channels=8,
                              mlp_hidden_channels=8, predictor="DOT"), 300, device="cpu")
    opt = model.make_optimizer()
    load_full_state(model, opt, state, opt_state)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got["state"][k], err_msg=k)
    import shutil

    shutil.copytree(ck, os.path.join(cli_tmp, "s2_resume", "ck"))
    results = _run_cli(_cli_argv(cli_tmp, "s2_resume", epochs=2, resume=True))
    assert len(results["Hits@20"][0]) == 2  # epoch 1 restored, epoch 2 trained


def test_checkpoint_written_at_s1_resumes_at_s2(ranks, cli_tmp):
    """A single-device checkpoint resumes at S = 2 over halo: every rank
    takes its rows of the table and its moments, and the second epoch ends
    where the single-device resume ends (rtol 1e-4, as the runs above)."""
    import shutil

    from plnlp_tpu_torch.checkpoint import CheckpointManager

    got = ranks[2]["cli_s1_s2"]
    shutil.copytree(os.path.join(cli_tmp, "single", "ck"), os.path.join(cli_tmp, "s1_s1", "ck"))
    want_results = _run_cli(_cli_argv(cli_tmp, "s1_s1", epochs=2, resume=True))
    for k, v in want_results.items():
        assert len(got["results"][k][0]) == 2
        assert got["results"][k][0][0] == v[0][0]  # epoch 1: restored, not rerun
    want, _, extra = CheckpointManager(os.path.join(cli_tmp, "s1_s1", "ck")).restore(device="cpu")
    assert extra["epoch"] == 2
    for k, v in want.items():
        np.testing.assert_allclose(got["state"][k], v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def test_multi_rank_flags_without_process_group_raise(cli_tmp):
    """More than one rank needs torchrun's process group: the CLI says how
    to launch, and the mesh and the train step refuse a world that does
    not match."""
    from plnlp_tpu_torch.parallel import make_mesh

    for flags in (dict(num_shards=2), dict(mesh_data=2), dict(num_shards=2, mesh_data=2)):
        with pytest.raises(RuntimeError, match="torchrun --standalone --nproc_per_node="):
            _run_cli(_cli_argv(cli_tmp, "no_group", **flags))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(data=2, node=1)
