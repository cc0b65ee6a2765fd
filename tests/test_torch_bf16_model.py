"""plnlp_tpu_torch's ``Model`` in bfloat16 against plnlp_tpu's (CPU).

SAGE, GCN, WSAGE and TRANSFORMER over blocked CSR (TRANSFORMER's with
``couple_transpose=True`` on both sides, so both take the blocked hand
VJP), the hybrid operand (bf16 tile store where int8 is not exact) and the
dense adjacency: ``encode`` and three
train steps' losses against the JAX ``Model`` in bf16 with the same
parameters (``params_from_jax``) and batches, and against the port in f32,
at the JAX package's own bf16 bound (tests/test_fuzz_parity.py: rtol 3e-2,
atol 1e-2): bf16 rounds at other places in the two packages (the JAX CPU
path rounds each message and each sub-block's partial sum, the port's
kernel paths once a row).  The parameters and the optimizer state stay
f32; ``encode`` and the Scorer give f32.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import plnlp_tpu.dense as jdense
import plnlp_tpu.graph as jgraph
import plnlp_tpu.ops.tile_spmm as jts
from plnlp_tpu.serve import Scorer as JaxScorer
from plnlp_tpu.training import Model as JaxModel
from plnlp_tpu.training import ModelConfig as JaxConfig
from plnlp_tpu_torch import dense as tdense
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.convert import params_from_jax
from plnlp_tpu_torch.ops import tile_spmm as tts
from plnlp_tpu_torch.serve import Scorer
from plnlp_tpu_torch.training import Model, ModelConfig
from tests.test_torch_bf16 import _f32, _sbm
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

MODEL_TOL = dict(rtol=3e-2, atol=1e-2)
N, W, B = 100, 16, 32


@functools.lru_cache(maxsize=None)
def _operands(encoder, backend):
    """(port graph, port graph_t, JAX graph, JAX graph_t) for one encoder's
    edge weights on one backend; the hybrid store in bf16."""
    src, dst, _ = _sbm()
    w = None
    if encoder == "GCN":
        src, dst, w = tgraph.gcn_normalize_edges(src, dst, None, N)
    elif encoder == "WSAGE":
        src, dst, w = tgraph.row_normalize_edges(src, dst, None, N)
    if backend == "csr":
        kw = dict(num_nodes=N, block=(32, 128), couple_transpose=encoder == "TRANSFORMER")
        return (*tgraph.prepare_graph(src, dst, w, device="cpu", **kw),
                *jgraph.prepare_graph(src, dst, w, **kw))
    if backend == "dense":
        return (tdense.prepare_dense(src, dst, w, num_nodes=N, device="cpu"), None,
                jdense.prepare_dense(src, dst, w, num_nodes=N), None)
    kw = dict(num_nodes=N, tile=32, min_fill=20, block=(64, 512), dtype="bfloat16")
    th = tts.build_hybrid(src, dst, w, device="cpu", **kw)
    assert th.num_tiles > 1 and th.res_edges > 0
    return th, None, jts.build_hybrid(src, dst, w, **kw), None


# encoder, backend, predictor, loss, optimizer: Adam with CE or with DOT
# (a pairwise loss leaves an MLP predictor's gradients as rounding residue,
# which Adam turns into steps of +-lr), SGD otherwise
MODEL_CASES = [
    ("SAGE", "csr", "MLP", "CE", "Adam"),
    ("SAGE", "hybrid", "DOT", "AUC", "Adam"),
    ("SAGE", "dense", "MLP", "AUC", "SGD"),
    ("GCN", "csr", "DOT", "AUC", "AdamW"),
    ("GCN", "hybrid", "MLP", "CE", "Adam"),
    ("GCN", "dense", "BIL", "CE", "Adam"),
    ("WSAGE", "csr", "MLPDOT", "CE", "SGD"),
    ("WSAGE", "hybrid", "MLPCAT", "CE", "Adam"),
    ("WSAGE", "dense", "MLPBIL", "CE", "Adam"),
    ("TRANSFORMER", "csr", "DOT", "AUC", "Adam"),
    ("TRANSFORMER", "hybrid", "MLP", "CE", "Adam"),
    ("TRANSFORMER", "dense", "MLPCAT", "CE", "SGD"),
]


@pytest.mark.parametrize("encoder,backend,predictor,loss,optimizer", MODEL_CASES)
def test_model_bf16_matches_jax(encoder, backend, predictor, loss, optimizer):
    rng = np.random.default_rng(1)
    kw = dict(encoder=encoder, predictor=predictor, loss_func=loss, optimizer=optimizer,
              emb_hidden_channels=W, gnn_hidden_channels=W, mlp_hidden_channels=W,
              batch_size=B, lr=0.01, grad_clip_norm=1.0)
    jm = JaxModel(JaxConfig(**kw, compute_dtype="bfloat16"), N)
    jp = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(2)))
    models = {}
    for dt in ("bfloat16", "float32"):
        models[dt] = Model(ModelConfig(**kw, compute_dtype=dt), N, device="cpu")
        params_from_jax(jp, models[dt])
    tg, tgt, jg, jgt = _operands(encoder, backend)

    h = {dt: m.encode(tg, tgt) for dt, m in models.items()}
    assert h["bfloat16"].dtype == torch.float32 and h["bfloat16"].shape == (N + 1, W)
    want_h = np.asarray(jm._encode(jp, jg, jgt, None))
    np.testing.assert_allclose(_f32(h["bfloat16"]), want_h, **MODEL_TOL)
    np.testing.assert_allclose(_f32(h["bfloat16"]), _f32(h["float32"]), **MODEL_TOL)
    pairs = rng.integers(0, N, (64, 2))
    if (encoder, backend) == ("SAGE", "hybrid"):  # the Scorer in f32 over the bf16 encode
        got = Scorer(models["bfloat16"], tg).score(pairs)
        want = np.asarray(JaxScorer(jm, jp, jg).score(pairs))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **MODEL_TOL)

    jo = jm.init_opt_state(jp)
    opts = {dt: m.make_optimizer() for dt, m in models.items()}
    for step in range(3):
        pos = rng.integers(0, N, (B, 2))
        neg = rng.integers(0, N, (B, 1, 2))
        mask = np.ones(B, np.float32)
        jp, jo, jloss = jm._train_step(
            jp, jo, jg, jgt, None, pos.astype(np.int32), neg.astype(np.int32),
            np.zeros(B, np.float32), mask, np.float32(0.01), jax.random.PRNGKey(step), False,
        )
        losses = {
            dt: float(m.train_step(opts[dt], tg, tgt, None, torch.from_numpy(pos),
                                   torch.from_numpy(neg), None, torch.from_numpy(mask), 0.01))
            for dt, m in models.items()
        }
        np.testing.assert_allclose(losses["bfloat16"], float(jloss), **MODEL_TOL)
        np.testing.assert_allclose(losses["bfloat16"], losses["float32"], **MODEL_TOL)
    m16 = models["bfloat16"]
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    assert all(v.dtype == torch.float32 for st in opts["bfloat16"].state.values()
               for v in st.values() if torch.is_tensor(v) and v.is_floating_point())
