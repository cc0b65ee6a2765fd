"""plnlp_tpu_torch stands alone: no jax, no plnlp_tpu, and no silent CPU
fallback when CUDA is asked for by default."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_neither_jax_nor_plnlp_tpu():
    code = (
        "import plnlp_tpu_torch, plnlp_tpu_torch.serve, plnlp_tpu_torch.convert, "
        "plnlp_tpu_torch.data, plnlp_tpu_torch._build, plnlp_tpu_torch.losses, "
        "plnlp_tpu_torch.sampling, plnlp_tpu_torch.ops.tile_spmm, "
        "plnlp_tpu_torch.ops.flash_tiles, plnlp_tpu_torch.ops.tile_attention, "
        "plnlp_tpu_torch.ops.sddmm, plnlp_tpu_torch.dense, plnlp_tpu_torch.logger, "
        "plnlp_tpu_torch.data.custom, plnlp_tpu_torch.data.ogb, plnlp_tpu_torch.ops.walk, "
        "plnlp_tpu_torch.augment, plnlp_tpu_torch.profiling, plnlp_tpu_torch.checkpoint, "
        "plnlp_tpu_torch.resilience, plnlp_tpu_torch.cli, plnlp_tpu_torch.__main__, sys; "
        "bad = [m for m in sys.modules if m == 'jax' or m == 'plnlp_tpu' "
        "or m.startswith(('jax.', 'plnlp_tpu.'))]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from plnlp_tpu_torch import default_device, prepare_graph
    from plnlp_tpu_torch.training import Model, ModelConfig

    src, dst = np.array([0, 1]), np.array([1, 2])
    with pytest.raises(RuntimeError, match="no GPU"):
        prepare_graph(src, dst, num_nodes=3)
    with pytest.raises(RuntimeError, match="no GPU"):
        Model(ModelConfig(emb_hidden_channels=4, gnn_hidden_channels=4,
                          mlp_hidden_channels=4), num_nodes=3)
    with pytest.raises(RuntimeError, match="no GPU"):
        default_device("cuda")
    from plnlp_tpu_torch.dense import prepare_dense

    with pytest.raises(RuntimeError, match="no GPU"):
        prepare_dense(src, dst, num_nodes=3)
    assert default_device("cpu").type == "cpu"
