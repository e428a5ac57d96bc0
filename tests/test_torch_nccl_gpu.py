"""The tensor-parallel layout over NCCL, one rank a card (marker `gpu`;
skips without two CUDA cards: NCCL takes one rank per device). Imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_nccl_gpu.py
"""

import numpy as np
import pytest
import torch

import _torch_dist as D
from multimodal_diffusion_torch.ops import cuda_kernels as ck
from multimodal_diffusion_torch.parallel.launch import run_ranks
from multimodal_diffusion_torch.train import checkpoint as TC
from multimodal_diffusion_torch.train.trainer import create_trainer
from multimodal_diffusion_torch.utils.io import latent_shapes_from_config, shrunk_config

B = 4


def _assert_trees_equal(a, b, path=""):
    assert a.keys() == b.keys(), path
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            _assert_trees_equal(x, y, f"{path}/{k}")
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{path}/{k}"
        else:
            assert x == y, f"{path}/{k}"


@pytest.mark.gpu
def test_model2_checkpoint_over_nccl_crosses_to_one_process():
    """Three steps under parallel.model 2 over NCCL (bf16 moments, 2
    micro-batches a step, so the moments and the accumulator both hold
    values), then a checkpoint: both ranks gather the same whole tree on
    the host, and one process restores it bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL takes one rank per device)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = shrunk_config()
    cfg["model"]["core"]["n_heads"] = 2  # heads of 32: the kernels' smallest head dim
    cfg["training"]["optimizer"]["mv_dtype"] = "bf16"
    cfg["training"]["scheduler"] = {"name": "none"}
    cfg["data"]["grad_accum_steps"] = 2
    s = latent_shapes_from_config(cfg, B)
    rng = np.random.default_rng(0)
    batch = {"video": rng.uniform(0, 1, s["video"]).astype(np.float32),
             "audio": rng.uniform(-1, 1, s["audio"]).astype(np.float32),
             "has_video": np.ones(B, bool), "has_audio": np.ones(B, bool)}
    draws = {"t_v": rng.integers(0, 1000, B), "t_a": rng.integers(0, 1000, B),
             "noise_v": rng.standard_normal(s["z_video"]).astype(np.float32),
             "noise_a": rng.standard_normal(s["z_audio"]).astype(np.float32),
             "cfg_u": rng.uniform(0, 1, B).astype(np.float32),
             "clean_u": rng.uniform(0, 1, B).astype(np.float32)}
    for name in ck.SOURCES:  # built once here, before the ranks load them
        ck.build(name)
    trees = run_ranks(D.nccl_tp_checkpoint, 2, cfg, batch, draws, 3, backend="nccl",
                      timeout=600)
    _assert_trees_equal(trees[0], trees[1])
    tree = trees[0]
    assert tree["step"] == 3
    assert tree["params"]["core.blocks.0.attn.qkv.weight"].shape == (192, 64)
    assert tree["opt_state"]["mu"]["core.blocks.0.mlp.fc2.weight"].shape == (64, 128)
    assert any(float(t.abs().max()) > 0 for t in tree["opt_state"]["acc"].values())
    one = create_trainer(cfg, device="cuda", batch_size=B)
    TC.restore_state(one.state, tree)
    _assert_trees_equal(TC.state_to_tree(one.state), tree)
