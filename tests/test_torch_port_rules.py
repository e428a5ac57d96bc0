"""Rules the port keeps: it imports nothing of JAX or the JAX package, the
weight converter consumes every JAX leaf exactly once, its built-in config
is the merged mvp+v2a YAML, its entry points refuse to run on the CPU
unless asked to, and options of later slices raise."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import jax_model_and_params, shrunk_cfg
from multimodal_diffusion_torch.infer import sample_clip
from multimodal_diffusion_torch.models.diffusion import AVDiffusionConfig, AVDiffusionModel
from multimodal_diffusion_torch.train.trainer import create_trainer
from multimodal_diffusion_torch.utils import io as tio
from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict, torch_key
from multimodal_diffusion_tpu.utils.io import load_config

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "multimodal_diffusion_tpu"}
PORT_FILES = sorted((REPO / "multimodal_diffusion_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_converter_consumes_every_leaf_once():
    import jax

    cfg = shrunk_cfg()
    _, params = jax_model_and_params(cfg)
    leaves = jax.tree_util.tree_leaves(params)
    sd = jax_params_to_state_dict(params)
    assert len(sd) == len(leaves)
    model = AVDiffusionModel(AVDiffusionConfig.from_config(cfg))
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == sum(np.size(x) for x in leaves)


@pytest.mark.parametrize("path,key", [
    (("core", "block_3", "RMSNorm_0", "scale"), "core.blocks.3.norm1.weight"),
    (("core", "block_3", "LayerNorm_1", "bias"), "core.blocks.3.norm2.bias"),
    (("core", "RMSNorm_0", "scale"), "core.norm.weight"),
    (("head", "shared_1", "LayerNorm_0", "scale"), "head.shared.1.norm.weight"),
    (("vid_vae", "enc_0", "Conv_0", "kernel"), "vid_vae.enc.0.conv.weight"),
    (("t_embed", "Dense_1", "kernel"), "t_embed.fc2.weight"),
])
def test_flax_auto_names(path, key):
    assert torch_key(path) == key


def test_builtin_config_is_mvp_plus_v2a(monkeypatch):
    monkeypatch.delenv("OUTPUT_DIR", raising=False)
    monkeypatch.delenv("CHECKPOINT_DIR", raising=False)
    assert tio.mvp_v2a_config() == load_config(REPO / "configs" / "mvp.yaml",
                                               REPO / "configs" / "v2a.yaml")
    assert tio.load_config(REPO / "configs" / "mvp.yaml",
                           REPO / "configs" / "v2a.yaml") == tio.MVP_V2A_CONFIG


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = shrunk_cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_clip.build_components(cfg)
    model = sample_clip.build_components(cfg, device="cpu")
    frames = np.zeros((8, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_clip.sample_one_direction(cfg=cfg, model=model, prompt_modality="video",
                                         prompt_video=frames)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_clip.main(["--config", str(REPO / "configs" / "mvp.yaml"),
                          str(REPO / "configs" / "v2a.yaml"), "--frames", "unused"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_trainer(cfg)


def test_unported_options_raise():
    cfg = shrunk_cfg()
    for key, value in (("conditioning", {"mouth_crop": {"enabled": True}}),
                       ("parallel", {"context": 2}),
                       ("parallel", {"pipe": 2})):
        with pytest.raises(NotImplementedError):
            AVDiffusionConfig.from_config({**cfg, key: value})
    with pytest.raises(NotImplementedError):
        AVDiffusionModel(AVDiffusionConfig.from_config(
            {**cfg, "video": {**cfg["video"], "arch": "patch"}}))
    model = AVDiffusionModel(AVDiffusionConfig.from_config(cfg))
    with pytest.raises(NotImplementedError, match="with_recon"):
        model(*(None,) * 8, with_recon=True)
    for key, value in (("recon_loss_weight", 0.5), ("sync_loss_source", "mouth")):
        with pytest.raises(NotImplementedError):
            create_trainer({**cfg, "training": {**cfg["training"], key: value}}, device="cpu")
    with pytest.raises(NotImplementedError):
        create_trainer({**cfg, "parallel": {"model": 2}}, device="cpu")


def test_builtin_config_carries_the_mvp_training_keys(monkeypatch):
    """chip_smoke.py and tools/profile_train.py train from the built-in
    mvp+v2a dict: every key the trainer reads is mvp.yaml's (v2a.yaml
    overlays only sampling, paths, io, streaming and sampler steps)."""
    mvp = load_config(REPO / "configs" / "mvp.yaml")
    built = tio.mvp_v2a_config()
    for key in ("seed", "mixed_precision", "data", "video", "audio", "tokenizer",
                "embeddings", "model", "training", "parallel"):
        assert built[key] == mvp[key], key
    for mod in ("video", "audio"):
        strip = lambda d: {k: v for k, v in d.items() if k != "sampler_steps"}  # noqa: E731
        assert strip(built["diffusion"][mod]) == strip(mvp["diffusion"][mod])
