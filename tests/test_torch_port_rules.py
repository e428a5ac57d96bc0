"""Rules the port keeps: it imports nothing of JAX or the JAX package, the
weight converter consumes every JAX leaf exactly once, its built-in configs
are the merged mvp+v2a and mvp+specificity8 YAMLs, its entry points refuse to
run on the CPU unless asked to, and options of later slices raise."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import jax_model_and_params, shrunk_cfg, shrunk_flagship_cfg
from multimodal_diffusion_torch.infer import sample_clip
from multimodal_diffusion_torch.models.diffusion import AVDiffusionConfig, AVDiffusionModel
from multimodal_diffusion_torch.train import train_joint
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


@pytest.mark.parametrize("make_cfg", [shrunk_cfg, shrunk_flagship_cfg],
                         ids=["mvp", "flagship"])
def test_converter_consumes_every_leaf_once(make_cfg):
    """Also the flagship's leaves: vid_vae.patch_embed / patch_norm /
    unpatch_proj, adapt_m, embed.pos_m and the three-row modality table."""
    import jax

    cfg = make_cfg()
    _, params = jax_model_and_params(cfg)
    leaves = jax.tree_util.tree_leaves(params)
    sd = jax_params_to_state_dict(params)
    assert len(sd) == len(leaves)
    model = AVDiffusionModel(AVDiffusionConfig.from_config(cfg))
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == sum(np.size(x) for x in leaves)
    if make_cfg is shrunk_flagship_cfg:
        assert {"vid_vae.patch_embed.weight", "vid_vae.patch_norm.weight",
                "vid_vae.unpatch_proj.bias", "adapt_m.proj.weight",
                "embed.pos_m.t_table"} <= set(sd)
        assert sd["embed.modality.table"].shape[0] == 3
        assert "vid_vae.to_img.weight" not in sd


@pytest.mark.parametrize("path,key", [
    (("core", "block_3", "RMSNorm_0", "scale"), "core.blocks.3.norm1.weight"),
    (("core", "block_3", "LayerNorm_1", "bias"), "core.blocks.3.norm2.bias"),
    (("core", "RMSNorm_0", "scale"), "core.norm.weight"),
    (("head", "shared_1", "LayerNorm_0", "scale"), "head.shared.1.norm.weight"),
    (("vid_vae", "enc_0", "Conv_0", "kernel"), "vid_vae.enc.0.conv.weight"),
    (("t_embed", "Dense_1", "kernel"), "t_embed.fc2.weight"),
    (("vid_vae", "patch_norm", "scale"), "vid_vae.patch_norm.weight"),
    (("vid_vae", "unpatch_proj", "kernel"), "vid_vae.unpatch_proj.weight"),
    (("adapt_m", "proj", "kernel"), "adapt_m.proj.weight"),
    (("embed", "pos_m", "h_table"), "embed.pos_m.h_table"),
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


def test_builtin_config_is_mvp_plus_specificity8():
    assert tio.specificity8_config() == load_config(REPO / "configs" / "mvp.yaml",
                                                    REPO / "configs" / "specificity8.yaml")
    assert tio.load_config(REPO / "configs" / "mvp.yaml",
                           REPO / "configs" / "specificity8.yaml") == tio.SPECIFICITY8_CONFIG
    assert tio.builtin_config("specificity8") == tio.SPECIFICITY8_CONFIG
    assert tio.builtin_config("mvp") == tio.MVP_V2A_CONFIG
    cfg = tio.specificity8_config()
    cfg["seed"] = -1  # a copy: the built-in tree is untouched
    assert tio.SPECIFICITY8_CONFIG["seed"] == 42
    with pytest.raises(ValueError, match="mvp|specificity8"):
        tio.builtin_config("t2i")


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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_joint.main(["--config", str(REPO / "configs" / "mvp.yaml"),
                          str(REPO / "configs" / "specificity8.yaml")])


def test_unported_options_raise(monkeypatch):
    """Exactly these still raise NotImplementedError: parallel.context,
    parallel.pipe, parallel.model > 1, parallel.remat_core, quant: int8, the
    variational VAE, train_joint under WORLD_SIZE > 1 and restoring an orbax
    checkpoint."""
    from multimodal_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
    from multimodal_diffusion_torch.models.vae_video3d import VideoVAE, VideoVAEConfig

    cfg = shrunk_cfg()
    for key in ("context", "pipe"):
        with pytest.raises(NotImplementedError):
            AVDiffusionConfig.from_config({**cfg, "parallel": {key: 2}})
    with pytest.raises(NotImplementedError):
        create_trainer({**cfg, "parallel": {"model": 2}}, device="cpu")
    with pytest.raises(NotImplementedError, match="remat_core"):
        create_trainer({**cfg, "parallel": {"remat_core": True}}, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="WORLD_SIZE"):
        train_joint.main(["--config", str(REPO / "configs" / "mvp.yaml"), "--device", "cpu"])
    with pytest.raises(NotImplementedError):
        MMDiT(MMDiTConfig(d_model=64, n_layers=1, n_heads=4, quant="int8"))
    with pytest.raises(NotImplementedError):
        VideoVAE(VideoVAEConfig(variational=True))


def test_orbax_checkpoint_restore_raises(tmp_path):
    (tmp_path / "7").mkdir()  # a step directory without the port's params.pt
    cfg = {**shrunk_cfg(), "paths": {"ckpt_path": str(tmp_path / "latest")}}
    with pytest.raises(NotImplementedError, match="orbax"):
        sample_clip.build_components(cfg, device="cpu")


def test_flagship_options_build():
    """The specificity8 keys that used to raise: arch patch, mouth_crop,
    with_recon, recon_loss_weight, recon_every, sync_loss_source mouth,
    dpmpp_2m and sync guidance all build (the full-width config too, on the
    meta device: no memory is taken)."""
    from multimodal_diffusion_torch.infer.ddim import sampler_from_config

    cfg = shrunk_flagship_cfg()
    cfg["training"]["sync_loss_source"] = "mouth"
    cfg["sampling"].update(sampler="dpmpp_2m", sync_guidance_scale=0.5)
    bundle = create_trainer(cfg, device="cpu", batch_size=2)
    sc = bundle.step_config
    assert (sc.sync_source, sc.recon_every, sc.recon_weight) == ("mouth", 2, 1.0)
    assert sc.mouth_time_chunks == 8 and bundle.model.cfg.mouth_enabled
    sampler_from_config(cfg, "audio")
    with torch.device("meta"):
        full = AVDiffusionModel(AVDiffusionConfig.from_config(tio.specificity8_config()))
    c = full.cfg
    assert (c.width, c.core.n_layers, c.core.n_heads, c.vae.arch) == (1024, 16, 8, "patch")
    assert c.vae.patch_dim == 768 and c.vae.patch_hidden == 128 and c.token_dim_mouth == 768
    assert full.mouth_grid(48) == (48, 2, 3)  # 288 mouth tokens; N = 96 + 37 + 288 = 421


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
