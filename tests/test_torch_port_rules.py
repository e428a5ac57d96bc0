"""Rules the port keeps: it imports nothing of JAX or the JAX package (nor
orbax, tensorstore or zstandard, which it reads checkpoints without), the
weight converter consumes every JAX leaf exactly once, its built-in configs
are the merged mvp+v2a and mvp+specificity8 YAMLs, its entry points refuse to
run on the CPU unless asked to, and the layouts the JAX package refuses
raise."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import jax_model_and_params, shrunk_cfg, shrunk_flagship_cfg
from multimodal_diffusion_torch.infer import sample_clip, sample_t2i
from multimodal_diffusion_torch.models.diffusion import AVDiffusionConfig, AVDiffusionModel
from multimodal_diffusion_torch.serve import runner
from multimodal_diffusion_torch.tools import (bench, eval_av_quality, latent_probe, mfu_probe,
                                            quant_probe)
from multimodal_diffusion_torch.train import train_joint
from multimodal_diffusion_torch.train.trainer import create_trainer
from multimodal_diffusion_torch.utils import io as tio
from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict, torch_key
from multimodal_diffusion_tpu.utils.io import load_config

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
             "multimodal_diffusion_tpu"}
# the multi-rank tests' rank bodies run in spawned processes: no JAX there either
PORT_FILES = sorted((REPO / "multimodal_diffusion_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "_torch_dist.py"]


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
    (("text_encoder", "core", "block_0", "RMSNorm_1", "scale"),
     "text_encoder.core.blocks.0.norm2.weight"),
    (("text_encoder", "core", "RMSNorm_0", "scale"), "text_encoder.core.norm.weight"),
    (("text_encoder", "Embed_0", "embedding"), "text_encoder.token_embed.embedding"),
    (("vae", "enc_0_0", "GroupNorm_1", "bias"), "vae.enc_0_0.norm2.bias"),
    (("vae", "dec_mid", "Conv_2", "kernel"), "vae.dec_mid.conv3.weight"),
    (("vae", "enc_down_1", "kernel"), "vae.enc_down_1.weight"),
    (("head", "block_0", "LayerNorm_0", "scale"), "head.blocks.0.norm.weight"),
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_t2i.main(["--config", str(REPO / "configs" / "t2i_512.yaml"),
                         "--prompt", "a red fox"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_t2i.build_t2i(load_config(REPO / "configs" / "t2i_512.yaml"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.InferenceRunner(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.main(["--config", str(REPO / "configs" / "mvp.yaml"),
                     str(REPO / "configs" / "specificity8.yaml"), "--manifest", "unused.json"])
    # the repo's own entry points on the port (tools/); preprocess_audio and
    # supervise run on the host only and take no device
    mvp = str(REPO / "configs" / "mvp.yaml")
    for main, argv in ((bench.main, []), (bench.main, ["--task", "t2i", "--serving"]),
                       (bench.main, ["--task", "train"]),
                       (eval_av_quality.main, ["--config", mvp]),
                       (latent_probe.main, ["--config", mvp]),
                       (quant_probe.main, []), (mfu_probe.main, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


def test_unported_options_raise():
    """The layouts run now (tests/test_torch_parallel.py,
    tests/test_torch_ring_pipeline.py); what still refuses, as the JAX
    package refuses it: a layout larger than the world (one process with
    parallel.data 2: ValueError, as make_mesh), pipe with context
    (ValueError), attention dropout under context and pipelined training
    with dropout (NotImplementedError). Meshes of two ranks are laid out
    here without process groups: each refusal comes before any transfer."""
    from multimodal_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig, set_dropout_generator
    from multimodal_diffusion_torch.parallel.mesh import make_mesh

    cfg = shrunk_cfg()
    for par in ({"data": 2}, {"data": -1, "model": 2}, {"data": 1, "context": 2}):
        with pytest.raises(ValueError, match="needs more than 1 devices|not divisible"):
            create_trainer({**cfg, "parallel": par}, device="cpu")
    assert create_trainer({**cfg, "parallel": {"data": -1}}, device="cpu").mesh.shape == {
        "data": 1, "model": 1}
    two = make_mesh(data=1, context=2, pipe=2, world=4, rank=0)
    with pytest.raises(ValueError, match="cannot be combined"):
        AVDiffusionConfig.from_config({**cfg, "parallel": {"context": 2, "pipe": 2}}, mesh=two)
    core = dict(d_model=16, n_layers=2, n_heads=2, dropout=0.0)
    x = torch.zeros(1, 4, 16)
    ctx = make_mesh(data=1, context=2, world=2, rank=0)
    net = MMDiT(MMDiTConfig(**core | {"attn_dropout": 0.1}, mesh=ctx, context_axis="context"))
    set_dropout_generator(net, torch.Generator())
    with pytest.raises(NotImplementedError, match="attn_dropout"):
        net.train()(x)
    pipe = make_mesh(data=1, pipe=2, world=2, rank=0)
    net = MMDiT(MMDiTConfig(**core | {"dropout": 0.1}, mesh=pipe, pipe_axis="pipe"))
    set_dropout_generator(net, torch.Generator())
    with pytest.raises(NotImplementedError, match="dropout == 0"):
        net.train()(x)


def test_orbax_checkpoint_restores(tmp_path):
    """A step directory the JAX package's CheckpointManager wrote, found
    through <dir>/latest as before, now restores (the committed fixture,
    copied as step 7); a step directory of neither kind still raises."""
    import shutil

    from _torch_orbax import FIXTURE, FIXTURE_STEPS
    from multimodal_diffusion_torch.train.checkpoint import jax_params_only
    from multimodal_diffusion_torch.train.orbax_reader import read_orbax_step

    shutil.copytree(FIXTURE / "ckpt" / str(FIXTURE_STEPS), tmp_path / "7")
    cfg = {**tio.load_config(FIXTURE / "config.yaml"),
           "paths": {"ckpt_path": str(tmp_path / "latest")}}
    model = sample_clip.build_components(cfg, device="cpu")
    want = jax_params_only(read_orbax_step(tmp_path / "7"))
    assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())
    (tmp_path / "8").mkdir()  # neither params.pt nor default/_METADATA
    with pytest.raises(FileNotFoundError, match="orbax"):
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
