"""CogVideoX on a CUDA card only (marker `gpu`; every test skips without a
card): the flash forward at the cell's shape [2, 48, 17 776, 64] against its
plain blockwise version, one transformer block and one decoder frame batch
at CogVideoX-5B's published widths against the plain float32 reference
(``benchmark/reference/cogvideox_sampling.py``), and the flash launches of a
transformer pass. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cogvideox_gpu.py
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark.chunked_weights import make_weights_by_tensor
from benchmark.reference import cogvideox_sampling as ref
from multimodal_diffusion_torch.infer.sample_cogvideox import build_cogvideox
from multimodal_diffusion_torch.models import cogvideox
from multimodal_diffusion_torch.models.cogvideox_vae import Decoder3D, VAEConfig
from multimodal_diffusion_torch.ops import cuda_kernels as ck
from multimodal_diffusion_torch.ops import flash_attention as fa

CFG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                  / "cogvideox-5b.json").read_text())["config"]
TEXT, FRAMES, ROWS, COLS = 226, 13, 30, 45  # N = 226 + 17 550 = 17 776


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ref.no_tf32()
    return torch.device("cuda")


def rel(got, want):
    return float((got.float() - want).norm() / want.norm())


def one_block_cfg(layers=1):
    return dict(CFG, model=dict(CFG["model"], core=dict(CFG["model"]["core"], n_layers=layers)))


@pytest.mark.gpu
def test_flash_fwd_at_the_cell_shape(cuda):
    """bf16 out: 2e-2 (one bf16 rounding of out); lse fp32 on both paths."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((2, 48, TEXT + FRAMES * ROWS * COLS, 64), generator=gen,
                           device=cuda).to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_forward(q, k, v)
    want, want_lse = fa.flash_forward_reference(q, k, v)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_block_matches_the_reference_at_published_widths(cuda):
    """One block of CogVideoX-5B over the cell's 17 776 joint tokens and a
    CFG batch of 2, bf16 weights and GEMM operands through the flash kernel,
    against the float32 reference block: the streams' update within 3e-2 of
    its size (bf16 operands, one rounding of q, k, v and the attention)."""
    cfg = one_block_cfg()
    W = make_weights_by_tensor(ref.param_shapes(cfg), 21, cuda, ref.is_norm_scale)
    model, _ = build_cogvideox(cfg, cuda, W)
    blk = model.transformer_blocks[0]
    gen = torch.Generator(device=cuda).manual_seed(22)
    video = torch.randn(2, FRAMES * ROWS * COLS, 3072, generator=gen, device=cuda)
    text = torch.randn(2, TEXT, 3072, generator=gen, device=cuda)
    emb = torch.randn(2, 512, generator=gen, device=cuda)
    ids = cogvideox.position_ids(TEXT, FRAMES, ROWS, COLS, cuda)
    pe = cogvideox.rope_tables(ids, (16, 24, 24), 10_000.0)
    before = ck.LAUNCHES["flash_fwd"]
    with torch.inference_mode():
        got_v, got_t = blk(video, text, emb, pe)
    assert ck.LAUNCHES["flash_fwd"] == before + 1
    s = ref.dims(cfg)
    want_v, want_t = ref.block(W, s, 0, video, text, emb, ref.rope(s, FRAMES, ROWS, COLS, cuda))
    got = torch.cat((got_t, got_v), 1) - torch.cat((text, video), 1)
    want = torch.cat((want_t, want_v), 1) - torch.cat((text, video), 1)
    r = rel(got, want)
    assert r < 3e-2, r


@pytest.mark.gpu
def test_decoder_frame_batch_matches_the_reference(cuda):
    """The first frame batch (3 latent frames of 60 x 90 -> 9 frames of 480 x
    720) of the published decoder in bf16 convolutions against the float32
    reference decoder: 3e-2 of the output's size, and the caches each
    carries for the next batch hold 2 frames."""
    W = make_weights_by_tensor(ref.param_shapes(CFG), 31, cuda, ref.is_norm_scale)
    vae_sd = {k[len("vae."):]: v for k, v in W.items() if k.startswith("vae.decoder.")}
    with torch.device("meta"):
        dec = Decoder3D(VAEConfig.from_config(CFG))
    dec.load_state_dict({k[len("decoder."):]: v for k, v in vae_sd.items()}, strict=True,
                        assign=True)
    z = torch.randn(1, 16, 3, 60, 90, generator=torch.Generator(device=cuda).manual_seed(32),
                    device=cuda)
    cache = {}
    with torch.inference_mode():
        got = dec(z.to(torch.bfloat16), cache)
    want = ref.decode_batch(W, ref.dims(CFG), z, {})
    assert got.shape == (1, 3, 9, 480, 720) == want.shape
    assert {t.shape[2] for t in cache.values()} == {2}
    r = rel(got, want)
    assert r < 3e-2, r


@pytest.mark.gpu
def test_a_pass_launches_the_flash_kernel_once_a_block(cuda):
    """The published 42 blocks (seeded weights) on one latent frame: 42
    flash forward launches a transformer pass, all of the warp-specialised
    kernel (N = 226 + 1350 = 1576)."""
    model, _ = build_cogvideox(CFG, cuda, seed=5)
    x = torch.randn(2, 1, 16, 60, 90, device=cuda)
    ctx = torch.randn(2, TEXT, 4096, device=cuda, dtype=torch.bfloat16)
    before = ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_fwd_ws"]
    with torch.inference_mode():
        out = model(x, ctx, torch.tensor([999, 999], device=cuda))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["flash_fwd"] - before[0] == 42
    assert ck.LAUNCHES["flash_fwd_ws"] - before[1] == 42
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
