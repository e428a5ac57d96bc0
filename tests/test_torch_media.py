"""The port's ``media/mpeg_audio.py`` and the antialiased decode shrink,
held against the JAX package:

  * an MPEG-1 program stream written here by ``tools/make_mpg.py`` (MP2
    frames from the bundled libavcodec's ``mp2`` encoder, driven through
    ctypes, wrapped in pack headers, PES packets of every header kind,
    padding, a system header and a video packet): ``demux_ps_audio``, ``split_mp2_frames`` and
    ``read_mpeg_audio`` (mono, both channels, resampled) bit-equal to the
    JAX module's, and the decoded tone equal to what was encoded;
  * ``ops/resize.py`` against ``jax.image.resize(..., "trilinear")`` for a
    shrink, an enlargement, mixed axes and the identity, within 1e-5 (fp32);
  * ``VideoVAE.decode`` to an ``out_size`` smaller than its natural size, on
    both archs, against the JAX decode on the same weights, within 1e-4 (the
    3-D convolutions' tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from multimodal_diffusion_torch.media import mpeg_audio as TMA
from multimodal_diffusion_torch.models.vae_video3d import VideoVAE, VideoVAEConfig
from multimodal_diffusion_torch.ops.resize import resize_antialiased, triangle_weights
from multimodal_diffusion_torch.tools import make_mpg
from multimodal_diffusion_torch.utils.convert import jax_params_to_state_dict
from multimodal_diffusion_tpu.media import mpeg_audio as JMA
from multimodal_diffusion_tpu.models import vae_video3d as JV

SR = make_mpg.SR


# ---------------------------------------------------------------------------
# mpeg_audio on an .mpg written here
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mpg(tmp_path_factory):
    if not (TMA.available() and JMA.available()):
        pytest.skip("no bundled libavcodec of a known version (cv2's ffmpeg libraries)")
    pcm = make_mpg.tone(0.5)
    es = make_mpg.encode_mp2(pcm)
    path = tmp_path_factory.mktemp("mpg") / "clip.mpg"
    make_mpg.write_mpg(path, es)
    return path, es, pcm


def test_mpeg_audio_availability_and_header_tables_match_jax():
    assert TMA.available() == JMA.available()
    rng = np.random.default_rng(0)
    for b in [bytes([0xFF, 0xFD, i, m]) for i in range(256) for m in (0x00, 0xC0)] + \
            [bytes(rng.integers(0, 256, 4, dtype=np.uint8)) for _ in range(200)]:
        assert TMA.parse_mp2_header(b) == JMA.parse_mp2_header(b)


def test_unknown_libavcodec_major_is_unavailable(monkeypatch):
    """Offsets are never guessed: a bundled libavcodec of another major
    makes available() False and the loader raise."""
    monkeypatch.setattr(TMA, "KNOWN_AVCODEC_MAJORS", ())
    monkeypatch.setattr(TMA, "_libs", None)
    assert not TMA.available()
    with pytest.raises(RuntimeError, match="major"):
        TMA._load_ffmpeg()


def test_demux_and_split_are_bit_equal_to_jax(mpg):
    path, es, _ = mpg
    got, want = TMA.demux_ps_audio(path), JMA.demux_ps_audio(path)
    assert got == want == es
    frames, sr, ch = TMA.split_mp2_frames(got)
    assert (frames, sr, ch) == JMA.split_mp2_frames(want)
    assert (sr, ch) == (SR, 1) and len(frames) == len(es) // 288 and len(frames) > 10
    with pytest.raises(ValueError, match="no MP2 frames"):
        TMA.split_mp2_frames(bytes(100))


@pytest.mark.parametrize("sr,mono", [(None, True), (None, False), (16000, True)])
def test_read_mpeg_audio_is_bit_equal_to_jax(mpg, sr, mono):
    path, _, pcm = mpg
    got, got_sr = TMA.read_mpeg_audio(path, sr=sr, mono=mono)
    want, want_sr = JMA.read_mpeg_audio(path, sr=sr, mono=mono)
    assert got_sr == want_sr == (sr or SR)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if sr is None and mono:
        # the decoded tone is the encoded one, after the codec's delay
        ref = pcm.astype(np.float32) / 32768.0
        n = min(len(got), len(ref))
        corr = max(np.corrcoef(got[d:n], ref[:n - d])[0, 1] for d in range(0, 1200))
        assert corr > 0.99


# ---------------------------------------------------------------------------
# the antialiased resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(4, 6, 5), (16, 24, 20), (4, 24, 7), (8, 12, 10), (3, 5, 9)],
                         ids=["shrink", "enlarge", "mixed", "identity", "odd_shrink"])
def test_resize_matches_jax_image_resize(size):
    x = np.random.default_rng(1).normal(size=(2, 3, 8, 12, 10)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, 3) + size, "trilinear"))
    got = resize_antialiased(torch.from_numpy(x), size, (2, 3, 4)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_triangle_weights_columns_sum_to_one():
    for n_in, n_out in ((8, 3), (8, 20), (5, 5), (12, 7)):
        w = triangle_weights(n_in, n_out)
        np.testing.assert_allclose(w.sum(0).numpy(), np.ones(n_out), atol=1e-6)
    assert torch.equal(triangle_weights(6, 6), torch.eye(6))


# ---------------------------------------------------------------------------
# VideoVAE.decode to a smaller out_size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,out_size", [("patch", (4, 20, 32)), ("patch", (6, 16, 40)),
                                           ("conv", (1, 3, 4)), ("conv", (2, 3, 6))],
                         ids=["patch_shrink", "patch_mixed", "conv_shrink", "conv_mixed"])
def test_video_vae_decode_shrinks_as_jax(arch, out_size):
    """The patch arch resizes its decoded frames (natural 8x32x32), the conv
    arch its hidden grid before the blocks (the latent grid 2x4x4): a size
    smaller along some axis antialiases there, as jax.image.resize does."""
    kw = dict(arch=arch, enc_base=8, dec_base=8, hidden=8)
    jvae = JV.VideoVAE(JV.VideoVAEConfig(**kw))
    z = np.random.default_rng(2).normal(size=(2, 8, 2, 4, 4)).astype(np.float32)
    params = meta.unbox(jvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 8, 32, 32)))["params"])
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a)).astype(np.float32), params)
    want = np.asarray(jvae.apply({"params": params}, jnp.asarray(z), out_size,
                                 method=jvae.decode))
    tvae = VideoVAE(VideoVAEConfig(**kw))
    sd = {k[len("vid_vae."):]: v
          for k, v in jax_params_to_state_dict({"vid_vae": params}).items()}
    tvae.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tvae.decode(torch.from_numpy(z), out_size).numpy()
    assert got.shape == want.shape == (2, 3) + out_size
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
