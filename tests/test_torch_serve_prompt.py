"""The serving runner's in-memory prompt on the CPU (tiny config,
device="cpu", max_batch=2): a request that hands its prompt in as an array
gives the same work items and the same outputs, bit for bit, as one that
names a file holding it, and without an output path its outputs stay in
its items and nothing is written."""

import numpy as np
import pytest

from multimodal_diffusion_torch.media.audio_io import read_wav, write_wav
from multimodal_diffusion_torch.media.video_io import load_frames_dir, write_frames
from multimodal_diffusion_torch.serve import runner as TR
from tests._tiny import tiny_cfg

WAIT = 120


@pytest.fixture(scope="module")
def runner():
    cfg = tiny_cfg()
    cfg["paths"] = {}
    r = TR.InferenceRunner(cfg, max_batch=2, bf16_params=False, device="cpu")
    yield r
    r.close()


def _serve(runner, req):
    runner.submit(req)
    assert req.done.wait(timeout=WAIT) and req.error is None, req.error
    return req


@pytest.mark.parametrize("direction", ["v2a", "a2v", "stream_v2a"])
def test_in_memory_prompt_serves_what_the_file_serves(runner, tmp_path, direction):
    rng = np.random.default_rng(7)
    if direction == "a2v":
        path = tmp_path / "in.wav"
        write_wav(path, rng.uniform(-0.5, 0.5, 8000).astype(np.float32), 8000)
        prompt = read_wav(path, sr=8000)[0]
        out = tmp_path / "out_frames"
    else:
        path = tmp_path / "frames"
        write_frames(rng.integers(0, 255, (16, 32, 32, 3), dtype=np.uint8), path)
        prompt = load_frames_dir(path, size_hw=(32, 32))
        out = tmp_path / "out.wav"
    if direction == "stream_v2a":
        runner.win_s, runner.hop_s, runner.xfade_s = 1.0, 0.5, 0.25
    from_file = _serve(runner, TR.Request(id="f", direction=direction, input_path=str(path),
                                          output_path=str(out)))
    in_memory = _serve(runner, TR.Request(id="m", direction=direction, prompt=prompt))
    assert len(from_file.items) == len(in_memory.items) >= 1
    for a, b in zip(from_file.items, in_memory.items):
        assert a.key == b.key
        np.testing.assert_array_equal(a.prompt, b.prompt)
        np.testing.assert_array_equal(a.out, b.out)
    assert out.exists()  # the file request wrote its output; the other wrote nothing
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [path.name, out.name])


def test_a_request_without_a_prompt_fails_alone(runner):
    req = runner.submit(TR.Request(id="none", direction="v2a"))
    assert req.done.wait(timeout=WAIT)
    assert req.error is not None and req.error.startswith("load:")
