"""The denoiser's captured CUDA graphs (models/graphed.py).

On the CPU: which calls run eagerly and why, what makes a new key, the
least-recently-used limit (with a stand-in for the capture), the spans of a
warm-up, a capture and a replay, and that the samplers still call
``model.denoise_tokens`` through the instance once a pass.

On a CUDA card only (marker `gpu`; skipped without one): replays against
the eager pass at the mvp width and at the flagship's widths with two
layers, both directions, with and without mouth tokens, int8 and sinusoid
positions; outputs that outlive the next replay; a recapture after an
in-place weight update; the flash forward's and RMSNorm's launch counters; the ctypes
launch captured in global mode; a sync-guided sampler that replays its CFG
forward. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_graphed_denoiser.py
"""

import collections
import contextlib
import time
import types

import pytest
import torch

from multimodal_diffusion_torch.infer.ddim import sampler_from_config
from multimodal_diffusion_torch.infer.sample_clip import build_components
from multimodal_diffusion_torch.models import adapters, graphed
from multimodal_diffusion_torch.ops import cuda_kernels as ck
from multimodal_diffusion_torch.ops import flash_attention as fa
from multimodal_diffusion_torch.ops.attention import attention_path
from multimodal_diffusion_torch.utils import profiling as TP
from multimodal_diffusion_torch.utils.io import (deep_update, latent_shapes_from_config,
                                               mvp_v2a_config, shrunk_config,
                                               specificity8_config)

B = 2


def flagship(n_layers: int = 2) -> dict:
    """The flagship's widths (d 1024, 8 heads of 128, mouth tokens, patch
    VAE) with `n_layers` core layers."""
    return deep_update(specificity8_config(), {"model": {"core": {"n_layers": n_layers}}})


def shrunk_mouth() -> dict:
    """The shrunk mvp with a mouth-crop stream (12 x 16 box, 6 tokens a
    frame)."""
    return deep_update(shrunk_config(), {"conditioning": {"mouth_crop": {
        "enabled": True, "box": [16, 28, 8, 24], "tube": {"t": 1, "h": 4, "w": 8}}}})


def call_args(model, cfg, direction="v2a", mouth=True, seed=0, device="cpu"):
    """A denoise_tokens call as the sampler makes it: the CFG-doubled batch
    (cond, then null), the target at a step drawn from `seed`."""
    s = latent_shapes_from_config(cfg, B)
    g = torch.Generator(device=device).manual_seed(seed)
    z_v = torch.randn(s["z_video"], generator=g, device=device)
    z_a = torch.randn(s["z_audio"], generator=g, device=device)
    two = lambda t: torch.cat([t, t])  # noqa: E731
    ones = torch.ones(2 * B, device=device)
    cond = torch.cat([torch.ones(B, device=device), torch.zeros(B, device=device)])
    t = torch.full((2 * B,), 100 + 37 * seed, dtype=torch.long, device=device)
    zero = torch.zeros(2 * B, dtype=torch.long, device=device)
    tok_v, tok_a = two(model.tokenize_video(z_v)), two(model.tokenize_audio(z_a))
    if direction == "v2a":
        args = (tok_v, tok_a, zero, t, model.video_grid(z_v.shape), cond, ones)
    else:
        args = (tok_v, tok_a, t, zero, model.video_grid(z_v.shape), ones, cond)
    kw = {}
    if mouth and model.cfg.mouth_enabled:
        video = torch.rand(s["video"], generator=g, device=device)
        kw = {"tok_m": two(model.mouth_tokens(video)),
              "keep_m": cond if direction == "v2a" else torch.zeros(2 * B, device=device),
              "mouth_grid": model.mouth_grid(s["video"][2])}
    return args, kw


@pytest.fixture(scope="module")
def cpu_model():
    torch.manual_seed(0)
    cfg = shrunk_mouth()
    return cfg, build_components(cfg, device="cpu")


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def eager(model, args, kw):
    """The pass without a graph, on the current stream."""
    return model._denoise_tokens(*args, tok_m=kw.get("tok_m"), keep_m=kw.get("keep_m"),
                                 mouth_grid=kw.get("mouth_grid"))


def _tensors(args, kw):
    tok_v, tok_a, t_v, t_a, _, keep_v, keep_a = args
    return {"tok_v": tok_v, "tok_a": tok_a, "t_v": t_v, "t_a": t_a, "keep_v": keep_v,
            "keep_a": keep_a, "tok_m": kw.get("tok_m"), "keep_m": kw.get("keep_m")}


@pytest.mark.parametrize("case,reason", [
    ("cpu", "operands off CUDA"),
    ("training", "training mode"),
    ("grad", "grad enabled"),
    ("dense", "dense attention"),
    ("layout", "core layout over several ranks"),
])
def test_ineligible_calls_run_eagerly(cpu_model, monkeypatch, case, reason):
    """Each rule alone sends the call down the eager path: the cache stays
    empty and the result is the plain pass's."""
    cfg, model = cpu_model
    args, kw = call_args(model, cfg)
    if case == "training":
        monkeypatch.setattr(model, "training", True)
    if case == "layout":
        monkeypatch.setattr(model.core, "layout",
                            types.SimpleNamespace(tp_n=2, ctx_n=1, pipe_n=1))
    model.graphs.calls.clear()
    with attention_path("dense" if case == "dense" else None), \
            torch.set_grad_enabled(case == "grad"):
        assert graphed.ineligible(model, _tensors(args, kw)) == reason
        if case in ("cpu", "grad", "dense"):
            got = model.denoise_tokens(*args, **kw)
            want = eager(model, args, kw)
            for name in want:
                torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    assert not model.graphs.calls


@pytest.mark.parametrize("change", ["same", "shape", "mouth_none", "keep_none", "grid",
                                    "inference_mode", "in_place", "load_state_dict",
                                    "assign", "repoint"])
def test_key_changes_with_what_fixes_the_graph(change):
    torch.manual_seed(0)
    cfg = shrunk_mouth()
    model = build_components(cfg, device="cpu")
    graphs = model.graphs
    args, kw = call_args(model, cfg)
    statics = (tuple(args[4]), tuple(kw["mouth_grid"]))
    before = graphs.key(model, _tensors(args, kw), statics)
    tensors = _tensors(args, kw)
    if change == "shape":
        tensors["tok_a"] = tensors["tok_a"][:, :-1]
    elif change == "mouth_none":
        tensors["tok_m"] = tensors["keep_m"] = None
    elif change == "keep_none":
        tensors["keep_v"] = None
    elif change == "grid":
        statics = ((statics[0][0] + 1,) + statics[0][1:], statics[1])
    elif change == "in_place":
        with torch.no_grad():
            model.core.blocks[0].attn.qkv.weight.mul_(1.0)
    elif change in ("load_state_dict", "assign"):
        # assign: new tensors in the parameters' places
        model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()},
                              assign=change == "assign")
    elif change == "repoint":
        p = next(model.head.parameters())
        p.data = p.data.clone()
    with torch.inference_mode(change == "inference_mode"):
        after = graphs.key(model, tensors, statics)
    assert (after == before) == (change == "same")
    if change in ("in_place", "load_state_dict", "assign", "repoint"):
        assert after[0] == before[0] and after[1] != before[1]


class StandIn:
    """A captured call without a card: counts its replays."""

    def __init__(self, fn, tensors):
        self.fn, self.replays = fn, 0

    def replay(self, tensors):
        self.replays += 1
        return self.fn(**tensors)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphed.DenoiserGraphs, "_warm_up", lambda self, fn, t: fn(**t))
    monkeypatch.setattr(graphed.DenoiserGraphs, "_capture",
                        lambda self, fn, t: StandIn(fn, t))


def _toy(n):
    """A function and a call's tensors of `n` tokens."""
    return (lambda x: {"y": x * 2}), {"x": torch.ones(n)}


def test_least_recently_used_key_goes_first(stand_in):
    model = torch.nn.Linear(2, 2)
    graphs = graphed.DenoiserGraphs()
    for n in range(1, graphed.MAX_KEYS + 1):
        fn, tensors = _toy(n)
        assert torch.equal(graphs(model, fn, tensors, ())["y"], 2 * tensors["x"])
        assert list(graphs.calls.values())[-1] is None  # warmed up, not captured
        graphs(model, fn, tensors, ())
    assert all(isinstance(c, StandIn) for c in graphs.calls.values())
    graphs(model, *_toy(1), ())  # used again: 2 is now the oldest
    graphs(model, *_toy(9), ())
    assert [k[0][0][0][0][0] for k in graphs.calls] == [3, 4, 1, 9]


def test_new_weights_replace_the_graph_of_their_shapes(stand_in):
    model = torch.nn.Linear(2, 2)
    graphs = graphed.DenoiserGraphs()
    for _ in range(3):
        graphs(model, *_toy(5), ())
    (call,) = graphs.calls.values()
    assert call.replays == 2
    with torch.no_grad():
        model.weight.add_(1.0)
    graphs(model, *_toy(5), ())
    assert list(graphs.calls.values()) == [None]


def test_spans_of_warm_up_capture_and_replay(stand_in):
    model = torch.nn.Linear(2, 2)
    graphs = graphed.DenoiserGraphs()
    children = []
    for _ in range(3):
        with TP.span("ddim.denoiser") as outer:
            graphs(model, *_toy(3), ())
        children.append([s.name for s in TP.spans() if s.parent == outer._id])
    assert children == [[], ["denoiser.capture", "denoiser.replay"], ["denoiser.replay"]]


def test_a_capture_takes_back_its_count_and_each_replay_adds_it(monkeypatch):
    """What a capture counts, of any kernel's name, is taken out of the
    registry and handed to the captured call, which adds exactly that at
    each replay (the capture here is a stand-in: no card)."""
    graph = types.SimpleNamespace(replay=lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *args, **kw: contextlib.nullcontext())
    monkeypatch.setattr(graphed.DenoiserGraphs, "_stream", lambda self, device: None)
    counted = collections.Counter(flash_fwd=2, rms_norm=5, a_later_kernel=1)

    def fn(x):
        ck.LAUNCHES.update(counted)
        return {"y": x * 2}

    before = ck.LAUNCHES.copy()
    call = graphed.DenoiserGraphs()._capture(fn, {"x": torch.ones(3)})
    assert ck.LAUNCHES == before and call.launches == counted
    for _ in range(2):
        call.replay({"x": torch.ones(3)})
    assert ck.LAUNCHES == before + counted + counted


def test_a_copy_of_the_model_starts_without_graphs(cpu_model, stand_in):
    import copy

    _, model = cpu_model
    model.graphs(model, *_toy(2), ())
    assert model.graphs.calls
    twin = copy.deepcopy(model)
    assert not twin.graphs.calls
    model.graphs.calls.clear()


@pytest.mark.parametrize("direction,sync", [("audio", 0.0), ("video", 0.0), ("audio", 0.5)])
def test_samplers_call_denoise_tokens_through_the_instance(cpu_model, direction, sync):
    """A wrapper put on the instance, as the benchmark's planted faults are,
    sees every pass: one CFG call a step, and one more under sync guidance
    (its gradient forward)."""
    cfg, model = cpu_model
    steps = 3
    cfg = deep_update(cfg, {"diffusion": {direction: {"sampler_steps": steps}},
                            "sampling": {"sync_guidance_scale": sync}})
    sample, _ = sampler_from_config(cfg, direction)
    s = latent_shapes_from_config(cfg, B)
    prompt, target = (("z_video", "z_audio") if direction == "audio"
                      else ("z_audio", "z_video"))
    g = torch.Generator().manual_seed(3)
    z_prompt, z_init = (torch.randn(s[k], generator=g) for k in (prompt, target))
    calls = []
    denoise = model.denoise_tokens

    def counting(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return denoise(*args, **kwargs)

    model.denoise_tokens = counting
    try:
        sample(model, z_prompt, z_init)
    finally:
        del model.denoise_tokens
    assert len(calls) == steps * (2 if sync else 1)
    assert calls.count(True) == (steps if sync else 0)


def test_sinusoid_positions_are_kept_on_the_device():
    with torch.inference_mode():
        a = adapters.sinusoid_on(7, 6, torch.device("cpu"))
    assert not a.is_inference()
    assert adapters.sinusoid_on(7, 6, torch.device("cpu")) is a
    assert torch.equal(a, torch.from_numpy(adapters.sinusoid_table(7, 6)))


# ---------------------------------------------------------------------------
# on a CUDA card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_model(cfg):
    torch.manual_seed(0)
    return build_components(cfg, device="cuda", bf16_params=True)


CARD_CONFIGS = {
    "mvp": mvp_v2a_config,
    "flagship": flagship,
    "mvp_int8": lambda: deep_update(mvp_v2a_config(), {"model": {"core": {"quant": "int8"}}}),
    "mvp_sin": lambda: deep_update(mvp_v2a_config(), {
        "embeddings": {"posenc": {"video": "sin", "audio": "sin"}}}),
}


def assert_same(got, want):
    """bf16 compute: the graph replays the eager launches, so equal up to
    the kernels' own run-to-run rounding (2e-2, the GPU tests' bf16
    tolerance)."""
    assert got.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(got[name].float(), want[name].float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("config,direction,mouth", [
    ("mvp", "v2a", False), ("mvp", "a2v", False),
    ("flagship", "v2a", True), ("flagship", "a2v", True), ("flagship", "v2a", False),
    ("mvp_int8", "v2a", False), ("mvp_sin", "v2a", False)])
def test_replay_matches_the_eager_pass(cuda, config, direction, mouth):
    cfg = CARD_CONFIGS[config]()
    model = card_model(cfg)
    with torch.inference_mode():
        for seed in range(4):  # warm-up, capture, replays on new inputs
            args, kw = call_args(model, cfg, direction, mouth, seed, cuda)
            assert_same(model.denoise_tokens(*args, **kw), eager(model, args, kw))
    (call,) = model.graphs.calls.values()
    assert isinstance(call, graphed.CapturedCall)


@pytest.mark.gpu
def test_outputs_outlive_the_next_replay(cuda):
    cfg = mvp_v2a_config()
    model = card_model(cfg)
    with torch.inference_mode():
        args, kw = call_args(model, cfg, seed=0, device=cuda)
        for _ in range(2):
            model.denoise_tokens(*args, **kw)
        first = model.denoise_tokens(*args, **kw)
        kept = {k: v.clone() for k, v in first.items()}
        later = model.denoise_tokens(*call_args(model, cfg, seed=1, device=cuda)[0], **kw)
        for name in kept:
            assert torch.equal(first[name], kept[name])
        assert not torch.equal(later["eps_a"], first["eps_a"])


@pytest.mark.gpu
def test_an_in_place_weight_update_recaptures(cuda):
    cfg = mvp_v2a_config()
    model = card_model(cfg)
    with torch.inference_mode():
        args, kw = call_args(model, cfg, seed=0, device=cuda)
        for _ in range(3):
            old = model.denoise_tokens(*args, **kw)
    with torch.no_grad():
        model.core.blocks[0].attn.qkv.weight.mul_(1.5)
    with torch.inference_mode():
        for _ in range(3):
            got = model.denoise_tokens(*args, **kw)
            assert_same(got, eager(model, args, kw))
    assert not torch.allclose(got["eps_a"].float(), old["eps_a"].float())
    assert len(model.graphs.calls) == 1


@pytest.mark.gpu
def test_launch_counter_counts_kernel_executions(cuda):
    cfg = flagship()
    model = card_model(cfg)
    layers = cfg["model"]["core"]["n_layers"]
    norms = 2 * layers + 1  # two a block and the final norm
    ck.LAUNCHES.clear()
    with torch.inference_mode():
        args, kw = call_args(model, cfg, seed=0, device=cuda)
        for k in range(1, 5):
            model.denoise_tokens(*args, **kw)
            assert ck.LAUNCHES["flash_fwd"] == k * layers
            assert ck.LAUNCHES["rms_norm"] == k * norms
    (call,) = model.graphs.calls.values()
    assert call.launches == {"flash_fwd": layers, "rms_norm": norms}


@pytest.mark.gpu
def test_the_flash_launch_is_captured_in_global_mode(cuda):
    """The ctypes launch (cudaSetDevice, cudaFuncSetAttribute, the kernel on
    the current stream) under the strictest capture mode."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((4, 8, 133, 64), generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    want, _ = fa.flash_forward(q, k, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_forward(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        out, _ = fa.flash_forward(q, k, v)
    out.zero_()
    graph.replay()
    assert torch.equal(out, want)


@pytest.mark.gpu
def test_sync_guided_sampler_replays_its_cfg_forward(cuda, monkeypatch):
    steps = 4
    cfg = deep_update(flagship(), {"diffusion": {"audio": {"sampler_steps": steps}},
                                   "sampling": {"sync_guidance_scale": 0.5}})
    model = card_model(cfg)
    sample, _ = sampler_from_config(cfg, "audio")
    s = latent_shapes_from_config(cfg, B)
    g = torch.Generator(device=cuda).manual_seed(5)
    z_prompt = torch.randn(s["z_video"], generator=g, device=cuda)
    z_init = torch.randn(s["z_audio"], generator=g, device=cuda)
    video = torch.rand(s["video"], generator=g, device=cuda)
    tok_m = model.mouth_tokens(video)
    t0 = time.time_ns()
    got = sample(model, z_prompt, z_init, tok_mouth=tok_m)
    replays = [x for x in TP.spans() if x.name == "denoiser.replay" and x.start_ns >= t0]
    assert len(replays) == steps - 1
    monkeypatch.setattr(graphed, "ineligible", lambda *args: "the eager reference")
    want = sample(model, z_prompt, z_init, tok_mouth=tok_m)
    rel = float((got - want).norm() / want.norm())
    assert rel < 2e-2, rel
