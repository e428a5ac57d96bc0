"""One-shot DDIM sampling with classifier-free guidance, V->A or A->V
(counterpart of the JAX ``infer/sample_clip.py``). Public API + CLI:

  python -m multimodal_diffusion_torch.infer.sample_clip \
      --config configs/mvp.yaml configs/v2a.yaml \
      --frames path/to/frames_dir --out-audio out.wav

Runs on CUDA unless ``--device cpu`` (the entry points raise when CUDA is
asked for and absent). Weights come from a JAX params tree carried across by
``utils/convert.py``, else from ``paths.ckpt_path`` (``--ckpt``): a
checkpoint directory, ``<dir>/latest`` or ``<dir>/<step>`` holding the
port's own checkpoints (``train/checkpoint.py``) or the JAX package's orbax
ones (read by ``train/orbax_reader.py``, told apart per step directory), or
the reference implementation's ``.pt`` file
(``utils/reference_checkpoint.py``); else from a seeded random init.

Under several ranks (``torch.distributed``, ``parallel/mesh.py``): a config
with ``parallel.context > 1`` builds its context group here, so every rank
of it runs the core on its token shard (the ring); ``sample_one_direction``
with a mesh whose 'data' axis is > 1 samples this rank's rows of the batch,
from its rows of the global initial noise, and gathers the outputs on every
rank.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..models.diffusion import AVDiffusionConfig, AVDiffusionModel, init_weights
from ..parallel import comm
from ..parallel.mesh import make_mesh_from_config
from ..parallel.sharding import shard_batch
from ..train.checkpoint import (CheckpointManager, cast_params_bf16, checkpoint_format,
                                jax_params_only, params_only_tree)
from ..train.orbax_reader import read_orbax_step
from ..utils.convert import jax_params_to_state_dict, load_jax_params
from ..utils.io import compute_dtype_from_config, load_config, resolve_device
from ..utils.profiling import span
from ..utils.reference_checkpoint import reference_state_dict
from .ddim import sampler_from_config

Device = Union[str, torch.device]


def split_checkpoint_path(ckpt: Path) -> Tuple[Path, Optional[int]]:
    """paths.ckpt_path -> (checkpoint directory, step or None for the
    latest)."""
    if ckpt.name == "latest":
        return ckpt.parent, None
    if ckpt.name.isdigit():
        return ckpt.parent, int(ckpt.name)
    return ckpt, None


def checkpoint_location(ckpt) -> Optional[Path]:
    """The reference ``.pt`` file or the step directory that a
    paths.ckpt_path value names; None when it names nothing that exists or a
    directory without checkpoints."""
    ckpt = Path(str(ckpt))
    if ckpt.suffix == ".pt" and ckpt.is_file():
        return ckpt
    ckpt_dir, step = split_checkpoint_path(ckpt)
    if not ckpt_dir.is_dir():
        return None
    mgr = CheckpointManager(ckpt_dir)
    step = step if step is not None else mgr.latest_step()
    if step is None or not (mgr.dir / str(step)).is_dir():
        return None
    return mgr.dir / str(step)


def latest_state_dict(ckpt_dir) -> Optional[Dict[str, torch.Tensor]]:
    """The params of the latest step under `ckpt_dir` (the port's or the JAX
    package's orbax format) as the port's state_dict, or None when the
    directory is missing or holds no step."""
    where = checkpoint_location(ckpt_dir)
    if where is None or where.is_file():
        return None
    fmt = checkpoint_format(where)
    if fmt == "port":
        sd = CheckpointManager(where.parent).restore(int(where.name))["params"]
    elif fmt == "jax":
        sd = jax_params_to_state_dict(read_orbax_step(where)["params"])
    else:
        raise FileNotFoundError(f"{where} holds neither the port's params.pt nor an orbax "
                                f"checkpoint (default/_METADATA)")
    print(f"[ckpt] restored step {where.name} from {where.parent} ({fmt})")
    return sd


def checkpoint_state_dict(cfg: Dict, model: AVDiffusionModel,
                          use_ema: bool = False) -> Optional[Dict[str, torch.Tensor]]:
    """The state_dict that paths.ckpt_path names for `model`, with the EMA
    weights when `use_ema`; None (and a warning, as the JAX package gives)
    when it names nothing that exists or a directory without checkpoints."""
    paths = cfg.get("paths", {}) or {}
    ckpt = paths.get("ckpt_path") or paths.get("ckpt")
    if not ckpt:
        print("[info] no ckpt_path in config; sampling with random weights.")
        return None
    where = checkpoint_location(ckpt)
    if where is None:
        print(f"[warn] checkpoint path {ckpt} has no checkpoints; "
              f"sampling with random weights.")
        return None
    if where.is_file():
        step, sd = reference_state_dict(where, cfg, model, use_ema)
        print(f"[ckpt] reference checkpoint {where} (step {step}, ema={use_ema})")
        return sd
    fmt = checkpoint_format(where)
    print(f"[ckpt] restored step {where.name} from {where.parent} ({fmt}, ema={use_ema})")
    if fmt == "port":
        return params_only_tree(CheckpointManager(where.parent).restore(int(where.name)),
                                use_ema=use_ema)
    if fmt == "jax":
        return jax_params_only(read_orbax_step(where), use_ema=use_ema)
    raise FileNotFoundError(f"{where} holds neither the port's params.pt nor an orbax "
                            f"checkpoint (default/_METADATA)")


def build_components(cfg: Dict, params: Optional[Mapping] = None,
                     device: Device = "cuda", use_ema: bool = False,
                     bf16_params: bool = False, mesh=None) -> AVDiffusionModel:
    """The model in eval mode on `device`: weights from a JAX params tree
    when given, else from the checkpoint paths.ckpt_path names
    (``checkpoint_state_dict``; the EMA weights swapped in when `use_ema`),
    else a random init seeded by cfg['seed']. With `bf16_params` and a bf16
    compute config the fp32 weights become bf16 once after the restore
    (``cast_params_bf16``; inference only), as the JAX package's. A config
    with ``parallel.context > 1`` lays the core out over the ranks
    (``make_mesh_from_config``, unless `mesh` is given), as the JAX
    package's build_components does. Under a `mesh` with 'model' > 1 each
    rank holds only its part of the core's split projections: the whole
    weights (a checkpoint's, its EMA, a JAX tree or the seeded init) are
    cut as they load, before any bf16 cast.

    Sets torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 to False: fp32 matmuls and convolutions
    run in full fp32 (cuDNN would use TF32 for conv3d by default); bf16
    compute is unaffected."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = compute_dtype_from_config(cfg)
    par = cfg.get("parallel", {}) or {}
    if mesh is None and int(par.get("context", 1) or 1) > 1:
        mesh = make_mesh_from_config(cfg)
    model = AVDiffusionModel(AVDiffusionConfig.from_config(cfg, dtype=dtype, mesh=mesh))
    if params is not None:
        load_jax_params(model, params)
    else:
        state = checkpoint_state_dict(cfg, model, use_ema)
        if state is not None:
            model.load_state_dict(state, strict=True)
        else:
            init_weights(model, torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    if bf16_params and dtype == torch.bfloat16:
        cast_params_bf16(model)
    return model.to(dev).eval()


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def sample_one_direction(
    *,
    cfg: Dict,
    model: AVDiffusionModel,
    prompt_modality: str,  # "video" -> generate audio; "audio" -> generate video
    prompt_video=None,  # [T,H,W,3] or [B,T,H,W,3] uint8 (numpy or torch)
    prompt_audio=None,  # [L] or [B,L] float32 (numpy or torch)
    generator: Optional[torch.Generator] = None,
    device: Device = "cuda",
    mesh=None,
) -> Dict[str, object]:
    """DDIM+CFG generation of the non-prompt modality.

    Returns {"audio": wav float32 [L] or [B,L], "sr": int} or
    {"video": frames uint8 [T,H,W,3] or [B,T,H,W,3], "fps": int}; a leading
    batch axis on the prompt generates B clips in one batched call.
    `generator` (a CPU generator) draws the initial noise. With the
    mouth-crop stream enabled, v2a conditions on mouth tokens cut from the
    prompt frames; a2v runs with the stream zeroed. `mesh` (default: the
    model core's) with 'data' > 1: every rank passes the whole batch, samples
    its rows and returns the whole batch's outputs.

    The call runs in the span ``sample.call`` (``utils/profiling.py::span``)
    and its stages in ``sample.upload`` (the prompt and the initial noise to
    the device), ``sample.vae_encode``, ``sample.mouth_tokens`` (v2a with the
    stream on), ``sample.denoise`` (the sampler), ``sample.decode`` and
    ``sample.readback`` (the gather and the copy to the host)."""
    if prompt_modality not in {"video", "audio"}:
        raise ValueError("prompt_modality must be 'video' or 'audio'")
    dev = _model_device(model)
    if dev.type != resolve_device(device).type:
        raise ValueError(f"model is on {dev}, not {device}")
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    if mesh is None:
        mesh = model.cfg.core.mesh
    group = None if mesh is None else mesh.group("data")

    def rows(x):  # this rank's rows of the global batch
        return shard_batch(mesh, x, x.shape[0])

    vl = cfg["video"]["latent"]
    al = cfg["audio"]["latent"]
    Cv, t_down, s_down = int(vl["channels"]), int(vl["t_down"]), int(vl["s_down"])
    Ca, Fa = int(al["channels"]), int(al["frames_per_clip"])
    sr = int(cfg["audio"]["sr"])
    fps = int(cfg["video"]["fps"])
    H, W = (int(x) for x in cfg["video"]["size"])

    with span("sample.call"), torch.inference_mode():
        if prompt_modality == "video":
            if prompt_video is None:
                raise ValueError("prompt_video frames required for prompt_modality=video")
            with span("sample.upload"):
                frames = torch.as_tensor(prompt_video).to(dev, torch.float32) / 255.0
                batched = frames.ndim == 5
                if not batched:
                    frames = frames[None]
                B = frames.shape[0]
                frames = frames.permute(0, 4, 1, 2, 3)  # [B,3,T,H,W]
                # Center-crop T here, not only inside encode_video: the mouth
                # tokens are then cut from exactly the frames the VAE encodes
                # (the sampler derives the mouth grid from the cropped latent).
                t_div = t_down
                if model.cfg.mouth_enabled:
                    t_div = math.lcm(t_down, model.cfg.mouth_tube[0])
                T_in = frames.shape[2]
                T_crop = (T_in // t_div) * t_div
                if T_crop == 0:
                    raise ValueError(f"prompt has {T_in} frames; need at least {t_div} "
                                     f"(vae.t_down x mouth tube t)")
                if T_crop != T_in:
                    s0 = (T_in - T_crop) // 2
                    frames = frames[:, :, s0:s0 + T_crop]
                z_init = rows(torch.randn((B, Ca, Fa), generator=generator)).to(dev)
                frames = rows(frames)
            with span("sample.vae_encode"):
                z_v0 = model.encode_video(frames)
            sample, _ = sampler_from_config(cfg, target="audio")
            tok_m = None
            if model.cfg.mouth_enabled:
                with span("sample.mouth_tokens"):
                    tok_m = model.mouth_tokens(frames)
            with span("sample.denoise"):
                z_a = sample(model, z_v0, z_init, tok_mouth=tok_m)
            with span("sample.decode"):
                wav = model.decode_audio(z_a)[:, 0].float()
            with span("sample.readback"):
                wav = comm.all_gather(wav, group, 0).cpu().numpy()  # [B, L]
            return {"audio": wav if batched else wav[0], "sr": sr}

        if prompt_audio is None:
            raise ValueError("prompt_audio required for prompt_modality=audio")
        with span("sample.upload"):
            wav = torch.as_tensor(prompt_audio).to(dev, torch.float32)
            batched = wav.ndim == 2
            if not batched:
                wav = wav[None]
            B = wav.shape[0]
            wav = rows(wav)[:, None, :]
            T_in = (prompt_video.shape[-4] if prompt_video is not None
                    else int(round(float(cfg["data"]["clip_seconds"]) * fps)))
            Tp = max(1, T_in // t_down)
            z_init = rows(torch.randn((B, Cv, Tp, H // s_down, W // s_down),
                                      generator=generator)).to(dev)
        with span("sample.vae_encode"):
            z_a0 = model.encode_audio(wav)
        sample, _ = sampler_from_config(cfg, target="video")
        with span("sample.denoise"):
            z_v = sample(model, z_a0, z_init)
        with span("sample.decode"):
            x = model.decode_video(z_v).float().clamp(0, 1)
        with span("sample.readback"):
            x = comm.all_gather(x, group, 0).cpu().numpy()  # [B,3,T,H,W]
        frames_u8 = (x.transpose(0, 2, 3, 4, 1) * 255.0).astype(np.uint8)
        return {"video": frames_u8 if batched else frames_u8[0], "fps": fps}


def add_checkpoint_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint directory (port or orbax), <dir>/<step>, <dir>/latest, or "
                         "a reference .pt file (sets paths.ckpt_path)")
    ap.add_argument("--ema", action="store_true", help="sample with the EMA weights")


def config_with_checkpoint(cfg: Dict, ckpt: Optional[str]) -> Dict:
    """`cfg` with paths.ckpt_path set to `ckpt` when given. A checkpoint
    named here must exist: FileNotFoundError when it names nothing that
    ``checkpoint_location`` finds (no silent random weights)."""
    if ckpt:
        if checkpoint_location(ckpt) is None:
            raise FileNotFoundError(f"--ckpt {ckpt}: no reference .pt file and no "
                                    f"checkpoint step directory there")
        cfg = dict(cfg, paths={**(cfg.get("paths") or {}), "ckpt_path": ckpt})
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description="One-shot DDIM sampling with CFG (V->A or A->V).")
    ap.add_argument("--config", type=str, nargs="+", required=True,
                    help="One or more YAML configs (merged left->right)")
    ap.add_argument("--frames", type=Path, default=None,
                    help="Prompt: directory of frames (for V->A)")
    ap.add_argument("--audio", type=Path, default=None, help="Prompt: audio wav (for A->V)")
    ap.add_argument("--out-frames", type=Path, default=None,
                    help="Output frames directory (for A->V)")
    ap.add_argument("--save-mp4", type=Path, default=None, help="Optional mp4 path (for A->V)")
    ap.add_argument("--out-audio", type=Path, default=None, help="Output wav path (for V->A)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda raises when absent")
    ap.add_argument("--bf16-params", action="store_true",
                    help="Cast weights to bf16 once for faster inference "
                         "(bf16 compute configs only)")
    add_checkpoint_args(ap)
    args = ap.parse_args(argv)

    from ..media.audio_io import read_wav, write_wav
    from ..media.video_io import load_frames_dir, write_frames

    cfg = config_with_checkpoint(load_config(*args.config), args.ckpt)
    model = build_components(cfg, device=args.device, use_ema=args.ema,
                             bf16_params=args.bf16_params)
    prompt_modality = cfg.get("sampling", {}).get("prompt_modality", "video")
    if prompt_modality == "video":
        if args.frames is None:
            raise SystemExit("Provide --frames for prompt_modality=video")
        H, W = (int(x) for x in cfg["video"]["size"])
        result = sample_one_direction(
            cfg=cfg, model=model, prompt_modality="video",
            prompt_video=load_frames_dir(args.frames, size_hw=(H, W)), device=args.device)
        out = args.out_audio or Path("samples_out.wav")
        write_wav(out, result["audio"], result["sr"])
        print(f"[ok] wrote audio -> {out}")
    elif prompt_modality == "audio":
        if args.audio is None:
            raise SystemExit("Provide --audio for prompt_modality=audio")
        prompt_audio, _ = read_wav(args.audio, sr=int(cfg["audio"]["sr"]))
        result = sample_one_direction(
            cfg=cfg, model=model, prompt_modality="audio", prompt_audio=prompt_audio,
            device=args.device)
        out_dir = args.out_frames or Path("frames_out")
        write_frames(result["video"], out_dir, mp4_path=args.save_mp4, fps=result["fps"])
        print(f"[ok] wrote frames -> {out_dir}")
    else:
        raise ValueError("sampling.prompt_modality must be 'video' or 'audio'")


if __name__ == "__main__":
    main()
