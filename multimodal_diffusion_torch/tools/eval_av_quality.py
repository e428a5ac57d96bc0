"""Quality evaluation of a trained A<->V checkpoint on real clips
(counterpart of the repo root's ``tools/eval_av_quality.py``, whose flags,
held-out slice, metrics and report it keeps):

    python -m multimodal_diffusion_torch.tools.eval_av_quality \
        --config configs/mvp.yaml overlay.yaml [--n 16] [--ema] [--seed 0] \
        [--out report.json] [--device cpu] [--no-cond-sensitivity] [--spread]

For --n manifest clips (held out by taking them from the END of the
manifest, or with --spread evenly spaced over it): generate audio from each
clip's video (V->A, the config's sampler with CFG, one batched call of
``infer/sample_clip.py::sample_one_direction``), then report:

  * av_sync_corr_gen:    motion-envelope correlation of the GENERATED audio
                         with the prompt video (``eval/av_sync.py``)
  * av_sync_corr_real:   the same for the ground-truth audio (upper anchor)
  * av_sync_corr_shuf:   generated audio vs an UNRELATED clip's video
                         (chance anchor)
  * logmel_l1 / spec_convergence: spectrogram distance generated vs
                         ground truth; logmel_l1_shuf to a shuffled one
  * zero-lag (``0``) and, with conditioning.mouth_crop, mouth-crop
    (``_mouth``, ``_mouth0``) variants of every sync correlation;
  * env_corr_*: the 10 ms RMS envelope of the generated audio against the
    real audio's, retrieval top-1 rates and margins;
  * cond_sensitivity_*: the same noise with the prompts rolled by one clip
    (0 means the conditioning is ignored);
  * gap*: paired differences with t statistics (``build_report``), the
    protocol of docs/SPEC_BAR.md.

The weights come from paths.ckpt_path (the port's or the JAX package's
orbax checkpoints, or the reference's .pt; see ``build_components``). Runs
on CUDA unless ``--device cpu``; raises without CUDA otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..datasets.av_manifest import AVClipsDataset
from ..eval.audio_quality import l1_from_logmels, logmel_default, spectral_convergence
from ..eval.av_sync import audio_rms_envelope, estimate_av_sync
from ..infer.sample_clip import build_components, sample_one_direction
from ..utils.io import load_config, resolve_device


def build_report(rows, variant_sufs):
    """Mean metrics + paired gen/real-vs-shuffle gaps with t statistics.

    Per-clip ``rows`` carry ``av_sync_corr{suf}_{gen,real}`` and their
    shuffle anchors; generated-audio shuffle rows have NO ``_gen`` infix
    (``av_sync_corr{suf}_shuf``) while real anchors are
    ``av_sync_corr{suf}_real_shuf``. Emits ``gap{suf}_{gen,real}`` (+
    ``_t``) for every variant plus the paired log-mel and envelope gaps.
    """
    report = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]
              if not k.startswith("_")}

    def paired(pos_key, neg_key):
        # mean paired difference + t statistic (positive = specificity)
        if pos_key not in rows[0] or neg_key not in rows[0]:
            return None
        d = np.array([r[pos_key] - r[neg_key] for r in rows], np.float64)
        se = d.std(ddof=1) / np.sqrt(len(d)) if len(d) > 1 else np.inf
        return float(d.mean()), float(d.mean() / (se + 1e-12))

    for suf in variant_sufs:
        for who, neg in (("gen", f"av_sync_corr{suf}_shuf"),
                         ("real", f"av_sync_corr{suf}_real_shuf")):
            st = paired(f"av_sync_corr{suf}_{who}", neg)
            if st:
                report[f"gap{suf}_{who}"], report[f"gap{suf}_{who}_t"] = st
    st = paired("logmel_l1_shuf", "logmel_l1")
    if st:
        report["gap_logmel"], report["gap_logmel_t"] = st
    st = paired("env_corr_gen", "env_corr_shuf")
    if st:
        report["gap_env"], report["gap_env_t"] = st
    report["n_clips"] = len(rows)
    return report


def env_corr0(wav_a: np.ndarray, wav_b: np.ndarray, sr: int, hz: float = 100.0) -> float:
    """Zero-lag Pearson correlation of the two waveforms' 10 ms RMS
    envelopes: a direct audio<->audio timing instrument (real audio scores
    1.0 against itself; a shuffled clip scores the corpus's shared-cadence
    floor)."""
    ea = audio_rms_envelope(np.asarray(wav_a, np.float64), sr, hz)
    eb = audio_rms_envelope(np.asarray(wav_b, np.float64), sr, hz)
    L = min(len(ea), len(eb))
    if L < 3:
        return 0.0
    return float(np.corrcoef(ea[:L], eb[:L])[0, 1])


def held_out_indices(n_items: int, n: int, spread: bool) -> list:
    """The manifest's tail of n clips, or n evenly spaced over it (every
    speaker of a speaker-ordered manifest)."""
    if spread:
        step = max(1, n_items // n)
        return list(range(n_items - 1, -1, -step))[:n][::-1]
    return list(range(n_items - n, n_items))


def manifest_dataset(cfg) -> AVClipsDataset:
    """The config's train manifest, uint8 frames [T, H, W, 3]."""
    return AVClipsDataset(
        manifest_path=cfg["data"]["train_split_glob"],
        clip_seconds=float(cfg["data"]["clip_seconds"]),
        fps=int(cfg["video"]["fps"]), sr=int(cfg["audio"]["sr"]),
        size_hw=tuple(cfg["video"]["size"]),
        video_root=cfg.get("paths", {}).get("video_root"),
        audio_root=cfg.get("paths", {}).get("audio_root"),
        device_preprocess=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=str, nargs="+", required=True)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--cond-sensitivity", action="store_true", default=True,
                    help="also sample once with MISMATCHED video prompts (same noise) and "
                         "report how different the audio is: 0 means conditioning is ignored")
    ap.add_argument("--no-cond-sensitivity", dest="cond_sensitivity", action="store_false")
    ap.add_argument("--spread", action="store_true",
                    help="take n evenly-spaced manifest clips (all speakers) instead of the "
                         "tail slice")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if (args.device or "").lower() == "cpu" else "cuda")
    cfg = load_config(*args.config)
    sr = int(cfg["audio"]["sr"])
    fps = int(cfg["video"]["fps"])

    ds = manifest_dataset(cfg)
    n = min(args.n, len(ds))
    if n == 0:
        sys.exit("manifest is empty — nothing to evaluate")
    idxs = held_out_indices(len(ds), n, args.spread)

    model = build_components(cfg, device=device, use_ema=args.ema)

    frames_list, real_wavs = [], []
    for i in idxs:
        it = ds[i]
        frames_list.append(np.asarray(it["video"]))  # [T, H, W, 3] uint8
        real_wavs.append(np.asarray(it["audio"]).reshape(-1))

    # batched V->A generation, one call
    batch = np.stack(frames_list)
    gen_wavs = sample_one_direction(
        cfg=cfg, model=model, prompt_modality="video", prompt_video=batch,
        generator=torch.Generator().manual_seed(args.seed), device=device)["audio"]  # [n, L]

    gen_wavs_mis = None
    if args.cond_sensitivity and n > 1:
        # the same noise with the prompts rolled by one clip: a model that
        # ignores its conditioning gives the same audio for both
        gen_wavs_mis = sample_one_direction(
            cfg=cfg, model=model, prompt_modality="video",
            prompt_video=np.roll(batch, 1, axis=0),
            generator=torch.Generator().manual_seed(args.seed), device=device)["audio"]

    # envelope-metric variants: best lag within +/-1 s and lag 0, on the
    # full frame and, with a mouth box, on the mouth crop
    variants = [("", frames_list, 1.0), ("0", frames_list, 0.0)]
    mouth_box = (cfg.get("conditioning", {}).get("mouth_crop") or {}).get("box")
    if mouth_box:
        r0, r1, c0, c1 = (int(v) for v in mouth_box)
        mouth_list = [f[:, r0:r1, c0:c1] for f in frames_list]
        variants += [("_mouth", mouth_list, 1.0), ("_mouth0", mouth_list, 0.0)]

    # log-mels and 10 ms envelopes once per real waveform (the retrieval
    # metrics compare every generated clip to every real clip)
    def mel(w):
        return logmel_default(w, sr)

    def env100(w):
        return audio_rms_envelope(np.asarray(w, np.float64), sr, 100.0)

    def env_corr_pre(ea, eb):
        L = min(len(ea), len(eb))
        return float(np.corrcoef(ea[:L], eb[:L])[0, 1]) if L >= 3 else 0.0

    mels_real = [mel(w) for w in real_wavs]
    envs_real = [env100(w) for w in real_wavs]

    rows = []
    rng = np.random.default_rng(args.seed)
    for j in range(n):
        real, gen = real_wavs[j], gen_wavs[j]
        mel_gen = mel(gen)
        row = {
            "_manifest_index": int(idxs[j]),
            "logmel_l1": l1_from_logmels(mels_real[j], mel_gen),
            "spec_convergence": spectral_convergence(real, gen, sr),
        }
        other = None
        if n > 1:  # shuffle anchors need a different clip
            k = int(rng.integers(0, n - 1))
            other = (j + 1 + k) % n
        for suf, fl, ml in variants:
            _, cg = estimate_av_sync(fl[j], gen, sr=sr, fps=fps, max_lag_seconds=ml)
            _, cr = estimate_av_sync(fl[j], real, sr=sr, fps=fps, max_lag_seconds=ml)
            row[f"av_sync_corr{suf}_gen"] = cg
            row[f"av_sync_corr{suf}_real"] = cr
            if other is not None:
                _, cs = estimate_av_sync(fl[other], gen, sr=sr, fps=fps, max_lag_seconds=ml)
                # the ceiling anchor: the same shuffle on the real audio
                _, crs = estimate_av_sync(fl[other], real, sr=sr, fps=fps, max_lag_seconds=ml)
                row[f"av_sync_corr{suf}_shuf"] = cs
                row[f"av_sync_corr{suf}_real_shuf"] = crs
        env_gen = env100(gen)
        row["env_corr_gen"] = env_corr_pre(env_gen, envs_real[j])
        if other is not None:
            row["env_corr_shuf"] = env_corr_pre(env_gen, envs_real[other])
            row["env_corr_real_shuf"] = env_corr_pre(envs_real[j], envs_real[other])
            ecs = [env_corr_pre(env_gen, envs_real[m]) for m in range(n)]
            row["env_retrieval_top1"] = float(int(np.argmax(ecs)) == j)
            row["logmel_l1_shuf"] = l1_from_logmels(mels_real[other], mel_gen)
            dists = [l1_from_logmels(mels_real[m], mel_gen) for m in range(n)]
            row["retrieval_top1"] = float(int(np.argmin(dists)) == j)
            row["retrieval_margin"] = float(
                np.min([dists[m] for m in range(n) if m != j]) - dists[j])
        if gen_wavs_mis is not None:
            row["cond_sensitivity_logmel"] = l1_from_logmels(mel_gen, mel(gen_wavs_mis[j]))
            row["cond_sensitivity_wav_l2"] = float(
                np.sqrt(np.mean((gen - gen_wavs_mis[j]) ** 2)))
        rows.append(row)

    report = build_report(rows, [s for s, _, _ in variants])
    report["ema"] = bool(args.ema)
    print(json.dumps(report, indent=2))
    if args.out:
        args.out.write_text(json.dumps({"mean": report, "per_clip": rows}, indent=2))
    return report


if __name__ == "__main__":
    main()
