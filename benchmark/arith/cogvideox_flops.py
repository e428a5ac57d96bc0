"""Model FLOPs of one CogVideoX transformer pass of one sample, counted from
the configuration: the dense matrix products, 2 * rows * in * out each, and
the joint attention's scores and values, 4 * N^2 * d a block. With N = L
text + n video tokens, d the hidden size, m = mlp_ratio * d and e the time
embedding's width:

  block: the two LayerNormZero projections (a vector, e -> 6 d each), then
      over the N tokens to_q, to_k, to_v and to_out (d -> d each) and the
      MLP's two products d -> m -> d;
  in and out: patch_embed.proj (16 * p^2 -> d) over the video tokens,
      text_proj over the text tokens, the time embedding's two products on
      one vector, norm_out's projection (e -> 2 d) and proj_out (d -> 16
      p^2) over the video tokens.

Norms, RoPE, softmax, the activations and the VAE decoder are left out, so
a share of the peak built on it is a floor on the whole call's. The CFG
batch of 2 runs two such passes a step.
"""

from __future__ import annotations

from typing import Dict


def tokens(cfg: Dict) -> Dict[str, int]:
    """The video tokens (latent frames x rows x columns of patches), the
    text tokens and their sum."""
    sp, c, v = cfg["sampling"], cfg["model"]["core"], cfg["model"]["vae"]
    p = int(c["patch_size"])
    frames = (int(sp["frames"]) - 1) // int(v["temporal_compression_ratio"]) + 1
    video = frames * (int(sp["height"]) // 8 // p) * (int(sp["width"]) // 8 // p)
    text = int(cfg["text"]["max_sequence_length"])
    return {"video": video, "text": text, "total": video + text}


def cogvideox_forward_flops(cfg: Dict) -> Dict[str, float]:
    """{"projections", "attention", "total"} of one pass of one sample."""
    c = cfg["model"]["core"]
    d = int(c["d_model"])
    m, e, p = int(float(c["mlp_ratio"]) * d), int(c["time_embed_dim"]), int(c["patch_size"])
    patch = int(c["in_channels"]) * p * p
    t = tokens(cfg)
    N, n_video, n_text = t["total"], t["video"], t["text"]
    block = 2 * (2 * e * 6 * d) + 2 * N * d * (4 * d + 2 * m)
    io = (2 * n_video * patch * d + 2 * n_text * int(c["text_embed_dim"]) * d
          + 2 * (d * e + e * e) + 2 * e * 2 * d
          + 2 * n_video * d * int(c["out_channels"]) * p * p)
    proj = int(c["n_layers"]) * block + io
    attn = int(c["n_layers"]) * 4 * N * N * d
    return {"projections": float(proj), "attention": float(attn), "total": float(proj + attn)}
