"""Model FLOPs of one FLUX.1 transformer pass of one sample, counted from
the configuration: the dense matrix products, 2 * rows * in * out each, and
the joint attention's scores and values, 4 * N^2 * d a block. With N = L
text + n image tokens, d the hidden size and m = mlp_ratio * d:

  double block: per stream modulation (a vector, 6 d out), then over the N
      tokens qkv 3 d, proj d and the MLP's two products d -> m -> d;
  single block: modulation (3 d out), linear1 d -> 3 d + m and linear2
      d + m -> d over the N tokens;
  in and out: img_in (in_channels -> d) and the last layer (d -> in_channels,
      its modulation 2 d) over the image tokens, txt_in over the text tokens,
      the three embedders' two products each on one vector.

Norms, RoPE, softmax, the activations and the AE decoder are left out, so a
share of the peak built on it is a floor on the whole call's.
"""

from __future__ import annotations

from typing import Dict


def tokens(cfg: Dict) -> Dict[str, int]:
    sp = cfg["sampling"]
    img = (int(sp["height"]) // 16) * (int(sp["width"]) // 16)
    txt = int(cfg["text"]["max_sequence_length"])
    return {"img": img, "txt": txt, "total": img + txt}


def flux_forward_flops(cfg: Dict) -> Dict[str, float]:
    """{"projections", "attention", "total"} of one pass of one sample."""
    c = cfg["model"]["core"]
    d, m = int(c["d_model"]), int(float(c["mlp_ratio"]) * int(c["d_model"]))
    cin = int(c["in_channels"])
    t = tokens(cfg)
    N, n_img, n_txt = t["total"], t["img"], t["txt"]
    double = 2 * (2 * d * 6 * d) + 2 * N * d * (3 * d + d + 2 * m)
    single = 2 * d * 3 * d + 2 * N * d * (3 * d + m) + 2 * N * (d + m) * d
    embed = (2 * (256 * d + d * d) * (2 if c.get("guidance_embed", True) else 1)
             + 2 * (int(c["vec_in_dim"]) * d + d * d))
    io = (2 * n_img * cin * d + 2 * n_txt * int(c["context_in_dim"]) * d
          + 2 * d * 2 * d + 2 * n_img * d * cin)
    proj = int(c["depth"]) * double + int(c["depth_single_blocks"]) * single + embed + io
    attn = (int(c["depth"]) + int(c["depth_single_blocks"])) * 4 * N * N * d
    return {"projections": float(proj), "attention": float(attn), "total": float(proj + attn)}
