"""MMDiT — multimodal diffusion transformer core (counterpart of the JAX
``models/mmdit.py``).

A pre-norm transformer encoder over the concatenated [video; audio] token
sequence. Parameters are fp32; compute runs in ``cfg.dtype`` (bf16 for mvp)
with norm statistics and attention softmax in fp32.

Dropout (residual, MLP, token and attention-probability dropout) is on under
``module.train()`` and off under ``eval()``. It draws only from an explicit
``torch.Generator`` that ``set_dropout_generator`` hands to every dropout
module; a training-mode dropout without one raises (no global RNG).

With ``remat`` (``parallel.remat_core``), a training pass with grad enabled
runs each block under ``torch.utils.checkpoint``: its activations are
recomputed in the backward pass (the flash forward kernel runs again there)
instead of kept. The dropout generators' state is saved before each block and
set again for its recompute, so the recomputed masks are the forward's and
the draws after the step are unchanged.

Under ``quant: "int8"`` the four hot projections (qkv, attention out, fc1,
fc2) run W8A8 (``ops/quant.py``) on eval-mode passes, the JAX package's
deterministic ones; a training pass is exactly the unquantized program.
Under tensor parallelism the row-split projections take their absmax scales
over the group and sum the int32 products, so the result is one process's,
bit for bit.

Layouts over a mesh of ranks (``parallel/mesh.py``; each rank computes its
part):

  * ``model_axis`` (tensor parallel): a rank holds and runs only its part of
    the four hot projections (``HotDense``), as a JAX device holds its shard:
    heads [i H/m, (i+1) H/m) of q, k and v (whole heads of the fused qkv)
    and the same slice of the MLP's hidden units; the attention out and fc2
    projections hold the matching input columns and their partial outputs
    are summed over the group (fp32, or int32 under int8) before the bias.
    Every other parameter is whole on every rank;
  * ``context_axis`` (sequence parallel): the core pads N to
    lcm(seq_multiple, n_ctx) with masked keys, each rank keeps its token
    shard [B, N/n_ctx, d] through the blocks (norms, MLPs and projections
    are token-local; RoPE takes the shard's global positions) and attention
    is the ring (``ops/ring_attention.py``, einsum or flash); the shards are
    gathered after the last block;
  * ``pipe_axis`` (pipeline parallel): the blocks are contiguous GPipe
    stages (``parallel/pipeline.py``), training only without dropout.

A dropout mask is drawn for the tensor the one-process model would see and
each rank takes its slice of it (``Dropout.splits``), so a layout draws
the one-process masks from the shared generator.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (attention_path, forced_path, mha_reference, multi_head_attention,
                             padding_bias)
from ..ops.quant import Int8Weight, int8_linear
from ..ops.ring_attention import ring_attention_local
from ..ops.rms_norm import rms_norm, rms_norm_reference
from ..ops.tokenize import pad_to_multiple
from ..parallel import comm
from ..parallel.sharding import tp_part
from .adapters import Dense

QUANT_MODES = ("none", "int8")


class Dropout(nn.Module):
    """Inverted dropout, flax semantics: keep with probability 1 - rate and
    scale the kept values by 1 / (1 - rate). Identity in eval mode or at
    rate 0. Draws come from ``self.generator`` (see set_dropout_generator).

    ``splits``: (dim, n, i) triples of a layout over ranks: the input is
    part i of n of the one-process tensor along dim, so the uniforms are
    drawn at the one-process shape and part i of each split dim is kept."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None
        self.splits: Tuple[Tuple[int, int, int], ...] = ()

    def _uniform(self, shape, device) -> torch.Tensor:
        if self.generator is None:
            raise RuntimeError("dropout in training mode needs a generator: "
                               "call set_dropout_generator(model, generator)")
        full = list(shape)
        for dim, n, _ in self.splits:
            full[dim] *= n
        u = torch.rand(full, generator=self.generator, device=device)
        for dim, _, i in self.splits:
            u = u.narrow(dim, i * shape[dim], shape[dim])
        return u

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = self._uniform(x.shape, x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class TokenDropout(Dropout):
    """Zero whole tokens of [B, N, d] with probability ``rate`` (no rescale),
    as the JAX core's stochastic token dropout."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = self._uniform(x.shape[:2], x.device) > self.rate
        return x * keep.to(x.dtype)[..., None]


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Hand `generator` to every dropout module of `model`."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


def split_dropout(modules: Sequence[nn.Module], dim: int, n: int, i: int) -> None:
    """Every dropout in `modules` sees part i of n of its one-process input
    along `dim` (see ``Dropout.splits``)."""
    if n > 1:
        for root in modules:
            for mod in root.modules():
                if isinstance(mod, Dropout):
                    mod.splits += ((dim, n, i),)


class RMSNorm(nn.Module):
    """y = weight * x / (sqrt(mean(x^2) + 1e-12) + eps): eps sits OUTSIDE the
    sqrt (the reference formula); the +1e-12 inside keeps exactly-zero rows
    (CFG-dropped tokens) finite. Statistics in fp32.

    A CUDA x that needs no gradient (sampling) takes the hand-written kernel
    (``ops/rms_norm.py``), one launch; otherwise (training, the CPU) the plain
    version runs under autograd."""

    def __init__(self, d: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and not (torch.is_grad_enabled()
                              and (x.requires_grad or self.weight.requires_grad)):
            return rms_norm(x, self.weight, self.eps, self.dtype)
        return rms_norm_reference(x, self.weight, self.eps, self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with eps 1e-5, statistics in fp32, output in ``dtype``;
    scale and bias are used in fp32 (bf16 serving weights are upcast, as
    flax promotes them)."""

    def __init__(self, d: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(),
                            self.eps).to(self.dtype)


def make_norm(kind: str, d: int, dtype: torch.dtype) -> nn.Module:
    if kind.lower() == "rmsnorm":
        return RMSNorm(d, dtype=dtype)
    return LayerNorm(d, dtype=dtype)


def rotary_embed(q: torch.Tensor, k: torch.Tensor, max_period: float = 10_000.0,
                 offset: int = 0):
    """Rotary position embedding over the sequence axis of [B, H, N, Dh];
    the rows sit at positions offset .. offset + N - 1 (a context shard's
    global positions)."""
    Dh = q.shape[-1]
    half = Dh // 2
    freqs = 1.0 / (max_period ** (
        torch.arange(half, dtype=torch.float32, device=q.device) / half))
    pos = torch.arange(offset, offset + q.shape[-2], dtype=torch.float32, device=q.device)
    ang = pos[:, None] * freqs[None, :]  # [N, half]
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rot(x):
        x1, x2 = x[..., :half], x[..., half: 2 * half]
        xr1 = x1 * cos - x2 * sin
        xr2 = x1 * sin + x2 * cos
        return torch.cat([xr1, xr2, x[..., 2 * half:]], dim=-1).to(x.dtype)

    return rot(q), rot(k)


class CoreLayout:
    """Where one rank sits in the core's layout over a mesh: the tensor
    parallel group (``tp_*``), the context group (``ctx_*``, with the ring's
    members and its implementation) and the pipeline (``pipe_*``). Sizes
    are 1 and groups None without a mesh."""

    def __init__(self, mesh=None, model_axis: Optional[str] = None,
                 context_axis: Optional[str] = None, context_flash: bool = False,
                 pipe_axis: Optional[str] = None, pipe_microbatches: int = 4):
        def axis(name):
            if mesh is None or name is None:
                return None, 1, 0
            return mesh.group(name), mesh.size(name), mesh.index(name)

        self.mesh = mesh
        self.tp_group, self.tp_n, self.tp_i = axis(model_axis)
        self.ctx_group, self.ctx_n, self.ctx_i = axis(context_axis)
        self.ctx_members = mesh.members(context_axis) if self.ctx_n > 1 else None
        self.ctx_impl = "flash" if context_flash else "einsum"
        self.pipe_axis = pipe_axis if mesh is not None and pipe_axis else None
        self.pipe_n = axis(pipe_axis)[1]
        self.pipe_microbatches = int(pipe_microbatches)


NO_LAYOUT = CoreLayout()


class HotDense(Dense):
    """A Dense of the core's four hot projections: under quant "int8" an
    eval-mode pass runs ``int8_linear`` on the weight quantized once per
    parameter version; a training pass is the plain Dense.

    Under a tensor-parallel layout the parameters are this rank's part only
    (``split``); which part is ``parallel/sharding.py``'s rule, by
    parameter name:

      * "out" (qkv, fc1): this rank's rows of the weight and bias; the
        input enters through copy_to_group, so its gradient is summed over
        the group;
      * "in" (attention out, fc2): this rank's input columns of the weight,
        the bias whole; the partial products are summed over the group
        (``_row_split_linear``).

    ``load_state_dict`` takes the whole tensors (this rank's part is cut by
    ``sharding.tp_part``) or the parts; ``whole_shape`` gives
    ``init_weights`` the shape of the one-process init it draws."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, quant: str = "none",
                 split: Optional[str] = None, layout: CoreLayout = NO_LAYOUT):
        n = 1 if split is None else layout.tp_n
        super().__init__(d_in // n if split == "in" else d_in,
                         d_out // n if split == "out" else d_out, dtype)
        self._whole = {"weight": (d_out, d_in), "bias": (d_out,)}
        self.split = split if n > 1 else None
        self.tp_n = n
        self.tp_i = layout.tp_i if self.split else 0
        self.tp_group = layout.tp_group if self.split else None
        self.int8_weight = (Int8Weight(self.tp_group if self.split == "in" else None)
                            if quant == "int8" else None)

    def whole_shape(self, leaf: str) -> Tuple[int, ...]:
        return self._whole[leaf]

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self.split is not None:
            for leaf in ("weight", "bias"):
                t = state_dict.get(prefix + leaf)
                if t is not None:
                    state_dict[prefix + leaf] = tp_part(
                        prefix + leaf, t, getattr(self, leaf).shape, self.tp_n, self.tp_i)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        int8 = self.int8_weight is not None and not self.training
        if self.split == "in":
            return _row_split_linear(self, x, int8)
        if self.split == "out":
            x = comm.copy_to_group(x, self.tp_group)
        if not int8:
            return super().forward(x)
        return int8_linear(x, self.weight, self.bias, self.dtype,
                           self.int8_weight(self.weight, self.dtype))


def _row_split_linear(dense: HotDense, x: torch.Tensor, int8: bool) -> torch.Tensor:
    """A projection whose input features are split over the group: this
    rank's columns of the weight, the partial products summed over the
    group in fp32, then the bias, in dense.dtype. Under int8 the scales are
    the group's (absmax over the whole row) and the int32 products are
    summed before the rescale and the bias: one process's result."""
    if int8:
        return int8_linear(x, dense.weight, dense.bias, dense.dtype,
                           dense.int8_weight(dense.weight, dense.dtype), group=dense.tp_group)
    part = F.linear(x.to(dense.dtype), dense.weight.to(dense.dtype))
    return (comm.reduce_from_group(part, dense.tp_group) + dense.bias.float()).to(dense.dtype)


class Attention(nn.Module):
    """Self-attention with a fused qkv projection (biases), optional RoPE, and
    an output projection, then residual dropout. Attention itself goes through
    ``multi_head_attention``: the CUDA kernels on the card, forward and
    backward. A training pass with ``attn_dropout > 0`` takes the dense
    einsum body with probability dropout instead, as the JAX package does
    (the kernels draw no random numbers). The layout's tensor-parallel and
    context parts are described in the module docstring."""

    def __init__(self, d: int, n_heads: int, rope: bool = False,
                 dtype: torch.dtype = torch.float32, attn_dropout: float = 0.0,
                 resid_dropout: float = 0.0, quant: str = "none",
                 layout: CoreLayout = NO_LAYOUT):
        super().__init__()
        if d % n_heads:
            raise ValueError(f"d_model {d} not divisible by n_heads {n_heads}")
        if n_heads % layout.tp_n:
            raise ValueError(f"{n_heads} heads not divisible by parallel.model={layout.tp_n}")
        self.n_heads, self.rope, self.layout = n_heads, rope, layout
        self.qkv = HotDense(d, 3 * d, dtype, quant, "out", layout)
        self.out = HotDense(d, d, dtype, quant, "in", layout)
        self.attn_drop = Dropout(attn_dropout)
        self.resid_drop = Dropout(resid_dropout)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                ctx_offset: Optional[int] = None) -> torch.Tensor:
        """x [B, N, d]. Under a context layout the core passes this rank's
        token shard with `ctx_offset`, its first token's global position,
        and the whole sequence's key_padding_mask; a direct call with the
        whole sequence is split over the group here (dense, with a
        RuntimeWarning, when N does not divide)."""
        L = self.layout
        B, N, d = x.shape
        if L.ctx_n > 1 and ctx_offset is None:
            if N % L.ctx_n == 0:
                shard = comm.scatter_to_group(x, L.ctx_group, 1)
                out = self(shard, key_padding_mask, L.ctx_i * (N // L.ctx_n))
                return comm.gather_from_group(out, L.ctx_group, 1)
            warnings.warn(f"context parallelism configured (size {L.ctx_n}) but sequence "
                          f"length {N} is not divisible — falling back to DENSE attention "
                          f"for this call", RuntimeWarning, stacklevel=2)
        H = self.n_heads // L.tp_n
        qkv = self.qkv(x).reshape(B, N, 3, H, -1)
        # head views of the one projection; unbind's backward stacks the
        # three grads into one qkv-shaped buffer
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # [B, H, N, Dh]
        if self.rope:
            q, k = rotary_embed(q, k, offset=ctx_offset or 0)
        train_drop = self.training and self.attn_drop.rate > 0.0
        if ctx_offset is not None:
            if train_drop:
                raise NotImplementedError(
                    "attn_dropout > 0 is not supported under context parallelism; set "
                    "model.core.attn_dropout: 0 or parallel.context: 1")
            valid = (None if key_padding_mask is None
                     else ~key_padding_mask[:, ctx_offset:ctx_offset + N])
            out = ring_attention_local(q, k, v, L.ctx_group, L.ctx_members, valid,
                                       L.ctx_impl)
        elif train_drop:
            # the JAX package's training body: no all-masked-row zeroing
            bias = None if key_padding_mask is None else padding_bias(key_padding_mask)
            out = mha_reference(q, k, v, bias, probs_dropout=self.attn_drop)
        else:
            out = multi_head_attention(q, k, v, key_padding_mask=key_padding_mask)
        out = out.transpose(1, 2).reshape(B, N, -1)
        return self.resid_drop(self.out(out))


class MLP(nn.Module):
    """fc1 -> GELU (erf, or tanh when gelu_exact is False) -> dropout -> fc2
    -> dropout. Under tensor parallelism a rank runs its slice of the hidden
    units."""

    def __init__(self, d: int, mlp_ratio: float = 4.0, gelu_exact: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 quant: str = "none", layout: CoreLayout = NO_LAYOUT):
        super().__init__()
        hidden = int(d * mlp_ratio)
        if hidden % layout.tp_n:
            raise ValueError(f"MLP width {hidden} not divisible by parallel.model={layout.tp_n}")
        self.fc1 = HotDense(d, hidden, dtype, quant, "out", layout)
        self.fc2 = HotDense(hidden, d, dtype, quant, "in", layout)
        self.approximate = "none" if gelu_exact else "tanh"
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.drop1(F.gelu(self.fc1(x), approximate=self.approximate))
        return self.drop2(self.fc2(h))


class Block(nn.Module):
    """Pre-norm residual block: x + attn(norm1(x)); x + mlp(norm2(x))."""

    def __init__(self, d: int, n_heads: int, mlp_ratio: float, norm: str,
                 rope: bool, gelu_exact: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 attn_dropout: float = 0.0, quant: str = "none",
                 layout: CoreLayout = NO_LAYOUT):
        super().__init__()
        self.norm1 = make_norm(norm, d, dtype)
        self.attn = Attention(d, n_heads, rope, dtype, attn_dropout, dropout, quant, layout)
        self.norm2 = make_norm(norm, d, dtype)
        self.mlp = MLP(d, mlp_ratio, gelu_exact, dtype, dropout, quant, layout)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                ctx_offset: Optional[int] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), key_padding_mask, ctx_offset)
        return x + self.mlp(self.norm2(x))


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """The JAX MMDiTConfig's fields that the port reads. The layout fields
    (``mesh`` and its axes) come from ``AVDiffusionConfig.from_config``;
    ``model_axis`` is the port's own: JAX expresses tensor parallelism
    through parameter shardings instead."""

    d_model: int = 1024
    n_layers: int = 16
    n_heads: int = 16
    mlp_ratio: float = 4.0
    dropout: float = 0.1
    attn_dropout: float = 0.0
    token_dropout: float = 0.0
    norm: str = "rmsnorm"
    rope: bool = False
    gelu_exact: bool = True
    dtype: Any = torch.float32
    # pad the token axis to a multiple of this; pad rows are masked keys and
    # their outputs are sliced off
    seq_multiple: int = 1
    # "int8": W8A8 hot projections on eval-mode passes (ops/quant.py)
    quant: str = "none"
    # recompute each block's activations in the backward pass of a training
    # pass (parallel.remat_core)
    remat: bool = False
    # layouts over a mesh of ranks (parallel/mesh.py)
    mesh: Any = None
    model_axis: Optional[str] = None
    context_axis: Optional[str] = None
    context_flash: bool = False
    pipe_axis: Optional[str] = None
    pipe_microbatches: int = 4

    @classmethod
    def from_dict(cls, d: dict, **overrides) -> "MMDiTConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw.update(overrides)
        return cls(**kw)


def remat_block(blk: nn.Module, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor],
                ctx_offset: Optional[int] = None) -> torch.Tensor:
    """blk(x, ...) under non-reentrant activation checkpointing. The state of
    each generator its dropouts draw from is saved now; the recompute in the
    backward pass starts from it (the same masks as this forward) and puts
    back afterwards the state it found. torch's own preserve_rng_state only
    covers the global generators, which the port never draws from. The
    recompute takes the attention path of this forward, also when the
    backward runs after an ``attention_path`` scope has closed."""
    gens = list({id(m.generator): m.generator for m in blk.modules()
                 if isinstance(m, Dropout) and m.rate > 0.0 and m.generator is not None
                 }.values())
    saved = [g.get_state() for g in gens]
    path = forced_path()
    calls = [0]

    def run(x, key_padding_mask):
        calls[0] += 1
        if calls[0] == 1:  # the forward pass itself
            return blk(x, key_padding_mask, ctx_offset)
        found = [g.get_state() for g in gens]
        for g, s in zip(gens, saved):
            g.set_state(s)
        try:
            with attention_path(path):
                return blk(x, key_padding_mask, ctx_offset)
        finally:
            for g, s in zip(gens, found):
                g.set_state(s)

    return checkpoint(run, x, key_padding_mask, use_reentrant=False, preserve_rng_state=False)


class MMDiT(nn.Module):
    """Stack of self-attention blocks over the concatenated token sequence,
    then a final norm. forward(x [B, N, d], key_padding_mask [B, N] bool
    True=PAD) -> [B, N, d]."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        if cfg.quant not in QUANT_MODES:
            raise ValueError(f"model.core.quant must be none|int8, got {cfg.quant!r}")
        self.cfg = cfg
        L = self.layout = CoreLayout(cfg.mesh, cfg.model_axis, cfg.context_axis,
                                     cfg.context_flash, cfg.pipe_axis, cfg.pipe_microbatches)
        self.token_drop = TokenDropout(cfg.token_dropout)
        self.blocks = nn.ModuleList(
            Block(cfg.d_model, cfg.n_heads, cfg.mlp_ratio, cfg.norm, cfg.rope,
                  cfg.gelu_exact, cfg.dtype, cfg.dropout, cfg.attn_dropout, cfg.quant, L)
            for _ in range(cfg.n_layers))
        self.norm = make_norm(cfg.norm, cfg.d_model, cfg.dtype)
        # the blocks' activations are token shards under context parallelism;
        # attention probabilities and the MLP's hidden units are split by heads
        # and units under tensor parallelism
        split_dropout(self.blocks, 1, L.ctx_n, L.ctx_i)
        for blk in self.blocks:
            split_dropout([blk.attn.attn_drop], 1, L.tp_n, L.tp_i)
            split_dropout([blk.mlp.drop1], 2, L.tp_n, L.tp_i)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg, L = self.cfg, self.layout
        if x.shape[-1] != cfg.d_model:
            raise ValueError(f"expected width {cfg.d_model}, got {x.shape[-1]}")
        x = self.token_drop(x.to(cfg.dtype))
        B, N, _ = x.shape
        # under context parallelism the padded sequence also divides the ring;
        # the pipeline pads nothing (as the JAX core)
        mult = max(1, cfg.seq_multiple)
        if L.ctx_n > 1:
            mult = math.lcm(mult, L.ctx_n)
        x, pad_n = pad_to_multiple(x, 1 if L.pipe_n > 1 else mult, axis=1)
        if pad_n:
            if key_padding_mask is None:
                key_padding_mask = torch.zeros((B, N), dtype=torch.bool, device=x.device)
            key_padding_mask = F.pad(key_padding_mask, (0, pad_n), value=True)
        if L.pipe_n > 1:
            if self.training and (cfg.dropout > 0.0 or cfg.attn_dropout > 0.0):
                raise NotImplementedError(
                    "pipeline-parallel training requires dropout == 0 (stages run "
                    "deterministically inside the schedule)")
            from ..parallel.pipeline import pipeline_apply, stage_blocks

            stage_fn, params = stage_blocks(self, L.mesh, L.pipe_axis)
            x = pipeline_apply(stage_fn, params, x, L.mesh, L.pipe_axis,
                               L.pipe_microbatches, key_padding_mask)
        else:
            remat = cfg.remat and self.training and torch.is_grad_enabled()
            offset = None
            if L.ctx_n > 1:
                offset = L.ctx_i * (x.shape[1] // L.ctx_n)
                x = comm.scatter_to_group(x, L.ctx_group, 1)
            for blk in self.blocks:
                if remat:
                    x = remat_block(blk, x, key_padding_mask, offset)
                else:
                    x = blk(x, key_padding_mask, offset)
            if L.ctx_n > 1:
                x = comm.gather_from_group(x, L.ctx_group, 1)
        if pad_n:
            x = x[:, :N]
        return self.norm(x)
