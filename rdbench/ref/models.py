"""Plain fp32 PyTorch copies of the SD models the benchmark checks against.

A frozen copy of the architecture of rollingdepth-v1-0 (the SD2 UNet with
a snippet axis, the SD VAE, the OpenCLIP ViT-H text tower), written from
diffusers' layer equations with diffusers' parameter names, so one seeded
state dict loads into these modules and into the program's.  Everything
runs in the input's dtype with stock operators: ``F.group_norm``,
``F.layer_norm``, cuDNN convolutions and matmul attention (query blocks,
fp32 softmax).  Imports nothing of the program.

Every GroupNorm and attention is a module call, so a counter can hook
them (``rdbench/counts``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# queries per block of the plain attention: bounds the live score matrix
ATTN_BLOCK_Q = 2048


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over ``[B, L, H, d]``, query block by block."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for i in range(0, q.shape[1], ATTN_BLOCK_Q):
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, i : i + ATTN_BLOCK_Q], k) * scale
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v))
    return torch.cat(outs, dim=1)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - shift))
    emb = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class Attention(nn.Module):
    """q/k/v projections, multi-head attention over ``[B, L, C]``, ``to_out.0``."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, cross_dim: Optional[int] = None,
                 qkv_bias: bool = False, norm_groups: Optional[int] = None):
        super().__init__()
        inner, kv_dim = heads * dim_head, cross_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Dropout(0.0)])
        if norm_groups is not None:
            self.group_norm = nn.GroupNorm(norm_groups, query_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, lq, _ = x.shape
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        d = q.shape[-1] // self.heads
        out = attention(q.reshape(b, lq, self.heads, d), k.reshape(b, ctx.shape[1], self.heads, d),
                        v.reshape(b, ctx.shape[1], self.heads, d))
        return self.to_out[0](out.reshape(b, lq, -1))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb_ch: Optional[int], groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb_ch is not None:
            self.time_emb_proj = nn.Linear(temb_ch, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


class Downsample2D(nn.Module):
    def __init__(self, ch: int, asymmetric_pad: bool):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0 if asymmetric_pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asymmetric_pad else x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor, size: Optional[Sequence[int]] = None) -> torch.Tensor:
        if size is None:
            return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return self.conv(F.interpolate(x, size=tuple(size), mode="nearest"))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Dropout(0.0), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_dim=cross_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim, dim * 4)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


# ---------------------------------------------------------------------------
# UNet with a snippet axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)
    up_block_types: Tuple[str, ...] = ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: Union[int, Tuple[int, ...]] = (5, 10, 20, 20)  # heads per level (diffusers' name)
    norm_num_groups: int = 32
    use_linear_projection: bool = True
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "UNetConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})

    def heads_at(self, level: int) -> int:
        h = self.attention_head_dim
        return h if isinstance(h, int) else h[level]


class Transformer2DModel(nn.Module):
    """GroupNorm, proj_in, one transformer block over the tokens of all n
    frames of a window together, proj_out, residual."""

    def __init__(self, cfg: UNetConfig, ch: int, heads: int):
        super().__init__()
        self.linear = cfg.use_linear_projection
        self.norm = nn.GroupNorm(cfg.norm_num_groups, ch, eps=1e-6)
        proj = (lambda: nn.Linear(ch, ch)) if self.linear else (lambda: nn.Conv2d(ch, ch, 1))
        self.proj_in, self.proj_out = proj(), proj()
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(ch, heads, ch // heads,
                                                                       cfg.cross_attention_dim)])

    def forward(self, x: torch.Tensor, context: torch.Tensor, n: int) -> torch.Tensor:
        sn, c, h, w = x.shape
        y = self.norm(x)
        if not self.linear:
            y = self.proj_in(y)
        y = y.permute(0, 2, 3, 1).reshape(sn // n, n * h * w, c)
        if self.linear:
            y = self.proj_in(y)
        for block in self.transformer_blocks:
            y = block(y, context)
        if self.linear:
            y = self.proj_out(y)
        y = y.reshape(sn, h, w, c).permute(0, 3, 1, 2)
        if not self.linear:
            y = self.proj_out(y)
        return y + x


class _Block(nn.Module):
    def __init__(self, resnets, attentions=(), downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsamplers is not None:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers is not None:
            self.upsamplers = nn.ModuleList(upsamplers)


class TimestepEmbedding(nn.Module):
    def __init__(self, ch: int, temb_ch: int):
        super().__init__()
        self.linear_1 = nn.Linear(ch, temb_ch)
        self.linear_2 = nn.Linear(temb_ch, temb_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        bo, g = cfg.block_out_channels, cfg.norm_num_groups
        temb_ch = bo[0] * 4
        self.conv_in = nn.Conv2d(cfg.in_channels, bo[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(bo[0], temb_ch)
        down, out_ch = [], bo[0]
        for i, kind in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, bo[i]
            res = [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, temb_ch, g, 1e-5)
                   for j in range(cfg.layers_per_block)]
            att = [Transformer2DModel(cfg, out_ch, cfg.heads_at(i)) for _ in res] if kind.startswith("CrossAttn") else []
            ds = [Downsample2D(out_ch, asymmetric_pad=False)] if i != len(bo) - 1 else None
            down.append(_Block(res, att, downsamplers=ds))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Block([ResnetBlock2D(bo[-1], bo[-1], temb_ch, g, 1e-5) for _ in range(2)],
                                [Transformer2DModel(cfg, bo[-1], cfg.heads_at(len(bo) - 1))])
        up, rev = [], list(reversed(bo))
        out_ch = rev[0]
        for i, kind in enumerate(cfg.up_block_types):
            prev_out, out_ch = out_ch, rev[i]
            skip_ch = rev[min(i + 1, len(bo) - 1)]
            res = [ResnetBlock2D((prev_out if j == 0 else out_ch) + (skip_ch if j == cfg.layers_per_block else out_ch),
                                 out_ch, temb_ch, g, 1e-5) for j in range(cfg.layers_per_block + 1)]
            att = ([Transformer2DModel(cfg, out_ch, cfg.heads_at(len(bo) - 1 - i)) for _ in res]
                   if kind.startswith("CrossAttn") else [])
            us = [Upsample2D(out_ch)] if i != len(bo) - 1 else None
            up.append(_Block(res, att, upsamplers=us))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, bo[0], eps=1e-5)
        self.conv_out = nn.Conv2d(bo[0], cfg.out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, t: int, context: torch.Tensor) -> torch.Tensor:
        """``x`` [S, n, h, w, C_in], one timestep ``t``, ``context`` [1, L, D]
        -> [S, n, h, w, C_out]."""
        cfg = self.config
        s, n, h, w, cin = x.shape
        context = context.to(x.dtype).expand(s, *context.shape[1:])
        t_emb = timestep_embedding(torch.full((s,), t, device=x.device), cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift).to(x.dtype)
        temb = self.time_embedding(t_emb).repeat_interleave(n, dim=0)
        y = self.conv_in(x.reshape(s * n, h, w, cin).permute(0, 3, 1, 2))
        stack = [y]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                y = res(y, temb)
                if len(block.attentions):
                    y = block.attentions[j](y, context, n)
                stack.append(y)
            if hasattr(block, "downsamplers"):
                y = block.downsamplers[0](y)
                stack.append(y)
        y = self.mid_block.resnets[0](y, temb)
        y = self.mid_block.attentions[0](y, context, n)
        y = self.mid_block.resnets[1](y, temb)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                y = res(torch.cat([y, stack.pop()], dim=1), temb)
                if len(block.attentions):
                    y = block.attentions[j](y, context, n)
            if hasattr(block, "upsamplers"):
                y = block.upsamplers[0](y, tuple(stack[-1].shape[2:]) if stack else None)
        y = self.conv_out(F.silu(self.conv_norm_out(y)))
        return y.permute(0, 2, 3, 1).reshape(s, n, h, w, cfg.out_channels)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def from_dict(cls, d: dict) -> "VAEConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})


class VAEMidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, None, groups, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([Attention(ch, 1, ch, qkv_bias=True, norm_groups=groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        a = self.attentions[0]
        n, c, h, w = x.shape
        y = a.group_norm(x).permute(0, 2, 3, 1).reshape(n, h * w, c)
        x = x + a(y).reshape(n, h, w, c).permute(0, 3, 1, 2)
        return self.resnets[1](x)


class _Stage(nn.Module):
    def __init__(self, resnets, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsamplers is not None:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers is not None:
            self.upsamplers = nn.ModuleList(upsamplers)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        bo, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, bo[0], 3, padding=1)
        stages, out_ch = [], bo[0]
        for i in range(len(bo)):
            in_ch, out_ch = out_ch, bo[i]
            res = [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, g, 1e-6) for j in range(cfg.layers_per_block)]
            stages.append(_Stage(res, downsamplers=[Downsample2D(out_ch, True)] if i != len(bo) - 1 else None))
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = VAEMidBlock(bo[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, bo[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(bo[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for stage in self.down_blocks:
            for r in stage.resnets:
                h = r(h)
            if hasattr(stage, "downsamplers"):
                h = stage.downsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(h))))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        bo, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, bo[-1], 3, padding=1)
        self.mid_block = VAEMidBlock(bo[-1], g)
        rev, stages = list(reversed(bo)), []
        out_ch = rev[0]
        for i in range(len(rev)):
            in_ch, out_ch = out_ch, rev[i]
            res = [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, g, 1e-6)
                   for j in range(cfg.layers_per_block + 1)]
            stages.append(_Stage(res, upsamplers=[Upsample2D(out_ch)] if i != len(rev) - 1 else None))
        self.up_blocks = nn.ModuleList(stages)
        self.conv_norm_out = nn.GroupNorm(g, bo[0], eps=1e-6)
        self.conv_out = nn.Conv2d(bo[0], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for stage in self.up_blocks:
            for r in stage.resnets:
                h = r(h)
            if hasattr(stage, "upsamplers"):
                h = stage.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode_mean(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] in [-1, 1] -> [N, h, w, 4]: the posterior mean times the scaling factor."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return (moments[:, : self.config.latent_channels] * self.config.scaling_factor).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[N, h, w, 4] -> [N, H, W, 3]."""
        y = self.post_quant_conv((z / self.config.scaling_factor).permute(0, 3, 1, 2))
        return self.decoder(y).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# CLIP text tower (last hidden state)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: dict) -> "CLIPTextConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inner)
        self.fc2 = nn.Linear(inner, d)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(d)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(d, cfg.intermediate_size)


class _TextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.num_hidden_layers)])


class CLIPTextModel(nn.Module):
    """HF ``CLIPTextModel``'s names without the ``text_model.`` prefix."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _TextEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, l = ids.shape
        heads, d = cfg.num_attention_heads, cfg.hidden_size
        x = self.embeddings.token_embedding(ids) + self.embeddings.position_embedding.weight[:l][None]
        causal = torch.full((l, l), float("-inf"), device=x.device).triu(1)
        if cfg.hidden_act == "quick_gelu":
            act = lambda y: y * torch.sigmoid(1.702 * y)  # noqa: E731
        else:
            act = F.gelu
        for layer in self.encoder.layers:
            h = layer.layer_norm1(x)
            a = layer.self_attn
            q, k, v = (p(h).reshape(b, l, heads, d // heads) for p in (a.q_proj, a.k_proj, a.v_proj))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d // heads) ** -0.5
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s + causal, dim=-1), v).reshape(b, l, d)
            x = x + a.out_proj(o)
            x = x + layer.mlp.fc2(act(layer.mlp.fc1(layer.layer_norm2(x))))
        return self.final_layer_norm(x)
