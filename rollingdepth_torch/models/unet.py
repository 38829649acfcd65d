"""UNet2DCondition with a native snippet axis, as an ``nn.Module``.

Counterpart of ``rollingdepth_tpu/models/unet.py``.  The input is
``[S, n, h, w, C]``: S snippets of n frames.  Convolutions run on the
folded ``S*n`` batch; every transformer block views its activations as
``[S, n*h*w, C]``, so self-attention runs jointly over all frames of a
snippet (RollingDepth's cross-frame attention), and cross-attention to the
text embedding over the same tokens.  Parameter names are diffusers'.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.profiling import span
from . import layers as L


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 96
    in_channels: int = 8
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    # heads per level (diffusers' misnamed `attention_head_dim`)
    attention_head_dim: Union[int, Tuple[int, ...]] = (5, 10, 20, 20)
    norm_num_groups: int = 32
    use_linear_projection: bool = True
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "UNetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in known})

    @classmethod
    def sd21(cls, in_channels: int = 8) -> "UNetConfig":
        """SD2-based rollingdepth-v1-0 shape (8 input channels: rgb + depth latents)."""
        return cls(in_channels=in_channels)

    @classmethod
    def sd15(cls, in_channels: int = 4) -> "UNetConfig":
        """SD1.5 shape (the IC-Light relight family): 8 heads at every level
        (head dims 40, 80, 160), CLIP ViT-L context, 1x1 conv projections."""
        return cls(in_channels=in_channels, cross_attention_dim=768, attention_head_dim=8,
                   use_linear_projection=False)

    @classmethod
    def tiny(cls, in_channels: int = 8) -> "UNetConfig":
        return cls(
            sample_size=8, in_channels=in_channels,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            block_out_channels=(8, 16), layers_per_block=1, cross_attention_dim=8,
            attention_head_dim=2, norm_num_groups=4, use_linear_projection=True,
        )

    def heads_at(self, level: int) -> int:
        if isinstance(self.attention_head_dim, int):
            return self.attention_head_dim
        return self.attention_head_dim[level]


class Transformer2DModel(nn.Module):
    """GroupNorm, proj_in, one transformer block over the joint snippet
    tokens, proj_out, residual."""

    def __init__(self, cfg: UNetConfig, channels: int, heads: int):
        super().__init__()
        self.linear = cfg.use_linear_projection
        self.norm = nn.GroupNorm(cfg.norm_num_groups, channels, eps=1e-6)
        if self.linear:
            self.proj_in = nn.Linear(channels, channels)
            self.proj_out = nn.Linear(channels, channels)
        else:
            self.proj_in = nn.Conv2d(channels, channels, 1)
            self.proj_out = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [L.BasicTransformerBlock(channels, heads, channels // heads, cfg.cross_attention_dim)]
        )

    def forward(self, x: torch.Tensor, context: torch.Tensor, snippet: int) -> torch.Tensor:
        sn, c, h, w = x.shape
        s = sn // snippet
        hidden = L.group_norm(self.norm, x)
        if not self.linear:
            hidden = self.proj_in(hidden)
        hidden = hidden.permute(0, 2, 3, 1).reshape(s, snippet * h * w, c)  # joint snippet tokens
        if self.linear:
            hidden = self.proj_in(hidden)
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        if self.linear:
            hidden = self.proj_out(hidden)
        hidden = hidden.reshape(sn, h, w, c).permute(0, 3, 1, 2)
        if not self.linear:
            hidden = self.proj_out(hidden)
        return hidden + x


class _Block(nn.Module):
    """Down/up/mid block container: diffusers' ``resnets``, ``attentions``,
    ``downsamplers``/``upsamplers`` names."""

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
    def __init__(self, config: UNetConfig = UNetConfig(), device=None, dtype=torch.float32):
        super().__init__()
        self.config = cfg = config
        bo = cfg.block_out_channels
        g = cfg.norm_num_groups
        temb_ch = bo[0] * 4
        with torch.device(resolve_device(device)):
            self.conv_in = nn.Conv2d(cfg.in_channels, bo[0], 3, padding=1)
            self.time_embedding = TimestepEmbedding(bo[0], temb_ch)

            down = []
            out_ch = bo[0]
            for i, kind in enumerate(cfg.down_block_types):
                in_ch, out_ch = out_ch, bo[i]
                resnets = [L.ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, temb_ch, g, 1e-5)
                           for j in range(cfg.layers_per_block)]
                attns = ([Transformer2DModel(cfg, out_ch, cfg.heads_at(i)) for _ in resnets]
                         if kind == "CrossAttnDownBlock2D" else [])
                ds = [L.Downsample2D(out_ch, asymmetric_pad=False)] if i != len(bo) - 1 else None
                down.append(_Block(resnets, attns, downsamplers=ds))
            self.down_blocks = nn.ModuleList(down)

            self.mid_block = _Block(
                [L.ResnetBlock2D(bo[-1], bo[-1], temb_ch, g, 1e-5) for _ in range(2)],
                [Transformer2DModel(cfg, bo[-1], cfg.heads_at(len(bo) - 1))],
            )

            up = []
            rev = list(reversed(bo))
            out_ch = rev[0]
            for i, kind in enumerate(cfg.up_block_types):
                prev_out, out_ch = out_ch, rev[i]
                skip_ch = rev[min(i + 1, len(bo) - 1)]
                level = len(bo) - 1 - i
                resnets = []
                for j in range(cfg.layers_per_block + 1):
                    res_skip = skip_ch if j == cfg.layers_per_block else out_ch
                    res_in = prev_out if j == 0 else out_ch
                    resnets.append(L.ResnetBlock2D(res_in + res_skip, out_ch, temb_ch, g, 1e-5))
                attns = ([Transformer2DModel(cfg, out_ch, cfg.heads_at(level)) for _ in resnets]
                         if kind == "CrossAttnUpBlock2D" else [])
                us = [L.Upsample2D(out_ch)] if i != len(bo) - 1 else None
                up.append(_Block(resnets, attns, upsamplers=us))
            self.up_blocks = nn.ModuleList(up)

            self.conv_norm_out = nn.GroupNorm(g, bo[0], eps=1e-5)
            self.conv_out = nn.Conv2d(bo[0], cfg.out_channels, 3, padding=1)
        self.to(dtype)

    def forward(self, x: torch.Tensor, timesteps, context: torch.Tensor) -> torch.Tensor:
        """``x`` [S, n, h, w, C_in], ``timesteps`` [S] or scalar, ``context``
        [S or 1, L, D] -> epsilon (or v) prediction [S, n, h, w, C_out]."""
        cfg = self.config
        s, n, h, w, cin = x.shape
        with span("rd.unet", {"windows": s, "frames": n}):
            timesteps = torch.as_tensor(timesteps, device=x.device).reshape(-1).expand(s)
            if context.shape[0] == 1 and s > 1:
                context = context.expand(s, *context.shape[1:])
            context = context.to(x.dtype)

            t_emb = L.timestep_embedding(timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                         cfg.freq_shift).to(x.dtype)
            temb = self.time_embedding(t_emb).repeat_interleave(n, dim=0)  # [(S n), 4*bo0]

            hidden = x.reshape(s * n, h, w, cin).permute(0, 3, 1, 2)
            fmt = torch.channels_last if x.is_cuda else torch.contiguous_format
            hidden = self.conv_in(hidden.contiguous(memory_format=fmt))

            res_stack = [hidden]
            for block in self.down_blocks:
                for j, resnet in enumerate(block.resnets):
                    hidden = resnet(hidden, temb)
                    if len(block.attentions):
                        hidden = block.attentions[j](hidden, context, n)
                    res_stack.append(hidden)
                if hasattr(block, "downsamplers"):
                    hidden = block.downsamplers[0](hidden)
                    res_stack.append(hidden)

            mid = self.mid_block
            hidden = mid.resnets[0](hidden, temb)
            hidden = mid.attentions[0](hidden, context, n)
            hidden = mid.resnets[1](hidden, temb)

            for block in self.up_blocks:
                for j, resnet in enumerate(block.resnets):
                    hidden = torch.cat([hidden, res_stack.pop()], dim=1)
                    hidden = resnet(hidden, temb)
                    if len(block.attentions):
                        hidden = block.attentions[j](hidden, context, n)
                if hasattr(block, "upsamplers"):
                    # match the next skip's size (odd latent sizes)
                    target: Optional[Tuple[int, int]] = tuple(res_stack[-1].shape[2:]) if res_stack else None
                    hidden = block.upsamplers[0](hidden, target)

            hidden = self.conv_out(L.group_norm(self.conv_norm_out, hidden, silu=True))
            return hidden.permute(0, 2, 3, 1).reshape(s, n, h, w, cfg.out_channels)
