"""AutoencoderKL (SD VAE) as an ``nn.Module``, NHWC at its public boundary.

Counterpart of ``rollingdepth_tpu/models/vae.py``.  The pipeline uses the
pieces the reference pipeline uses: ``encode_mean`` (encoder, quant_conv,
posterior mean, times the scaling factor) and ``decode`` (divide by the
scaling factor, post_quant_conv, decoder).  The mid-block's single-head
spatial attention (d = 512 at full width) goes through the attention
dispatch, which sends it to the wide flash kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.profiling import span
from . import layers as L


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    mid_block_add_attention: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "VAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in known})

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)


class MidBlock(nn.Module):
    def __init__(self, ch: int, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        self.resnets = nn.ModuleList([L.ResnetBlock2D(ch, ch, None, g, 1e-6) for _ in range(2)])
        if cfg.mid_block_add_attention:
            self.attentions = nn.ModuleList(
                [L.Attention(ch, heads=1, dim_head=ch, qkv_bias=True, norm_groups=g)]
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        if hasattr(self, "attentions"):
            attn = self.attentions[0]
            n, c, h, w = x.shape
            hs = L.group_norm(attn.group_norm, x).permute(0, 2, 3, 1).reshape(n, h * w, c)
            hs = attn(hs).reshape(n, h, w, c).permute(0, 3, 1, 2)
            x = x + hs
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
        stages = []
        out_ch = bo[0]
        for i in range(len(bo)):
            in_ch, out_ch = out_ch, bo[i]
            resnets = [L.ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, g, 1e-6)
                       for j in range(cfg.layers_per_block)]
            ds = [L.Downsample2D(out_ch, asymmetric_pad=True)] if i != len(bo) - 1 else None
            stages.append(_Stage(resnets, downsamplers=ds))
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = MidBlock(bo[-1], cfg)
        self.conv_norm_out = nn.GroupNorm(g, bo[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(bo[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for stage in self.down_blocks:
            for r in stage.resnets:
                h = r(h)
            if hasattr(stage, "downsamplers"):
                h = stage.downsamplers[0](h)
        h = self.mid_block(h)
        return self.conv_out(L.group_norm(self.conv_norm_out, h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        bo, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, bo[-1], 3, padding=1)
        self.mid_block = MidBlock(bo[-1], cfg)
        rev = list(reversed(bo))
        stages = []
        out_ch = rev[0]
        for i in range(len(rev)):
            in_ch, out_ch = out_ch, rev[i]
            resnets = [L.ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, g, 1e-6)
                       for j in range(cfg.layers_per_block + 1)]
            us = [L.Upsample2D(out_ch)] if i != len(rev) - 1 else None
            stages.append(_Stage(resnets, upsamplers=us))
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
        return self.conv_out(L.group_norm(self.conv_norm_out, h, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig(), device=None, dtype=torch.float32):
        super().__init__()
        self.config = cfg = config
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)
            self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.to(dtype)

    @staticmethod
    def _nchw(x: torch.Tensor) -> torch.Tensor:
        fmt = torch.channels_last if x.is_cuda else torch.contiguous_format
        return x.permute(0, 3, 1, 2).contiguous(memory_format=fmt)

    def encode_mean(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] in [-1, 1] -> [N, h, w, latent] scaled posterior mean."""
        with span("rd.vae.encode", {"frames": x.shape[0]}):
            moments = self.quant_conv(self.encoder(self._nchw(x)))
            mean = moments[:, : self.config.latent_channels]
            return (mean * self.config.scaling_factor).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[N, h, w, latent] -> [N, H, W, 3]."""
        with span("rd.vae.decode", {"frames": z.shape[0]}):
            z = self.post_quant_conv(self._nchw(z / self.config.scaling_factor))
            return self.decoder(z).permute(0, 2, 3, 1)
