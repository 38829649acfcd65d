"""BRIA RMBG-1.4 background matting (the U²-Net), as an ``nn.Module``.

Counterpart of ``rollingdepth_tpu/models/rmbg.py``, in NCHW with the
reference module tree's parameter names (``conv_in``, ``stage1`` ..
``stage6``, ``stage5d`` .. ``stage1d``, ``side1`` .. ``side6``; each
REBNCONV a ``conv_s1`` and a ``bn_s1``), so released RMBG weights load
with ``load_state_dict``.  Six encoder stages over a stride-2 ``conv_in``,
five decoder stages, and six sigmoid side outputs at the input's size; the
relight pipeline takes the first as the alpha matte.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


class REBNCONV(nn.Module):
    """3x3 conv (dilation = padding = ``dirate``), eval-mode BatchNorm, ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.dirate = dirate
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn_s1
        y = F.batch_norm(self.conv_s1(x), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu(y)


def _maxpool_ceil(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(src: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear with half-pixel centres.  The JAX module's resize equals this
    only when it enlarges (shrinking, it antialiases), and the U²-Net only
    ever enlarges: ceil-mode pooling keeps every coarser map at least half
    the finer one."""
    size = tuple(int(s) for s in size)
    if tuple(src.shape[2:]) == size:
        return src
    assert size[0] >= src.shape[2] and size[1] >= src.shape[3], (tuple(src.shape), size)
    return F.interpolate(src, size=size, mode="bilinear", align_corners=False)


class RSU(nn.Module):
    """Residual U-block of ``depth`` levels (RSU-7 .. RSU-4): max-pooled
    encoder, a dilation-2 bottom, bilinear-upsampled decoder."""

    def __init__(self, depth: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.depth = depth
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, depth):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        setattr(self, f"rebnconv{depth}", REBNCONV(mid_ch, mid_ch, dirate=2))
        for i in range(depth - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNCONV(mid_ch * 2, mid_ch))
        self.rebnconv1d = REBNCONV(mid_ch * 2, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        depth = self.depth
        hxin = self.rebnconvin(x)
        encs: List[torch.Tensor] = []
        hx = hxin
        for i in range(1, depth):
            hx = getattr(self, f"rebnconv{i}")(hx)
            encs.append(hx)
            if i < depth - 1:
                hx = _maxpool_ceil(hx)
        hxd = getattr(self, f"rebnconv{depth}")(encs[-1])
        for i in range(depth - 1, 0, -1):
            hxd = getattr(self, f"rebnconv{i}d")(torch.cat([hxd, encs[i - 1]], dim=1))
            if i > 1:
                hxd = _upsample_like(hxd, encs[i - 2].shape[2:])
        return hxd + hxin


class RSU4F(nn.Module):
    """Dilated RSU: dilations 1, 2, 4, 8 and no pooling."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, dirate=1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, dirate=2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, dirate=4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, dirate=8)
        self.rebnconv3d = REBNCONV(mid_ch * 2, mid_ch, dirate=4)
        self.rebnconv2d = REBNCONV(mid_ch * 2, mid_ch, dirate=2)
        self.rebnconv1d = REBNCONV(mid_ch * 2, out_ch, dirate=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        hx1 = self.rebnconv1(hxin)
        hx2 = self.rebnconv2(hx1)
        hx3 = self.rebnconv3(hx2)
        hx4 = self.rebnconv4(hx3)
        hx3d = self.rebnconv3d(torch.cat([hx4, hx3], dim=1))
        hx2d = self.rebnconv2d(torch.cat([hx3d, hx2], dim=1))
        hx1d = self.rebnconv1d(torch.cat([hx2d, hx1], dim=1))
        return hx1d + hxin


# (name, depth or "4F", in, mid, out), encoder then decoder
STAGES = (
    ("stage1", 7, 64, 32, 64),
    ("stage2", 6, 64, 32, 128),
    ("stage3", 5, 128, 64, 256),
    ("stage4", 4, 256, 128, 512),
    ("stage5", "4F", 512, 256, 512),
    ("stage6", "4F", 512, 256, 512),
    ("stage5d", "4F", 1024, 256, 512),
    ("stage4d", 4, 1024, 128, 256),
    ("stage3d", 5, 512, 64, 128),
    ("stage2d", 6, 256, 32, 64),
    ("stage1d", 7, 128, 16, 64),
)
SIDE_CHANNELS = (64, 64, 128, 256, 512, 512)


class BriaRMBG(nn.Module):
    def __init__(self, device=None, dtype=torch.float32):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.conv_in = nn.Conv2d(3, 64, 3, stride=2, padding=1)
            for name, kind, i, m, o in STAGES:
                setattr(self, name, RSU4F(i, m, o) if kind == "4F" else RSU(kind, i, m, o))
            for k, ch in enumerate(SIDE_CHANNELS, start=1):
                setattr(self, f"side{k}", nn.Conv2d(ch, 1, 3, padding=1))
        self.to(dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[N, 3, H, W] -> six sigmoid side outputs [N, 1, H, W], finest first."""
        in_hw = x.shape[2:]
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        hx1 = self.stage1(self.conv_in(x))
        hx2 = self.stage2(_maxpool_ceil(hx1))
        hx3 = self.stage3(_maxpool_ceil(hx2))
        hx4 = self.stage4(_maxpool_ceil(hx3))
        hx5 = self.stage5(_maxpool_ceil(hx4))
        hx6 = self.stage6(_maxpool_ceil(hx5))

        hx5d = self.stage5d(torch.cat([_upsample_like(hx6, hx5.shape[2:]), hx5], dim=1))
        hx4d = self.stage4d(torch.cat([_upsample_like(hx5d, hx4.shape[2:]), hx4], dim=1))
        hx3d = self.stage3d(torch.cat([_upsample_like(hx4d, hx3.shape[2:]), hx3], dim=1))
        hx2d = self.stage2d(torch.cat([_upsample_like(hx3d, hx2.shape[2:]), hx2], dim=1))
        hx1d = self.stage1d(torch.cat([_upsample_like(hx2d, hx1.shape[2:]), hx1], dim=1))

        outs = []
        for k, feat in enumerate((hx1d, hx2d, hx3d, hx4d, hx5d, hx6), start=1):
            d = getattr(self, f"side{k}")(feat)
            outs.append(torch.sigmoid(_upsample_like(d, in_hw).float()).to(x.dtype))
        return outs
