"""``rollingdepth_torch/utils/bench_init.py`` against ``rollingdepth_tpu/utils/bench_init.py``
on the CPU: which parameters are zeros, ones or draws, and that the draws
follow the generator."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rollingdepth_torch.io.weights import state_dict_from_jax
from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
from rollingdepth_torch.ops.quant import quantize_unet_
from rollingdepth_torch.utils.bench_init import device_random_params, leaf_kind
from rollingdepth_tpu.models.unet import UNet2DCondition
from rollingdepth_tpu.models.unet import UNetConfig as JUNetConfig
from rollingdepth_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from rollingdepth_tpu.models.vae import VAEConfig as JVAEConfig
from rollingdepth_tpu.utils import bench_init as jbi

CODES = {"zeros": 0, "ones": 1, "normal": 2}


@pytest.mark.parametrize("model", ["unet", "vae"])
def test_leaf_kinds_match_jax(model):
    """Every parameter's kind equals JAX's ``_leaf_kind`` of the same leaf,
    carried to diffusers names by ``state_dict_from_jax``."""
    if model == "unet":
        params, module = UNet2DCondition(JUNetConfig.tiny()).init(jax.random.PRNGKey(0)), UNet2DConditionModel(
            UNetConfig.tiny(), device="cpu")
    else:
        params, module = JAutoencoderKL(JVAEConfig.tiny()).init(jax.random.PRNGKey(0)), AutoencoderKL(
            VAEConfig.tiny(), device="cpu")
    coded = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, CODES[jbi._leaf_kind(path)], np.float32), params)
    want = {name: int(t.flatten()[0]) for name, t in state_dict_from_jax(coded).items()}
    got = {name: CODES[leaf_kind(module, name)] for name, _ in module.named_parameters()}
    assert got == want


def test_fills_and_generator():
    """Biases 0, norm weights 1, the rest stddev * N(0, 1) in the given
    dtype; the same seed gives the same weights, another seed others."""
    def make(seed, dtype=torch.bfloat16):
        unet = UNet2DConditionModel(dataclasses.replace(UNetConfig.tiny(), block_out_channels=(32, 64)), device="cpu")
        return device_random_params(unet, torch.Generator().manual_seed(seed), dtype, stddev=0.02)

    a, b, c = make(0), make(0), make(1)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q), name
        kind = leaf_kind(a, name)
        if kind == "zeros":
            assert not p.any(), name
        elif kind == "ones":
            assert (p == 1).all(), name
        else:
            assert not torch.equal(p, r), name
    big = a.down_blocks[1].resnets[0].conv2.weight.float()
    assert abs(big.std().item() - 0.02) < 0.002 and abs(big.mean().item()) < 0.002
    f32 = make(0, torch.float32)
    w = f32.down_blocks[1].resnets[0].conv2.weight
    assert w.dtype == torch.float32 and torch.equal(w.to(torch.bfloat16), a.down_blocks[1].resnets[0].conv2.weight)


def test_int8_weights_are_left_alone():
    unet = quantize_unet_(UNet2DConditionModel(UNetConfig.tiny(), device="cpu"))
    before = unet.down_blocks[0].resnets[0].conv1.weight_q.clone()
    device_random_params(unet, torch.Generator().manual_seed(0), torch.bfloat16)
    assert torch.equal(unet.down_blocks[0].resnets[0].conv1.weight_q, before)
