"""The bf16 GroupNorm pair on the card (``-m cuda``; every card test skips without one).

- The pair (``ops/group_norm.py``, ``csrc/group_norm.cu``) against its plain
  version at every distinct bf16 norm input of a full ``fast`` chunk
  (``FAST_INPUTS``: one SD2 UNet call on 24 images at 54x96 latents, one VAE
  encode of 4 frames at 432x768 and one decode of 4 latents at 54x96; 27
  inputs, the up blocks' concatenated widths and the VAE decoder's
  upsampled levels among them), each with its groups, eps and silu, held as
  ``chip_smoke.py`` holds it (``held_norm``: the public wrapper's output by
  the bf16 kernel rule, bit for bit the plain version's pass on the pair's
  own statistics, the fp32 statistics within ``NORM_STATS_TOL`` of
  ``torch.var_mean``'s, two calls bit-equal);
- the same at ragged H*W and at 10, 20, 30, 80 and 4 channels a group
  (``chip_smoke.NORM_RAGGED``; not 16-byte aligned);
- the wrapper counts one launch a call, records it by input, and returns
  channels_last;
- an x in NCHW memory, and a call autograd would record, raise.

``FAST_INPUTS`` is read off the models themselves: the same calls on the
``meta`` device (shapes only, nothing computed or allocated), with the
wrapper recording its inputs.  ``test_fast_inputs_are_the_models_norms``
runs on the CPU too and holds the list to ``chip_smoke.py``'s launch formula.

The card's machine has no JAX: ``python -m pytest tests/test_torch_group_norm_cuda.py -m cuda --noconftest``.
"""

import pytest
import torch

import chip_smoke as cs
from rollingdepth_torch.ops import group_norm as gn

UNET_CHUNK, VAE_CHUNK, FRAME_HW = 24, 4, (432, 768)  # fast: snippet_batch 8 windows of 3; max_vae_bs 4


def fast_norm_inputs() -> dict:
    """{(N, C, H, W, groups, eps, silu): calls} of one ``fast`` UNet chunk, VAE
    encode and VAE decode at full SD2 width, traced on the ``meta`` device."""
    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig

    calls, wrapper = {}, gn.group_norm

    def record(x, weight, bias, groups, eps, silu=False):
        key = (*x.shape, groups, eps, silu)
        calls[key] = calls.get(key, 0) + 1
        return torch.empty_like(x)

    meta = dict(device="meta", dtype=torch.bfloat16)
    lat = (FRAME_HW[0] // 8, FRAME_HW[1] // 8)
    gn.group_norm = record
    try:
        unet = UNet2DConditionModel(UNetConfig.sd21(), device="meta").to(torch.bfloat16)
        vae = AutoencoderKL(VAEConfig(), device="meta").to(torch.bfloat16)
        with torch.no_grad():
            unet(torch.empty((UNET_CHUNK // 3, 3) + lat + (8,), **meta), 999, torch.empty((1, 77, 1024), **meta))
            vae.encode_mean(torch.empty((VAE_CHUNK,) + FRAME_HW + (3,), **meta))
            vae.decode(torch.empty((VAE_CHUNK,) + lat + (4,), **meta))
    finally:
        gn.group_norm = wrapper
    return calls


FAST_CALLS = fast_norm_inputs()
FAST_INPUTS = sorted(FAST_CALLS)
RAGGED_INPUTS = [(n, c, h, w, cs.NORM_GROUPS, cs.NORM_EPS, silu) for n, c, h, w, silu in cs.NORM_RAGGED]


def _inputs(shape, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cs.norm_inputs(torch, gen, *shape)


def test_fast_inputs_are_the_models_norms():
    """The list covers one UNet call, one encode and one decode, as many
    norms as ``chip_smoke.py`` counts launches for, at the chunk sizes."""
    from rollingdepth_torch.models.unet import UNetConfig
    from rollingdepth_torch.models.vae import VAEConfig

    by_n = {n: sum(k for (n2, *_), k in FAST_CALLS.items() if n2 == n) for n in (UNET_CHUNK, VAE_CHUNK)}
    assert by_n[UNET_CHUNK] == cs.unet_norm_calls(UNetConfig.sd21())
    assert by_n[VAE_CHUNK] == cs.vae_norm_calls(VAEConfig(), "encode") + cs.vae_norm_calls(VAEConfig(), "decode")
    assert len(FAST_INPUTS) == 27
    for must in ((4, 256, 432, 768, 32, 1e-6, True), (24, 2560, 7, 12, 32, 1e-5, True),
                 (24, 320, 54, 96, 32, 1e-6, False)):
        assert must in FAST_CALLS


@pytest.mark.cuda
@pytest.mark.parametrize("key", FAST_INPUTS + RAGGED_INPUTS,
                         ids=lambda k: "x".join(map(str, k[:4])) + f"-eps{k[5]:g}-" + ("norm_silu" if k[6] else "norm"))
def test_pair_against_the_plain_version(key):
    n, c, h, w, groups, eps, silu = key
    x, wt, b = _inputs((n, c, h, w))
    with torch.no_grad():
        out = cs.held_norm(torch, gn, f"{key}", x, wt, b, groups, eps, silu)
    assert out["repeat_equal"] and out["pass_exact"] and out["channels_last"]


@pytest.mark.cuda
def test_wrapper_counts_and_keeps_channels_last():
    x, w, b = _inputs((2, 320, 9, 16))
    gn.reset_launch_counts()
    with torch.no_grad():
        ys = [gn.group_norm(x, w, b, 32, 1e-6, silu=s) for s in (True, False, True)]
    assert gn.group_norm.launches == 3
    assert gn.group_norm.inputs == {(2, 320, 9, 16, 32, 1e-6, True): 2, (2, 320, 9, 16, 32, 1e-6, False): 1}
    for y in ys:
        assert y.shape == x.shape and y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
def test_nchw_memory_raises():
    x, w, b = _inputs((2, 320, 9, 16))
    with pytest.raises(ValueError, match="channels_last"):
        gn.group_norm(x.contiguous(), w, b, 32, 1e-6, silu=True)


@pytest.mark.cuda
def test_autograd_recording_raises():
    x, w, b = _inputs((2, 320, 9, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        gn.group_norm(x.detach().clone().requires_grad_(), w, b, 32, 1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        gn.group_norm(x, torch.nn.Parameter(w.clone()), b, 32, 1e-6)
