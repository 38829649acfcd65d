"""CPU tests of chip_smoke.py's check of a kernel against its plain version, and of its repeat check.

The mean bound must pass bf16 rounding noise, and the fp32 max bound fp32
rounding noise, and each must fail an output that lacks one tile of work: a key tile of attention, which the max bound alone can
pass at long key lengths, or a (tap, 64-channel chunk) of the conv."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from rollingdepth_torch.ops import conv3x3 as pc
from rollingdepth_torch.ops import flash_attention as fa

SHAPES = [(2, 999, 1, 64), (1, 300, 2, 40)]  # [B, L, H, D]


def _case(shape, no_max):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16() for _ in range(3))
    plain = lambda kk, vv: fa.attention_exp2_reference(q, kk, vv, no_max=no_max)  # noqa: E731
    return q, k, v, plain


@pytest.mark.parametrize("no_max", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_rounding_noise_passes(shape, no_max):
    q, k, v, plain = _case(shape, no_max)
    ref = plain(k, v)
    # the same attention in fp32, rounded once: a kernel with other roundings
    got = fa.attention_exp2_reference(q.float(), k.float(), v.float(), no_max=no_max).bfloat16()
    errs = cs.held_to_plain("noise", got, ref, True, lambda: plain(*cs.drop_key_tile(torch, k, v)))
    assert errs["mean_abs_err"] <= errs["mean_tol"] < errs["dropped_tile_shift"]


@pytest.mark.parametrize("shape", SHAPES)
def test_dropped_key_tile_fails(shape):
    q, k, v, plain = _case(shape, True)
    ref = plain(k, v)
    dropped = plain(*cs.drop_key_tile(torch, k, v))
    assert cs.drop_key_tile(torch, k, v)[0].shape[1] == shape[1] - cs.DROPPED_KEYS
    with pytest.raises(AssertionError):
        cs.held_to_plain("dropped", dropped, ref, True, lambda: dropped)


# ---- fp32 (the 3xTF32 kernels): the max bound, 1e-4 of the output's scale,
# with the same control: the plain version without one key tile must fail it


def _case_fp32(shape, no_max):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) for _ in range(3))
    plain = lambda kk, vv: fa.attention_exp2_reference(q, kk, vv, no_max=no_max, sum_rounded=False)  # noqa: E731
    return q, k, v, plain


@pytest.mark.parametrize("no_max", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_fp32_rounding_noise_passes(shape, no_max):
    q, k, v, plain = _case_fp32(shape, no_max)
    ref = plain(k, v)
    # the same attention in fp64, rounded once: a kernel with other sum orders
    got = fa.attention_exp2_reference(q.double(), k.double(), v.double(), no_max=no_max).float()
    errs = cs.held_to_plain("noise", got, ref, False, lambda: plain(*cs.drop_key_tile(torch, k, v)))
    assert errs["max_abs_err"] <= errs["tol"] < errs["dropped_tile_shift"]


@pytest.mark.parametrize("shape", SHAPES)
def test_fp32_dropped_key_tile_fails(shape):
    q, k, v, plain = _case_fp32(shape, False)
    ref = plain(k, v)
    dropped = plain(*cs.drop_key_tile(torch, k, v))
    with pytest.raises(AssertionError):
        cs.held_to_plain("dropped", dropped, ref, False, lambda: dropped)


# ---- the conv kernels (K4, K5): the control drops one (tap, 64-channel chunk)

CONV_SHAPES = [(1, 5, 65, 72, 136), (2, 9, 13, 128, 64)]  # [N, H, W, Cin, Cout]


def _conv_case(shape):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), dtype=np.float32)).bfloat16()
    wt = torch.from_numpy(rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * (9 * cin) ** -0.5).bfloat16()
    b = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32)).bfloat16()
    return x, wt, b


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_rounding_noise_passes(shape):
    x, wt, b = _conv_case(shape)
    ref = pc.conv3x3_reference(x, wt, b)
    # the same conv in fp32 with the bias, rounded once: a kernel with other roundings
    got = pc.conv3x3_reference(x.float(), wt.float(), b.float()).bfloat16()
    errs = cs.held_to_plain("noise", got, ref, True, lambda: pc.conv3x3_reference(x, cs.drop_tap_chunk(torch, wt), b))
    assert errs["mean_abs_err"] <= errs["mean_tol"] < errs["dropped_tile_shift"]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_dropped_tap_chunk_fails(shape):
    x, wt, b = _conv_case(shape)
    ref = pc.conv3x3_reference(x, wt, b)
    w_dropped = cs.drop_tap_chunk(torch, wt)
    c0 = (shape[3] - 1) // 64 * 64
    assert not w_dropped[0, 0, c0:].any() and torch.equal(w_dropped[0, 0, :c0], wt[0, 0, :c0])
    assert torch.equal(w_dropped[1:], wt[1:]) and torch.equal(w_dropped[0, 1:], wt[0, 1:])
    dropped = pc.conv3x3_reference(x, w_dropped, b)
    with pytest.raises(AssertionError):
        cs.held_to_plain("dropped", dropped, ref, True, lambda: dropped)


@pytest.mark.parametrize("lat_hw, calls", [((54, 96), 15), ((72, 128), 16), ((45, 80), 15), ((36, 64), 15)])
def test_narrow_kernel_calls_at_sd2_width(lat_hw, calls):
    """The smoke's launch rule for the SD2 UNet: the mid-block (3 frames of
    7x12 = 252 tokens at 768x432) stays under the auto rule's 256 tokens,
    and takes the kernel at 1024x576 (432 tokens)."""
    from rollingdepth_torch.models.unet import UNetConfig
    from rollingdepth_torch.ops import attention as attn

    assert cs.narrow_kernel_calls(attn, UNetConfig.sd21(), 3, *lat_hw) == calls


@pytest.mark.parametrize("lat_hw", [(20, 40), (13, 22), (36, 70)])
def test_narrow_kernel_calls_match_the_model(monkeypatch, lat_hw):
    """The rule counted level by level equals the self-attention calls a
    UNet call sends to the auto rule's kernels (here on the CPU, where the
    dispatch is spied on as if the tensors lay on the card)."""
    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.ops import attention as attn

    cfg = UNetConfig(sample_size=8, block_out_channels=(32, 64, 128, 128), attention_head_dim=(1, 2, 4, 4),
                     norm_num_groups=8, cross_attention_dim=16)
    want = cs.narrow_kernel_calls(attn, cfg, 3, *lat_hw)
    seen = []
    rule = attn.auto_selects_kernel

    def spy(on_cuda, lq, lk, d):
        if rule(True, lq, lk, d) and d < 128:
            seen.append(lq)
        return False

    monkeypatch.setattr(attn, "auto_selects_kernel", spy)
    unet = UNet2DConditionModel(cfg, device="cpu")
    with torch.no_grad():
        unet(torch.zeros((1, 3) + lat_hw + (8,)), 999, torch.zeros((1, 2, 16)))
    assert len(seen) == want > 0


def test_launches_implied_by_chunks():
    from rollingdepth_torch.models.unet import UNetConfig
    from rollingdepth_torch.ops import attention as attn

    class Pipe:
        class unet:
            config = UNetConfig.sd21()

    chunks = {"encode": 30, "unet": 14, "decode": 30, "refine_unet": 31}
    assert cs.attention_kernel_launches(attn, Pipe, chunks, (72, 128), 3, 3, "flash_attention_nomax") == {
        "flash_attention_nomax": 16 * 45, "flash_attention_max": 0, "flash_attention_wide": 60}
    assert cs.attention_kernel_launches(attn, Pipe, {"encode": 3, "unet": 2, "decode": 3}, (54, 96), 3, 3,
                                        "flash_attention_max") == {
        "flash_attention_nomax": 0, "flash_attention_max": 30, "flash_attention_wide": 6}


# ---- the relight phase's launch rule (SD1.5: narrow d = 40, 80; wide d = 160)


@pytest.mark.parametrize("n, calls", [(3, {"narrow": 10, "wide": 6}), (1, {"narrow": 10, "wide": 5})])
def test_unet_kernel_calls_at_sd15_width(n, calls):
    """At 720x640 (latent 80x90): levels 0-1 narrow, level 2 (23x20) wide;
    the mid-block (10x12) takes the kernel on 3 frames (360 tokens), not on
    one (120)."""
    from rollingdepth_torch.models.unet import UNetConfig
    from rollingdepth_torch.ops import attention as attn

    assert cs.unet_kernel_calls(attn, UNetConfig.sd15(12), n, 80, 90) == calls
    assert cs.narrow_kernel_calls(attn, UNetConfig.sd15(12), n, 80, 90) == calls["narrow"]


def test_relight_launches_implied_by_chunks():
    """The smoke's timed relight call: 24 frames, 32 windows in 4 chunks of
    8 and 24 frames in 3 t2i chunks, 20 steps each; 12 encode and 24 decode
    chunks of 4."""
    from rollingdepth_torch.models.unet import UNetConfig
    from rollingdepth_torch.ops import attention as attn

    class Pipe:
        class unet:
            config = UNetConfig.sd15(12)

    chunks = {"encode": 12, "t2i_unet": 60, "unet": 80, "decode": 24}
    assert cs.relight_kernel_launches(attn, Pipe, chunks, (80, 90), 3, "flash_attention_nomax") == {
        "flash_attention_nomax": 10 * 80 + 10 * 60, "flash_attention_max": 0,
        "flash_attention_wide": 6 * 80 + 5 * 60 + 12 + 24}


def test_relight_cut_launches_are_every_narrow_launch():
    """SD1.5's narrow heads are d = 40 and 80: every K1 launch of a relight
    call runs its products narrower than the padding; SD2's d = 64 none."""
    from rollingdepth_torch.models.unet import UNetConfig
    from rollingdepth_torch.ops import attention as attn
    from rollingdepth_torch.ops import flash_attention as fa

    class Pipe:
        class unet:
            config = UNetConfig.sd15(12)

    chunks = {"encode": 12, "t2i_unet": 60, "unet": 80, "decode": 24}
    want = cs.relight_kernel_launches(attn, Pipe, chunks, (80, 90), 3, "flash_attention_nomax")
    assert cs.relight_cut_launches(attn, fa, Pipe, chunks, (80, 90), 3, "flash_attention_nomax") == {
        "flash_attention_nomax": want["flash_attention_nomax"], "flash_attention_max": 0}
    Pipe.unet.config = UNetConfig.sd21()
    assert cs.relight_cut_launches(attn, fa, Pipe, chunks, (54, 96), 3, "flash_attention_max") == {
        "flash_attention_nomax": 0, "flash_attention_max": 0}


def test_relight_launches_match_a_run(monkeypatch):
    """The rule against the attention calls a whole relight forward sends
    to the auto rule's kernels (on the CPU, the dispatch spied on as if the
    tensors lay on the card), on a small pipeline whose UNet has narrow and
    wide heads above 256 tokens and whose VAE mid-block is wide."""
    import dataclasses

    from rollingdepth_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
    from rollingdepth_torch.ops import attention as attn
    from rollingdepth_torch.pipelines.rollingimg import RollingImgPipeline
    from rollingdepth_torch.schedulers.dpmsolver import DPMSolverConfig, DPMSolverMultistepScheduler
    from rollingdepth_torch.utils.synthetic import byte_tokenizer

    cfg = dict(sample_size=8, block_out_channels=(64, 256, 256, 256), attention_head_dim=2, norm_num_groups=8,
               cross_attention_dim=16, use_linear_projection=False)
    unet = UNet2DConditionModel(UNetConfig(in_channels=12, **cfg), device="cpu")
    base = UNet2DConditionModel(UNetConfig(in_channels=4, **cfg), device="cpu")
    vae = AutoencoderKL(dataclasses.replace(VAEConfig.tiny(), block_out_channels=(128, 128)), device="cpu")
    text = CLIPTextModel(dataclasses.replace(CLIPTextConfig.tiny(), vocab_size=49408, max_position_embeddings=77),
                         device="cpu")
    pipe = RollingImgPipeline(unet, vae, DPMSolverMultistepScheduler(DPMSolverConfig(
        algorithm_type="sde-dpmsolver++", use_karras_sigmas=True)), byte_tokenizer(), text, base_unet=base,
        dtype=torch.float32, snippet_batch=2, device="cpu")

    seen = {"narrow": 0, "wide": 0}
    rule = attn.auto_selects_kernel

    def spy(on_cuda, lq, lk, d):
        if rule(True, lq, lk, d):
            seen["narrow" if d < 128 else "wide"] += 1
        return False

    monkeypatch.setattr(attn, "auto_selects_kernel", spy)
    frames = np.random.default_rng(0).random((5, 3, 48, 48), dtype=np.float32) * 2 - 1
    pipe.forward(frames, frames[::-1].copy(), dilations=[1], num_inference_steps=4,
                 coalign_kwargs={"num_iterations": 0})
    monkeypatch.undo()  # the rule itself again
    want = cs.relight_kernel_launches(attn, pipe, pipe.last_chunks, (24, 24), 3, "flash_attention_nomax")
    assert seen["narrow"] == want["flash_attention_nomax"] > 0
    assert seen["wide"] == want["flash_attention_wide"] > pipe.last_chunks["encode"] + pipe.last_chunks["decode"]


# ---- the train phase: launches a step implies, and the parameter check


@pytest.mark.parametrize("lat_hw, narrow", [((60, 80), 15), ((48, 64), 15)])
def test_train_launches_at_sd2_width(lat_hw, narrow):
    """480x640 (the smoke's size) and 384x512: levels 0-2 on K1 (5 calls
    each), the mid-block (3 x 8 x 10 = 240 tokens) plain; one K3 launch per
    encode chunk."""
    from rollingdepth_torch.models.unet import UNetConfig
    from rollingdepth_torch.ops import attention as attn

    assert cs.train_kernel_launches(attn, UNetConfig.sd21(), 3, lat_hw, 4, 8) == {
        "flash_attention_nomax": narrow * 4, "flash_attention_max": 0, "flash_attention_wide": 8}


def test_train_launches_match_a_run(monkeypatch):
    """The rule against the attention calls the dataset's encode and two
    train steps send to the auto rule's kernels (on the CPU, the dispatch
    spied on as if the tensors lay on the card), with a UNet whose level 0
    is narrow and level 1 wide above 256 tokens, and a VAE whose mid-block
    head is wide."""
    import dataclasses

    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
    from rollingdepth_torch.ops import attention as attn
    from rollingdepth_torch.schedulers.ddim import DDIMScheduler
    from rollingdepth_torch.training import TrainConfig, make_train_step
    from rollingdepth_torch.training_data import SnippetDataConfig, SnippetLatentDataset, vae_encode_fn

    cfg = UNetConfig(sample_size=8, block_out_channels=(64, 256), attention_head_dim=(2, 1), norm_num_groups=8,
                     cross_attention_dim=8, layers_per_block=1, down_block_types=("CrossAttnDownBlock2D",
                                                                                 "CrossAttnDownBlock2D"),
                     up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"))
    torch.manual_seed(0)
    unet = UNet2DConditionModel(cfg, device="cpu")
    vae = AutoencoderKL(dataclasses.replace(VAEConfig.tiny(), block_out_channels=(128, 128)), device="cpu")
    seen = {"narrow": 0, "wide": 0}
    rule = attn.auto_selects_kernel

    def spy(on_cuda, lq, lk, d):
        if rule(True, lq, lk, d):
            seen["narrow" if d < 128 else "wide"] += 1
        return False

    monkeypatch.setattr(attn, "auto_selects_kernel", spy)
    rng = np.random.default_rng(0)
    rgb = [rng.uniform(-1, 1, (5, 3, 40, 40)).astype(np.float32)]
    depth = [rng.uniform(-1, 1, (5, 1, 40, 40)).astype(np.float32)]
    data = SnippetLatentDataset(vae_encode_fn(vae, 2), rgb, depth, SnippetDataConfig(dilations=(1,), batch_size=1),
                                device="cpu")
    step = make_train_step(unet, DDIMScheduler(), TrainConfig())
    for i, batch in enumerate(data.epoch(0)):
        step(dict(batch, text_embed=torch.zeros((1, 2, 8))))
        if i == 1:
            break
    monkeypatch.undo()
    want = cs.train_kernel_launches(attn, cfg, 3, (20, 20), 2, 2 * 3)  # 5 frames in chunks of 2, rgb and depth
    assert seen["narrow"] == want["flash_attention_nomax"] > 0
    assert seen["wide"] == want["flash_attention_wide"] > 6


def test_params_within_allows_a_sign_flip_only():
    """Two lr apart (a flipped first Adam update) passes; three fail, as does
    a missing parameter."""
    lr = 1e-3
    ref = {"a": torch.zeros(4), "b": torch.ones(2, 3)}
    got = {"a": torch.tensor([0.0, 2 * lr, -2 * lr, 1e-7]), "b": torch.ones(2, 3)}
    out = cs.params_within("flip", got, ref, lr)
    assert out["param"] == "a" and out["max_abs_diff"] == pytest.approx(2 * lr) and out["tol"] == pytest.approx(
        1e-6 + 2.2 * lr)
    with pytest.raises(AssertionError, match="moved apart"):
        cs.params_within("far", {"a": got["a"], "b": ref["b"] + 3 * lr}, ref, lr)
    with pytest.raises(AssertionError, match="names"):
        cs.params_within("missing", {"a": got["a"]}, ref, lr)


@pytest.mark.parametrize("kind", ["tensor", "array"])
def test_held_equal_passes_bits_and_refuses_one_ulp(capsys, kind):
    """The repeat check logs its counts and holds two runs bit for bit: one
    element one ulp apart fails it, which any tolerance would pass."""
    a = np.random.default_rng(0).standard_normal((4, 1, 8, 8)).astype(np.float32)
    b = a.copy()
    b[1, 0, 2, 3] = np.nextafter(b[1, 0, 2, 3], np.float32(np.inf))
    wrap = torch.from_numpy if kind == "tensor" else np.asarray
    cs.held_equal("same", wrap(a), wrap(a.copy()), 0.5)
    logged = capsys.readouterr().out
    assert '"path": "same"' in logged and '"elements": 256' in logged and '"differ": 0' in logged
    with pytest.raises(AssertionError, match="differ"):
        cs.held_equal("ulp", wrap(a), wrap(b), 0.0)
    assert '"differ": 1' in capsys.readouterr().out


def test_measure_repeats_logs_a_difference_and_goes_on(capsys, monkeypatch):
    """With ``--measure-repeats`` a differing pair is logged and noted, not raised."""
    monkeypatch.setattr(cs, "REPEATS_DIFFERED", [])
    a = np.zeros((2, 3), np.float32)
    b = a.copy()
    b[0, 1] = 0.25
    cs.held_equal("same", a, a.copy(), 0.0, measure_only=True)
    cs.held_equal("apart", a, b, 0.0, measure_only=True)
    assert cs.REPEATS_DIFFERED == ["apart"]
    assert '"path": "apart"' in capsys.readouterr().out
