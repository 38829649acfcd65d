"""The training path on the card (``-m cuda``; every test skips without one).

- ``FlashAttention`` over each kernel (K1 bf16 and fp32, K2 bf16, K3 fp32)
  at moderate shapes: the forward launches the kernel once, the backward
  launches none, and dq, dk, dv are within 2e-2 (bf16) or 1e-4 (fp32) of
  each gradient's max |value| of autograd through ``plain_attention``;
- a small UNet whose level-0 self-attention takes K1 fp32 under the auto
  rule: train steps over ``SnippetLatentDataset`` batches launch the
  kernels ``chip_smoke.train_kernel_launches`` derives, every
  self-attention projection gets a nonzero gradient, and one step's loss,
  grad_norm and updated parameters agree with the plain attention path.

The card's machine has no JAX: ``python -m pytest tests/test_torch_training_cuda.py -m cuda --noconftest``.
"""

import os

import pytest
import torch

from rollingdepth_torch.ops import attention as attn
from rollingdepth_torch.ops import flash_attention as fa


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name, shape, dtype", [
    ("nomax", (2, 3000, 5, 64), "bfloat16"), ("nomax", (1, 2999, 3, 64), "float32"),
    ("max", (2, 1500, 10, 64), "bfloat16"), ("wide", (2, 1200, 1, 512), "float32"),
])
def test_cuda_function_grads_match_plain_autograd(name, shape, dtype):
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(shape[1])
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype)) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    wrapper = getattr(fa, f"flash_attention_{name}")
    before = wrapper.launches
    out = fa.FlashAttention.apply(wrapper, q, k, v, None)
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = torch.autograd.grad(attn.plain_attention(q, k, v), (q, k, v), g)
    bound = 2e-2 if dtype == "bfloat16" else 1e-4
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.isfinite().all()
        assert (a.float() - b.float()).abs().max().item() <= bound * b.float().abs().max().item()


@pytest.mark.cuda
def test_cuda_train_steps_through_the_kernels(tmp_path):
    import chip_smoke as cs
    from rollingdepth_torch.models.layers import init_random_
    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
    from rollingdepth_torch.schedulers.ddim import DDIMScheduler
    from rollingdepth_torch.training import TrainConfig, make_train_step, restore_train_state, save_train_state
    from rollingdepth_torch.training_data import SnippetDataConfig, SnippetLatentDataset, vae_encode_fn

    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    # level 0: d = 32 over 3 x 16 x 16 = 768 tokens (K1); level 1 stays under 256 tokens
    cfg = UNetConfig(sample_size=16, block_out_channels=(64, 128), attention_head_dim=2, norm_num_groups=8,
                     cross_attention_dim=16, layers_per_block=1,
                     down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                     up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
    unet = init_random_(UNet2DConditionModel(cfg, device="cuda"), gen)
    # a 4-level VAE (8x) whose mid-block head (d = 128) takes K3
    vae = init_random_(AutoencoderKL(VAEConfig(block_out_channels=(64, 64, 64, 128), norm_num_groups=8),
                                     device="cuda"), gen).eval()
    clips = [torch.rand((6, c, 128, 128), generator=gen, device="cuda") * 2 - 1 for c in (3, 1)]
    fa.reset_launch_counts()
    data = SnippetLatentDataset(vae_encode_fn(vae, 4), [clips[0]], [clips[1]],
                                SnippetDataConfig(dilations=(1,), batch_size=2), device="cuda")
    step = make_train_step(unet, DDIMScheduler(), TrainConfig(learning_rate=1e-4))
    text = torch.randn((1, 2, 16), generator=gen, device="cuda")
    batches = [dict(b, text_embed=text) for b in data.epoch(0)]
    for b in batches:
        m = step(b, gen)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in fa.KERNELS}
    assert launches == cs.train_kernel_launches(attn, cfg, 3, (16, 16), len(batches), 4) and len(batches) == 2
    assert launches["flash_attention_nomax"] > 0 and torch.isfinite(m["loss"])
    for name, p in unet.named_parameters():
        if ".attn1.to_" in name and name.endswith("weight"):
            assert p.grad.abs().max().item() > 0, name

    path = str(tmp_path / "train_state.pt")
    save_train_state(path, unet, step.optimizer)
    t = torch.tensor([100, 900], device="cuda")
    noise = torch.randn(batches[0]["depth_latent"].shape, generator=gen, device="cuda")
    runs = []
    for mode in ("auto", "xla"):
        restore_train_state(path, unet, step.optimizer)
        os.environ["ROLLINGDEPTH_ATTN"] = mode
        try:
            m = step(batches[0], timesteps=t, noise=noise)
        finally:
            del os.environ["ROLLINGDEPTH_ATTN"]
        runs.append((m["loss"].item(), m["grad_norm"].item(), m["lr"],
                     {n: p.detach().clone() for n, p in unet.named_parameters()}))
    (lk, gk, _, pk), (lp, gp, lr, pp) = runs
    assert abs(lk - lp) <= 1e-5 * abs(lp) and abs(gk - gp) <= 1e-4 * abs(gp)
    cs.params_within("card step", pk, pp, lr)
