"""The relight path on the card (``-m cuda``; every test skips without one).

- K1 and K3 at the SD1.5 heads (d = 40, 80, 160) and the relight path's
  token counts, against their plain versions (the bounds of
  ``test_torch_flash_attention.py``), with H = 8 heads;
- ``random_relight_pipeline`` at full SD1.5 width on a short clip at a
  small size: R/G/B finite in [0, 1], and the kernel launches equal to
  what ``chip_smoke.relight_kernel_launches`` derives from the chunks.

The card's machine has no JAX: ``python -m pytest tests/test_torch_relight_cuda.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from rollingdepth_torch.ops import flash_attention as fa


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name, lq, d", [
    ("nomax", 21600, 40), ("nomax", 5400, 80), ("nomax", 7200, 40), ("max", 1800, 80),
    ("wide", 1380, 160), ("wide", 360, 160), ("wide", 460, 160),
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kernels_at_relight_shapes(name, lq, d, dtype):
    """One launch, within 2e-2 (bf16) or 1e-4 (fp32) of the output scale
    of the plain version, as in ``test_torch_flash_attention.py``."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(lq + d)
    q, k, v = (torch.randn((2, lq, 8, d), generator=gen, device="cuda").to(getattr(torch, dtype)) for _ in range(3))
    wrapper = getattr(fa, f"flash_attention_{name}")
    before = wrapper.launches
    got = wrapper(q, k, v)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    plain = fa.attention_exp2_reference(q, k, v, no_max=name == "nomax", sum_rounded=name != "wide")
    err, scale = (got.float() - plain.float()).abs().max().item(), plain.float().abs().max().item()
    assert err <= (2e-2 if q.dtype == torch.bfloat16 else 1e-4) * scale, (err, scale)


@pytest.mark.cuda
def test_cuda_random_relight_pipeline_launches():
    import chip_smoke as cs
    from rollingdepth_torch.ops import attention as attn
    from rollingdepth_torch.utils.synthetic import random_relight_pipeline

    _cuda()
    pipe, _ = random_relight_pipeline("cuda", torch.bfloat16, seed=0, snippet_batch=4)
    assert attn.nomax_allowed()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fg = torch.rand((6, 3, 256, 320), generator=gen, device="cuda") * 2 - 1
    bg = torch.rand((6, 3, 256, 320), generator=gen, device="cuda") * 2 - 1
    fa.reset_launch_counts()
    out = pipe.forward(fg, bg, dilations=[1, 25], num_inference_steps=8, coalign_kwargs={"num_iterations": 20})
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in fa.KERNELS}
    want = cs.relight_kernel_launches(attn, pipe, pipe.last_chunks, (32, 40), 3, "flash_attention_nomax")
    assert launches == want and want["flash_attention_nomax"] > 0 and want["flash_attention_wide"] > 0
    assert fa.flash_attention_nomax.cut_launches == launches["flash_attention_nomax"]  # d = 40 and 80
    for c in (out.R_pred, out.G_pred, out.B_pred):
        assert c.shape == (6, 1, 256, 320) and np.isfinite(c).all() and c.min() >= 0 and c.max() <= 1
