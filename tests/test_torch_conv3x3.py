"""The port's 3x3 conv kernels (``rollingdepth_torch.ops.conv3x3``).

On the CPU each wrapper runs ``conv3x3_reference``, the plain version of
the kernels' arithmetic.  It is held against the JAX Pallas kernels:
``conv3x3_same`` with ``interpret=True`` (K4) and ``conv3x3_same_db``
under ``pltpu.force_tpu_interpret_mode()`` (K5, whose double-buffered DMA
runs there as written), at ``tests/test_attention.py``'s cases, at a
shape on the CUDA kernels' tile edges (W = 65 one column past a 64-column
tile, H = 5 one row past a 4-row tile, Cin = 72 eight channels into a
second 64-channel chunk, Cout = 136 eight past a 128-channel tile) and,
for K5, at 256 channels (the width where Mosaic miscompiled it).  fp32 on
both sides, tolerance 1e-4, the one ``tests/test_attention.py`` holds K4
to against XLA.

The ``cuda`` tests hold each CUDA kernel against the plain version on the
card and skip without one.  JAX is imported inside the tests that use it,
so that on the card (which has no JAX) this file runs its ``cuda`` tests:
``python -m pytest tests/test_torch_conv3x3.py -m cuda --noconftest``."""

import numpy as np
import pytest
import torch

from rollingdepth_torch.ops import conv3x3 as pc

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
WRAPPERS = {"K4_sync": pc.conv3x3_same, "K5_db": pc.conv3x3_same_db}


def _inputs(n, h, w, cin, cout, bias, seed, w_scale=1.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) * w_scale).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) if bias else None
    return x, wt, b


def _pallas(kernel, x, w, b, bf16=False):
    """The Pallas kernel on the CPU: K4 in interpret mode, K5 under
    force_tpu_interpret_mode (its wrapper has no interpret argument)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from rollingdepth_tpu.ops.conv3x3 import conv3x3_same, conv3x3_same_db

    dtype = jnp.bfloat16 if bf16 else jnp.float32
    args = tuple(None if t is None else jnp.asarray(t).astype(dtype) for t in (x, w, b))
    if kernel == "K5_db":
        with pltpu.force_tpu_interpret_mode():
            out = conv3x3_same_db(*args, block_rows=8)
    else:
        out = conv3x3_same(*args, block_rows=8, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch(t, dtype=torch.float32):
    return None if t is None else torch.from_numpy(t).to(dtype)


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
@pytest.mark.parametrize("shape,cout,bias", [
    ((2, 20, 24, 8), 16, True),   # tests/test_attention.py:111-121
    ((1, 13, 24, 8), 16, False),  # odd height, no bias (:123-129)
    ((1, 5, 65, 72), 136, True),  # one past the CUDA kernels' tiles in W, H, Cin and Cout
], ids=["bias", "odd_height_no_bias", "tile_edge"])
def test_plain_matches_pallas_interpret(kernel, shape, cout, bias):
    x, w, b = _inputs(*shape, cout, bias, seed=shape[1])
    ref = _pallas(kernel, x, w, b)
    got = WRAPPERS[kernel](_torch(x), _torch(w), _torch(b))
    assert got.shape == (*shape[:3], cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_db_plain_matches_pallas_at_256_channels():
    """K5 at Cin = Cout = 256, where Mosaic miscompiled it on the TPU."""
    x, w, b = _inputs(1, 12, 16, 256, 256, True, seed=7, w_scale=1 / 48)
    ref = _pallas("K5_db", x, w, b)
    got = pc.conv3x3_same_db(_torch(x), _torch(w), _torch(b))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_plain_matches_pallas_bf16(kernel):
    """bf16 on both sides: the fp32 sum rounded to bf16, then the bias added
    and rounded again.  Tolerance: one bf16 rounding (2^-8) of the output
    scale; the sums differ only in order, so a rounding may land on the
    neighbouring value."""
    import jax.numpy as jnp

    x, w, b = _inputs(2, 20, 24, 8, 16, True, seed=3)
    x, w, b = (np.array(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32)) for t in (x, w, b))
    ref = _pallas(kernel, x, w, b, bf16=True)
    got = WRAPPERS[kernel](*(_torch(t, torch.bfloat16) for t in (x, w, b)))
    assert got.dtype == torch.bfloat16
    scale = np.abs(ref).max()
    assert np.abs(got.float().numpy() - ref).max() <= 2.0**-8 * scale


def test_cpu_wrappers_do_not_count_launches():
    x, w, b = _inputs(1, 6, 7, 8, 8, True, seed=1)
    pc.reset_launch_counts()
    for fn in pc.KERNELS:
        fn(_torch(x), _torch(w), _torch(b))
    assert [fn.launches for fn in pc.KERNELS] == [0, 0]


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_bf16_channels_must_be_multiples_of_8(kernel):
    """Off the CPU the bf16 kernels need Cin and Cout multiples of 8 (16-byte
    loads).  A meta tensor stands for the card's: it takes the kernel path,
    which raises before anything is built or launched."""
    x = torch.empty((1, 8, 8, 12), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, 3, 12, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiples of 8"):
        WRAPPERS[kernel](x, w)
    w2 = torch.empty((3, 3, 16, 20), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiples of 8"):
        WRAPPERS[kernel](torch.empty((1, 8, 8, 16), dtype=torch.bfloat16, device="meta"), w2)
    with pytest.raises(ValueError, match="CUDA"):  # fp32 takes any count, but only on the card
        WRAPPERS[kernel](torch.empty((1, 8, 8, 12), device="meta"), torch.empty((3, 3, 12, 16), device="meta"))
    assert WRAPPERS[kernel].launches == 0


def test_wrong_layout_raises():
    x = torch.zeros((1, 6, 7, 8))
    with pytest.raises(ValueError, match="HWIO"):
        pc.conv3x3_same(x, torch.zeros((16, 8, 3, 3)))  # OIHW weight
    with pytest.raises(ValueError, match="HWIO"):
        pc.conv3x3_same(x.permute(0, 3, 1, 2), torch.zeros((3, 3, 8, 16)))  # NCHW input
    with pytest.raises(ValueError, match="bias"):
        pc.conv3x3_same_db(x, torch.zeros((3, 3, 8, 16)), torch.zeros(8))
    with pytest.raises(ValueError, match="bf16 or both fp32"):
        pc.conv3x3_same(x, torch.zeros((3, 3, 8, 16), dtype=torch.float64))


# ---- on the card ---------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CUDA_SHAPES = [  # ragged H and W throughout; channels 8 to 512
    ((2, 37, 53, 8), 16),
    ((1, 30, 41, 64), 128),
    ((2, 19, 27, 256), 64),
    ((1, 9, 13, 512), 512),
    ((3, 5, 130, 136), 200),  # ragged M and N tiles at once
    # the bf16 kernels' tile edges: a tile is 64 columns, 2 or 4 rows, 128
    # output channels, and a chunk 64 input channels; W = H = 1 leaves only
    # the centre tap inside the image
    ((3, 1, 1, 8), 8),
    ((3, 3, 63, 72), 136),
    ((3, 5, 64, 136), 264),
    ((3, 1, 65, 512), 8),
    ((3, 3, 130, 8), 264),
    ((3, 5, 1, 72), 136),
    ((3, 1, 64, 136), 8),
    ((3, 3, 65, 512), 264),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
@pytest.mark.parametrize("dtype,shape,cout", [("bfloat16", *c) for c in CUDA_SHAPES]
                         + [("float32", *c) for c in CUDA_SHAPES]
                         + [("float32", (1, 17, 23, 13), 21)])  # odd channel counts: fp32 only
def test_cuda_kernel_matches_plain(kernel, dtype, shape, cout):
    """bf16: 2e-2 of the output scale (one rounding of the output plus the
    bias add); fp32: 1e-4 of it (sums in another order)."""
    dev = _cuda()
    x, w, b = _inputs(*shape, cout, True, seed=shape[3], w_scale=(9 * shape[3]) ** -0.5)
    xt, wt, bt = (torch.from_numpy(t).to(dev, getattr(torch, dtype)) for t in (x, w, b))
    wrapper = WRAPPERS[kernel]
    for bias in (bt, None):
        before = wrapper.launches
        got = wrapper(xt, wt, bias)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        plain = pc.conv3x3_reference(xt, wt, bias)
        err = (got.float() - plain.float()).abs().max().item()
        scale = plain.float().abs().max().item()
        assert err <= (2e-2 if dtype == "bfloat16" else 1e-4) * scale, (err, scale)


@pytest.mark.parametrize("shape", [(4, 432, 768, 128, 128), (4, 216, 384, 256, 256), (4, 108, 192, 512, 512)])
def test_bf16_tma_bytes_at_the_decoder_widths(shape):
    """The bytes each bf16 kernel loads through TMA are the same at the VAE
    decoder's three widths: K5's 256-pixel tiles read the weights half as
    often as K4's 128-pixel tiles."""
    assert pc.bf16_tma_bytes(pc.conv3x3_same_db, *shape) == 2_054_356_992
    assert pc.bf16_tma_bytes(pc.conv3x3_same, *shape) == 3_758_358_528


def test_bf16_tiles_cover_ragged_shapes():
    # 37 rows in 4-row tiles, 53 columns in one 64-column tile, 200 output
    # channels in two 128-channel tiles
    assert pc.bf16_tiles(pc.conv3x3_same_db, 2, 37, 53, 200) == 2 * 10 * 1 * 2
    assert pc.bf16_tiles(pc.conv3x3_same, 1, 5, 65, 136) == 3 * 2 * 2
