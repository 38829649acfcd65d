"""The port's RMBG U²-Net and matting against the JAX module.

Random JAX parameters (with random BatchNorm statistics and affines, so
that eval-mode BatchNorm is not the identity) are carried across with
``state_dict_from_jax`` into the port's module, which keeps the reference
torch module's parameter names.

Tolerances: the six side outputs (sigmoids) within 1e-4 absolute, fp32 on
both sides.  Matting: alphas within 1e-5; the matted frames are floors of
values in 0..255, so an alpha that differs by rounding can move a pixel
across an integer: held equal except for at most 1 level on at most 1% of
the pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollingdepth_torch.io.weights import state_dict_from_jax
from rollingdepth_torch.models.rmbg import BriaRMBG, _upsample_like
from rollingdepth_torch.pipelines import rollingimg as tri
from rollingdepth_tpu.models.rmbg import BriaRMBG as JBriaRMBG
from rollingdepth_tpu.pipelines import rollingimg as jri

torch.set_num_threads(4)


def _randomize_bn(tree, rng):
    """Random eval-mode BatchNorm statistics and affine in every ``bn_s1``."""
    if isinstance(tree, dict):
        if "running_var" in tree:
            c = tree["running_var"].shape[0]
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "running_mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "running_var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def both():
    params = _randomize_bn(JBriaRMBG().init(jax.random.PRNGKey(0)), np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params)
    model = BriaRMBG(device="cpu").eval()
    missing, unexpected = model.load_state_dict(state_dict_from_jax(params), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return params, model


def test_parameter_names_are_the_reference_tree(both):
    params, _ = both
    names = set(BriaRMBG(device="cpu").state_dict())
    assert {"conv_in.weight", "stage1.rebnconvin.conv_s1.weight", "stage1.rebnconv7.bn_s1.running_var",
            "stage1.rebnconv1d.conv_s1.bias", "stage5.rebnconv4.conv_s1.weight", "stage5d.rebnconv3d.bn_s1.weight",
            "stage1d.rebnconv6d.conv_s1.weight", "side6.weight"} <= names
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    trained = sum(v.size for path, v in flat if path[-1].key not in ("running_mean", "running_var"))
    assert sum(p.numel() for p in BriaRMBG(device="cpu").parameters()) == trained == 44_046_790


@pytest.mark.parametrize("hw", [(64, 64), (50, 70)])
def test_side_outputs_match_jax(both, hw):
    """All six side outputs; (50, 70) takes ceil-mode pooling and
    upsampling to odd sizes."""
    params, model = both
    x = np.random.default_rng(1).random((2, 3) + hw, dtype=np.float32) * 2 - 1
    want = jax.jit(JBriaRMBG().apply)(params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (2, 1) + hw
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), rtol=0, atol=1e-4,
                                   err_msg=f"side output {i + 1}")


def test_upsample_only_enlarges():
    x = torch.zeros(1, 1, 4, 4)
    assert _upsample_like(x, (4, 4)) is x
    assert _upsample_like(x, (7, 8)).shape == (1, 1, 7, 8)
    with pytest.raises(AssertionError):
        _upsample_like(x, (3, 8))


def test_matting_matches_run_rmbg_sequence(both):
    """``run_rmbg_sequence`` (host feeds, then the device function
    ``rmbg_matte`` a chunk at a time) against JAX's, and ``run_rmbg`` on
    one frame against the sequence.  The feed is always ~1024^2 pixels
    (here 768x1344), so two frames, one a chunk."""
    params, model = both
    frames = np.random.default_rng(2).random((2, 3, 12, 20), dtype=np.float32)
    m_got, a_got = tri.run_rmbg_sequence(model, frames, sigma=3.0, chunk=1)
    m_want, a_want = jri.run_rmbg_sequence(JBriaRMBG(), params, frames, sigma=3.0, chunk=1)
    assert m_got.shape == m_want.shape == (2, 3, 12, 20) and a_got.shape == (2, 1, 12, 20)
    np.testing.assert_allclose(a_got, a_want, rtol=0, atol=1e-5)
    diff = np.abs(m_got - m_want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    assert np.array_equal(m_got, np.floor(m_got)) and 0 <= m_got.min() and m_got.max() <= 255

    img = (frames[0].transpose(1, 2, 0) * 255).astype(np.uint8)
    got_img, got_alpha = tri.run_rmbg(model, img, sigma=3.0)
    assert got_img.dtype == np.uint8 and got_alpha.shape == (12, 20, 1)
    np.testing.assert_array_equal(got_alpha[:, :, 0], a_got[0, 0])
    np.testing.assert_array_equal(got_img, m_got[0].transpose(1, 2, 0).astype(np.uint8))


def test_matte_feed_size():
    """~256^2 feed pixels in multiples of 64: 960x1088 for the 640x720 frames."""
    assert tri._feed_size(640, 720) == (960, 1088)
    assert tri._feed_size(12, 20) == (768, 1344)
