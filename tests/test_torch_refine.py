"""The refine and exact-merge paths of the port's pipeline against the JAX
pipeline (``RollingDepthPipeline.forward``/``__call__``) on the CPU.

The fixture of ``test_torch_pipeline.py``: tiny UNet, VAE and text
embedding with the same weights on both sides (``state_dict_from_jax``),
the same ``init_noise``, fp32, 10 frames of 32x32, dilations [1, 3].

Tolerances: with every co-alignment solve cut to one iteration the two
agree to 2e-4 absolute on the [-1, 1] depth: fp32 sum order through the
UNet, the VAE and refinement's scatter-averages, plus the JAX side's uint16
output quantisation (3e-5).  After the full 2000-iteration solve the L1
solve's sign gradients turn sum-order differences into Adam steps of lr
(``test_torch_aligner.py``), so that case is held to 5e-2 absolute and a
correlation above 0.999, as ``test_torch_pipeline.py`` holds the fast path.
``restore_res`` is held to ``cv2.resize(..., INTER_LINEAR)`` within 1e-5:
the same half-pixel bilinear rule in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollingdepth_tpu.models.unet import UNet2DCondition
from rollingdepth_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from rollingdepth_tpu.models.vae import VAEConfig as JVAEConfig
from rollingdepth_tpu.pipelines.rollingdepth import RollingDepthPipeline as JRollingDepthPipeline
from rollingdepth_tpu.schedulers.ddim import DDIMConfig as JDDIMConfig
from rollingdepth_tpu.schedulers.ddim import DDIMScheduler as JDDIMScheduler
from tests.test_torch_pipeline import SCHED, _inputs, _jax_parts, _torch_pipe

torch.set_num_threads(2)
ONE_ITER = dict(coalign_kwargs={"num_iterations": 1}, latent_coalign_kwargs={"num_iterations": 1})
TOL_ONE_ITER = 2e-4
EXACT = dict(dilations=[1, 3], merge_in_latent=False)
LATENT = dict(dilations=[1, 3], merge_in_latent=True)


@pytest.fixture(scope="module")
def both():
    torch.set_num_threads(2)  # the sum order of the cases below, whatever other modules set
    ucfg, unet_params, vae_params = _jax_parts()
    text = np.random.default_rng(5).standard_normal((1, 2, 8)).astype(np.float32)
    jpipe = JRollingDepthPipeline(UNet2DCondition(ucfg), unet_params, JAutoencoderKL(JVAEConfig.tiny()),
                                  vae_params, JDDIMScheduler(JDDIMConfig(**SCHED)), jnp.asarray(text),
                                  dtype=jnp.float32, snippet_batch=4)
    return jpipe, _torch_pipe(unet_params, vae_params, text)


CASES = {  # name: (input seed, call arguments)
    "exact_refine0": (0, dict(EXACT, refine_step=0)),
    "exact_refine2": (0, dict(EXACT, refine_step=2)),
    "latent_refine2_turbo": (0, dict(LATENT, refine_step=2, turbo_refine=True)),
    "latent_refine2_stride1": (0, dict(LATENT, refine_step=2, turbo_refine=False)),
    "latent_refine2_in_latent": (0, dict(LATENT, refine_step=2, refine_in_latent=True)),
    # 10 frames, refine dilation 4 uncapped: the first step's windows
    # (0, 4, 8) and (1, 5, 9) leave frames 2, 3, 6 and 7 uncovered.  Input
    # seed 3: the uncapped dilation-3 solves meet a window whose L1 gradient
    # is a near tie on seed 0's frames (depth-space merge) and on seed 1's
    # with one CPU thread (latent merge), so the one Adam step (lr 1e-3)
    # takes opposite signs on the two sides and the depth parts by 7.8e-4
    # and 4.4e-3 (both agree to 1.7e-5 at 0 iterations)
    "uncapped_uncovered_frames": (3, dict(EXACT, refine_step=2, cap_dilation=False, refine_start_dilation=4)),
    "uncapped_turbo": (3, dict(LATENT, refine_step=2, cap_dilation=False, refine_start_dilation=4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_at_one_iteration(both, case):
    jpipe, tpipe = both
    seed, case_kw = CASES[case]
    frames, noise = _inputs(seed)
    kw = dict(case_kw, init_noise=noise, **ONE_ITER)
    ref = jpipe.forward(frames, **kw)
    got = tpipe.forward(frames, **kw)
    assert got.depth_pred.shape == ref.depth_pred.shape == (10, 1, 32, 32)
    assert np.isfinite(got.depth_pred).all() and got.depth_pred.min() >= -1 and got.depth_pred.max() <= 1
    np.testing.assert_allclose(got.depth_pred, ref.depth_pred, rtol=0, atol=TOL_ONE_ITER)
    np.testing.assert_allclose(got.depth_coaligned, ref.depth_coaligned, rtol=0, atol=TOL_ONE_ITER)
    if kw.get("refine_step"):
        assert set(tpipe.last_timings) >= {"encode", "snippet_infer", "coalign", "refine"}


def test_latent_direct_device_output_skips_merged_decode(both):
    """Refinement that reads the merged latent, with the output kept on the
    device: neither side decodes the merged latent, both return
    ``depth_coaligned=None``, and ``depth_pred`` is that of the same call
    with ``fetch_output=True``."""
    jpipe, tpipe = both
    frames, noise = _inputs(0)
    kw = dict(LATENT, refine_step=2, refine_in_latent=True, init_noise=noise, **ONE_ITER)
    ref = jpipe.forward(frames, fetch_output=False, **kw)
    got = tpipe.forward(frames, fetch_output=False, **kw)
    assert ref.depth_coaligned is None and got.depth_coaligned is None
    assert "decode" not in tpipe.last_timings
    assert tpipe.last_chunks["decode"] == -(-10 // 4)  # the refine decode of 10 frames, 4 at a time
    got_pred = got.depth_pred.cpu().numpy()
    fetched = tpipe.forward(frames, fetch_output=True, **kw)
    assert tpipe.last_chunks["decode"] == 2 * -(-10 // 4) and fetched.depth_coaligned is not None
    np.testing.assert_array_equal(got_pred, fetched.depth_pred)
    np.testing.assert_allclose(got_pred, np.asarray(ref.depth_pred), rtol=0, atol=TOL_ONE_ITER)


def test_full_solve_matches_jax(both):
    """Exact merge and stride-1 refinement after the 2000-iteration solve."""
    jpipe, tpipe = both
    frames, noise = _inputs(seed=3)
    kw = dict(EXACT, refine_step=2, init_noise=noise)
    ref = jpipe.forward(frames, **kw).depth_pred
    got = tpipe.forward(frames, **kw).depth_pred
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("unload", [False, True])
def test_snippet_ls(both, unload):
    """The exact merge returns every window's decoded depth per dilation at
    its true window count: numpy arrays with ``unload_snippet``, device
    tensors without.  The latent merge returns none."""
    jpipe, tpipe = both
    frames, noise = _inputs()
    kw = dict(EXACT, init_noise=noise, unload_snippet=unload, **ONE_ITER)
    ref = jpipe.forward(frames, **kw).snippet_ls
    got = tpipe.forward(frames, **kw).snippet_ls
    assert [tuple(g.shape) for g in got] == [(8, 3, 1, 32, 32), (6, 3, 1, 32, 32)]  # d=3 capped to 2
    assert all(isinstance(g, np.ndarray) == unload and torch.is_tensor(g) != unload for g in got)
    for g, r in zip(got, ref):
        g = g if unload else g.numpy()
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-5)
    assert tpipe.forward(frames, **dict(kw, merge_in_latent=True)).snippet_ls == []


def test_chunk_counts(both):
    """Every VAE encode and decode and every UNet call is counted, the last
    chunk of each loop at its true size."""
    _, tpipe = both
    frames, noise = _inputs(n=9)
    tpipe.forward(frames, **EXACT, refine_step=2, init_noise=noise, **ONE_ITER)
    # 9 frames: windows 7 (d=1) + 5 (d=3 capped to 2) -> 3 UNet chunks of 4
    # and 36 decoded window frames; refinement from the capped dilation 3,
    # then 2 (stride-1: 5 + 7 windows)
    assert tpipe.last_chunks == {"encode": 3 + 3, "unet": 3, "decode": 9 + 3, "refine_unet": 2 + 2}
    tpipe.forward(frames, **LATENT, refine_step=2, init_noise=noise, **ONE_ITER)
    # partition windows: 3 then 3 + 1 head window
    assert tpipe.last_chunks == {"encode": 3 + 3, "unet": 3, "decode": 3 + 3, "refine_unet": 1 + 1}


@pytest.mark.parametrize("original_res", [(32, 32), (45, 61), (20, 17)])
def test_restore_res(both, original_res):
    """``__call__`` with ``restore_res``: the port resizes on the device;
    held to cv2's INTER_LINEAR on the same depth and to the JAX ``__call__``."""
    import cv2

    jpipe, tpipe = both
    frames, noise = _inputs()
    tpipe_kw = dict(LATENT, latent_coalign_kwargs={"num_iterations": 1})
    base = tpipe(input_frames=frames, **tpipe_kw).depth_pred
    got = tpipe(input_frames=frames, original_res=original_res, restore_res=True, **tpipe_kw).depth_pred
    h, w = original_res
    want = np.stack([cv2.resize(d[0], (w, h), interpolation=cv2.INTER_LINEAR)[None] for d in base])
    assert got.shape == (10, 1, h, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    ref = jpipe(input_frames=frames, original_res=original_res, restore_res=True, **tpipe_kw).depth_pred
    assert ref.shape == got.shape
    # the JAX call draws its own noise: same shape and range, not the same values
    assert np.isfinite(ref).all()


def test_call_reads_video(both, tmp_path, monkeypatch):
    """``__call__(input_video_path=...)`` decodes the clip as the JAX call
    does: with OpenCV on both sides, and with the native decoder where both
    copies load it (never one decoder against the other)."""
    import cv2

    import rollingdepth_torch.io.native_video as t_native
    import rollingdepth_tpu.io.native_video as j_native

    jpipe, tpipe = both
    frames, _ = _inputs()
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 32))
    for f in frames:
        writer.write(np.ascontiguousarray(f.transpose(1, 2, 0)[:, :, ::-1]))
    writer.release()
    kw = dict(LATENT, latent_coalign_kwargs={"num_iterations": 1}, processing_res=32, seed=0)
    decoders = ["native", "opencv"] if t_native.available() and j_native.available() else ["opencv"]
    for decoder in decoders:
        if decoder == "opencv":
            monkeypatch.setattr(t_native, "available", lambda: False)
            monkeypatch.setattr(j_native, "available", lambda: False)
        got = tpipe(path, **kw)
        ref = jpipe(path, **kw)
        np.testing.assert_array_equal(got.input_frames, ref._input_frames)
        np.testing.assert_allclose(got.input_rgb, ref.input_rgb)
        assert got.depth_pred.shape == (10, 1, 32, 32)
