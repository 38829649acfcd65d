"""The port's copies of framework-free modules give exactly what their
originals give, over a grid of inputs (the port may not import them)."""

import dataclasses
import itertools
import json
import os

import numpy as np
import pytest

import rollingdepth_torch.io.tokenizer as t_tok
import rollingdepth_torch.parallel.mesh as t_mesh
import rollingdepth_torch.pipelines.snippets as t_snip
import rollingdepth_torch.schedulers.common as t_common
import rollingdepth_torch.utils.presets as t_presets
import rollingdepth_tpu.io.tokenizer as j_tok
import rollingdepth_tpu.parallel.mesh as j_mesh
import rollingdepth_tpu.pipelines.snippets as j_snip
import rollingdepth_tpu.schedulers.common as j_common
import rollingdepth_tpu.utils.presets as j_presets


def _same(fn_a, fn_b, *args):
    try:
        a = fn_a(*args)
    except ValueError:
        with pytest.raises(ValueError):
            fn_b(*args)
        return
    b = fn_b(*args)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seq_len", [3, 5, 8, 13, 60, 61])
def test_snippets(seq_len):
    for n, d in itertools.product([2, 3, 4], [1, 2, 3, 6, 25]):
        _same(j_snip.cap_max_dilation, t_snip.cap_max_dilation, seq_len, n, d)
        if (n - 1) * d < seq_len:
            _same(j_snip.snippet_index_matrix, t_snip.snippet_index_matrix, seq_len, n, d)
            for stride, phase in itertools.product([1, 2, 3], [0, 1]):
                _same(j_snip.chain_stride_index_matrix, t_snip.chain_stride_index_matrix,
                      seq_len, n, d, stride, phase)
            for phase in [0, 1, 2]:
                _same(j_snip.partition_index_matrix, t_snip.partition_index_matrix, seq_len, n, d, phase)
    for i, total, a, b in itertools.product(range(4), [3, 10], [1, 6, 25], [1, 2]):
        _same(j_snip.current_gap, t_snip.current_gap, i, total, a, b)
    m = j_snip.snippet_index_matrix(seq_len, 2, 1)
    _same(j_snip.coverage_count, t_snip.coverage_count, m, seq_len)
    _same(j_snip.valid_window_mask, t_snip.valid_window_mask, 3, seq_len + 3)


@pytest.mark.parametrize("max_tp", [1, 2, 4, 8])
def test_best_mesh_shape(max_tp):
    for n in range(1, 65):
        assert t_mesh.best_mesh_shape(n, max_tp) == j_mesh.best_mesh_shape(n, max_tp), n


@pytest.mark.parametrize("schedule", ["linear", "scaled_linear", "squaredcos_cap_v2"])
def test_schedule_common(schedule):
    for zero_snr in (False, True):
        _same(j_common.make_alphas_cumprod, t_common.make_alphas_cumprod,
              1000, 0.00085, 0.012, schedule, zero_snr)
    for spacing, steps, offset in itertools.product(["leading", "trailing", "linspace"], [1, 4, 10, 50], [0, 1]):
        _same(j_common.spaced_timesteps, t_common.spaced_timesteps, 1000, steps, spacing, offset)


def _vocab_and_merges():
    vocab = {}
    for u in j_tok.bytes_to_unicode().values():
        vocab[u] = len(vocab)
    for u in j_tok.bytes_to_unicode().values():
        vocab[u + "</w>"] = len(vocab)
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("c", "a")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


@pytest.mark.parametrize("text", ["", "the cat and the hat", "  Hello,   WORLD!! 123 ",
                                  "naïve café", "it's don't they'll", "a" * 100])
def test_tokenizer(tmp_path, text):
    vocab, merges = _vocab_and_merges()
    d = tmp_path / "tokenizer"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    a = j_tok.CLIPTokenizer.from_pretrained(str(tmp_path))
    b = t_tok.CLIPTokenizer.from_pretrained(str(tmp_path))
    for padding in ("do_not_pad", "max_length"):
        assert a(text, padding=padding) == b(text, padding=padding)
    assert a.tokenize_ids(text) == b.tokenize_ids(text)


@pytest.mark.parametrize("preset", ["fast", "fast1024", "full", "paper", "none"])
def test_presets(preset):
    for overrides in ({}, {"res": 512, "dilations": [1, 10]}, {"seed": 3, "snippet_batch": 4}):
        a = j_presets.resolve_preset(preset, overrides)
        b = t_presets.resolve_preset(preset, overrides)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(KeyError):
        t_presets.resolve_preset(preset, {"no_such_flag": 1})
    for v in ("yes", "0", True, "F"):
        assert j_presets.str2bool(v) == t_presets.str2bool(v)


def test_fast_preset_call_kwargs():
    """The smoke and profiling scripts drive the pipeline with the CLI's
    fast preset, taken from the copied preset table."""
    from rollingdepth_torch.utils.synthetic import FAST_PRESET

    s = dataclasses.asdict(j_presets.resolve_preset("fast"))
    assert FAST_PRESET == {**{k: s[k] for k in FAST_PRESET if k != "seed"}, "seed": 0}
    assert FAST_PRESET["dilations"] == [1, 25] and FAST_PRESET["merge_in_latent"] is True


@pytest.mark.parametrize("preset", ["full", "paper"])
def test_refine_preset_call_kwargs(preset):
    """``FULL_PRESET`` and ``PAPER_PRESET`` carry the refine arguments and
    the turbo flags of the copied preset table."""
    from rollingdepth_torch.utils import synthetic

    got = {"full": synthetic.FULL_PRESET, "paper": synthetic.PAPER_PRESET}[preset]
    s = dataclasses.asdict(j_presets.resolve_preset(preset))
    assert got == {**{k: s[k] for k in got if k != "seed"}, "seed": 0}
    assert {"refine_snippet_len", "refine_start_dilation", "refine_in_latent", "turbo_refine"} <= set(got)
    assert got["refine_step"] == 10 and got["dilations"] == [1, 10, 25]
    assert got["merge_in_latent"] is (preset == "full") and got["cap_dilation"] is (preset == "full")


@pytest.mark.parametrize("cmap", ["Spectral_r", "Greys_r", "viridis"])
def test_colorize(cmap):
    import rollingdepth_torch.io.colorize as t_col
    import rollingdepth_tpu.io.colorize as j_col

    rng = np.random.default_rng(0)
    depth = rng.uniform(-1, 1, (5, 1, 12, 9)).astype(np.float32)
    mask = rng.random((12, 9)) > 0.3
    np.testing.assert_array_equal(t_col.colorize_depth(depth[0, 0], -0.5, 0.8, cmap, mask),
                                  j_col.colorize_depth(depth[0, 0], -0.5, 0.8, cmap, mask))
    np.testing.assert_array_equal(t_col.colorize_depth(depth[:, 0], -1, 1, cmap),
                                  j_col.colorize_depth(depth[:, 0], -1, 1, cmap))
    np.testing.assert_array_equal(t_col.colorize_depth_multi_thread(depth, chunk_size=2, color_map=cmap),
                                  j_col.colorize_depth_multi_thread(depth, chunk_size=2, color_map=cmap))


def test_eval_metrics(tmp_path):
    """The eval harness's alignment, metrics, CSV, manifests and GT decode."""
    import cv2

    import rollingdepth_torch.eval as t_eval
    import rollingdepth_tpu.eval as j_eval

    rng = np.random.default_rng(1)
    pred = rng.uniform(0, 1, (4, 10, 14)).astype(np.float32)
    gts = [rng.uniform(0.5, 5, (10, 14)).astype(np.float32) for _ in range(4)]
    gts[1][:3] = 0  # invalid pixels
    big = [rng.uniform(0.5, 5, (20, 28)).astype(np.float32) for _ in range(4)]  # the prediction is resized
    mask = gts[0] > 1
    assert t_eval.align_least_squares(pred[0], gts[0], mask) == j_eval.align_least_squares(pred[0], gts[0], mask)
    assert t_eval.depth_metrics(pred[0], gts[0], mask) == j_eval.depth_metrics(pred[0], gts[0], mask)
    for g, align in itertools.product((gts, big), (True, False)):
        assert (t_eval.evaluate_sequence(pred, g, align_per_sequence=align)
                == j_eval.evaluate_sequence(pred, g, align_per_sequence=align))
    rows = [("a", t_eval.evaluate_sequence(pred, gts)), ("b", t_eval.depth_metrics(pred[1], gts[1], gts[1] > 0))]
    t_eval.write_eval_csv(str(tmp_path / "t.csv"), rows)
    j_eval.write_eval_csv(str(tmp_path / "j.csv"), rows)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert t_eval.DATASET_DEPTH_SCALE == j_eval.DATASET_DEPTH_SCALE
    t_list = [os.path.realpath(p) for p in t_eval.list_manifests(t_eval.DEFAULT_SPLIT_DIR)]
    assert t_list == [os.path.realpath(p) for p in j_eval.list_manifests(j_eval.DEFAULT_SPLIT_DIR)] != []

    seq = tmp_path / "apartment" / "shot1"
    seq.mkdir(parents=True)
    cv2.imwrite(str(seq / "0.png"), (gts[0] * 1000).astype(np.uint16))
    np.save(seq / "1.npy", gts[1])
    cv2.imwrite(str(seq / "c.png"), (rng.random((10, 14, 3)) * 255).astype(np.uint8))
    (tmp_path / "apartment^shot1.csv").write_text("rgb,depth\nc.png,0.png\nc.png,1.npy\n")
    t_s = t_eval.load_manifest(str(tmp_path / "apartment^shot1.csv"), str(tmp_path))
    j_s = j_eval.load_manifest(str(tmp_path / "apartment^shot1.csv"), str(tmp_path))
    assert dataclasses.asdict(t_s) == dataclasses.asdict(j_s)
    for a, b in zip(t_eval.load_gt_depths(t_s, 1000.0), j_eval.load_gt_depths(j_s, 1000.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_eval.load_frames_from_manifest(t_s, 7),
                                  j_eval.load_frames_from_manifest(j_s, 7))


def test_video_helpers(tmp_path, monkeypatch):
    import rollingdepth_torch.io.native_video as t_native
    import rollingdepth_torch.io.video as t_vid
    import rollingdepth_tpu.io.native_video as j_native
    import rollingdepth_tpu.io.video as j_vid

    rng = np.random.default_rng(2)
    img = (rng.random((30, 50, 3)) * 255).astype(np.uint8)
    for res, method in itertools.product([0, 20, 50, 80], ["BILINEAR", "BICUBIC", "NEAREST_EXACT"]):
        if res:
            np.testing.assert_array_equal(t_vid.resize_max_res(img, res, method), j_vid.resize_max_res(img, res, method))
    v1 = (rng.random((3, 3, 16, 20)) * 255).astype(np.uint8)
    v2 = (rng.random((3, 3, 8, 10)) * 255).astype(np.uint8)
    for gap, color in ((0, None), (4, [255, 0, 7])):
        np.testing.assert_array_equal(t_vid.concatenate_videos_horizontally(v1, v2, gap, color),
                                      j_vid.concatenate_videos_horizontally(v1, v2, gap, color))
    (tmp_path / "b.mp4").write_bytes(b"")
    (tmp_path / "a.MOV").write_bytes(b"")
    (tmp_path / "c.txt").write_text("x.mp4\n\n y.avi \n")
    for p in (tmp_path, tmp_path / "c.txt", tmp_path / "b.mp4"):
        assert t_vid.enumerate_videos(p) == j_vid.enumerate_videos(p)
    frames = (rng.random((4, 16, 24, 3)) * 255).astype(np.uint8)
    t_vid.write_video_from_numpy(frames, tmp_path / "out.avi", fps=12, codec="MJPG")
    # each decoder against its own counterpart, never libavcodec against
    # OpenCV: the native decoder where both copies load it, OpenCV always
    if t_native.available() and j_native.available():
        got, _ = t_vid.load_video_frames(tmp_path / "out.avi", dtype="uint8")
        want, _ = j_vid.load_video_frames(tmp_path / "out.avi", dtype="uint8")
        assert got.shape == (4, 3, 16, 24)
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(t_native, "available", lambda: False)
    monkeypatch.setattr(j_native, "available", lambda: False)
    got, _ = t_vid.load_video_frames(tmp_path / "out.avi", dtype="uint8")
    want, _ = j_vid.load_video_frames(tmp_path / "out.avi", dtype="uint8")
    assert got.shape == (4, 3, 16, 24)
    np.testing.assert_array_equal(got, want)


def test_missing_libraries_are_named(monkeypatch, tmp_path):
    """Without OpenCV or matplotlib the copies raise an ImportError that
    names the missing module; nothing falls back silently."""
    import sys

    import rollingdepth_torch.eval as t_eval
    import rollingdepth_torch.io.colorize as t_col
    import rollingdepth_torch.io.native_video as t_native
    import rollingdepth_torch.io.video as t_vid

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(t_native, "available", lambda: False)
    with pytest.raises(ImportError, match="cv2"):
        t_vid.load_video_frames(tmp_path / "clip.mp4")
    with pytest.raises(ImportError, match="cv2"):
        t_vid.write_video_from_numpy(np.zeros((1, 4, 4, 3), np.uint8), tmp_path / "o.mp4")
    with pytest.raises(ImportError, match="cv2"):
        t_eval.evaluate_sequence(np.zeros((1, 4, 4), np.float32), [np.ones((8, 8), np.float32)])
    with pytest.raises(ImportError, match="matplotlib"):
        t_col.colorize_depth(np.zeros((4, 4)), 0, 1)
    # what needs neither still works
    assert t_vid.enumerate_videos(tmp_path / "x.mp4") == [str(tmp_path / "x.mp4")]


def test_native_video_binding(tmp_path):
    """The copied ctypes binding loads the same C++ library and decodes as
    the JAX package's does; the prefetching loader uploads torch tensors."""
    import torch

    import rollingdepth_torch.io.native_video as t_native
    import rollingdepth_torch.io.video as t_vid
    import rollingdepth_tpu.io.native_video as j_native

    assert t_native._LIB_PATH.replace("rollingdepth_torch", "rollingdepth_tpu") == j_native._LIB_PATH
    if not (t_native.available() and j_native.available()):
        pytest.skip("the native video library does not build here (no ffmpeg development libraries)")
    frames = (np.random.default_rng(3).random((5, 16, 24, 3)) * 255).astype(np.uint8)
    path = tmp_path / "clip.mp4"
    t_native.encode_video(frames, path, fps=10)
    for dtype in ("uint8", "float32"):
        got, got_res, got_fps = t_native.decode_video(path, 1, 3, 12, dtype=dtype)
        want, want_res, want_fps = j_native.decode_video(path, 1, 3, 12, dtype=dtype)
        np.testing.assert_array_equal(got, want)
        assert (got_res, got_fps) == (want_res, want_fps)
    assert t_native.probe_fps(path) == j_native.probe_fps(path) == t_vid.get_video_fps(path)
    loaded = list(t_native.PrefetchingFrameLoader([path, path], max_edge=12, device="cpu"))
    assert len(loaded) == 2 and torch.is_tensor(loaded[0][1]) and loaded[0][1].shape == (5, 8, 12, 3)
