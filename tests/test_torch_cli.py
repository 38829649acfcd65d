"""The port's command line (``python -m rollingdepth_torch.cli``) against the
JAX package's: the same settings from the same flags, the same decoded
frames, and the output suite of an end-to-end ``--device cpu`` run on a
tiny checkpoint written by the port's own safetensors writer."""

import csv
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from rollingdepth_torch import cli as tcli
from rollingdepth_torch.io import video as tvideo
from rollingdepth_torch.io.pretrained import load_pipeline
from rollingdepth_torch.models.clip_text import CLIPTextConfig
from rollingdepth_tpu import cli as jcli
from rollingdepth_tpu.io import video as jvideo
from rollingdepth_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
from rollingdepth_tpu.models.clip_text import CLIPTextModel as JCLIPTextModel
from tests.test_torch_pipeline import _jax_parts, _write_checkpoint

torch.set_num_threads(2)

OVERRIDE_SETS = [
    [],
    ["--res", "512", "-d", "1", "10"],
    ["--dtype", "fp32", "--refine-step", "2", "--merge-in-latent", "false", "--turbo-refine", "true",
     "--refine-in-latent", "true", "--refine-snippet-len", "4", "--refine-start-dilation", "3"],
    ["--max-vae-bs", "2", "--snippet-batch", "3", "--seed", "4", "--cap-dilation", "false", "--strides", "2",
     "--restore-res", "true", "--frames", "5", "--from", "1", "--snip-len", "4", "--init-infer-steps", "2"],
]


@pytest.mark.parametrize("preset", ["fast", "fast1024", "full", "paper", "none"])
def test_resolve_args_matches_jax(preset):
    """Every preset under every override set resolves to the JAX CLI's
    settings (on a host without a TPU, where the JAX CLI keeps the
    presets' batch defaults, as the port always does)."""
    assert jax.default_backend() != "tpu"
    for extra in OVERRIDE_SETS:
        argv = ["-i", "x.mp4", "-o", "out", "-p", preset] + extra
        j_args, j_set = jcli.resolve_args(argv)
        t_args, t_set = tcli.resolve_args(argv)
        assert dataclasses.asdict(t_set) == dataclasses.asdict(j_set)
        assert {k: v for k, v in vars(t_args).items() if k != "device"} == vars(j_args)
        assert t_args.device == "cuda"


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """8 frames of 32x48 in an mp4 written by OpenCV."""
    import cv2

    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 32))
    base = (np.random.RandomState(0).rand(32, 48, 3) * 255).astype(np.uint8)
    for i in range(8):
        writer.write(np.roll(base, i * 2, axis=1))
    writer.release()
    return path


@pytest.mark.parametrize("dtype, res, start, count", [("uint8", 0, 0, 0), ("float32", 0, 2, 3),
                                                      ("uint8", 24, 1, 0), ("float32", 64, 0, 5)])
def test_load_video_frames_matches_jax(clip, dtype, res, start, count, monkeypatch):
    """Each decoder against its own counterpart: the native one where both
    copies load it, OpenCV always; never one against the other."""
    from rollingdepth_torch.io import native_video as tnative
    from rollingdepth_tpu.io import native_video as jnative

    kw = dict(start_frame=start, frame_count=count, processing_res=res, dtype=dtype)
    for decoder in (["native"] if tnative.available() and jnative.available() else []) + ["opencv"]:
        if decoder == "opencv":
            monkeypatch.setattr(tnative, "available", lambda: False)
            monkeypatch.setattr(jnative, "available", lambda: False)
        got, got_res = tvideo.load_video_frames(clip, **kw)
        want, want_res = jvideo.load_video_frames(clip, **kw)
        assert got.dtype == want.dtype and got_res == want_res == (32, 48)
        np.testing.assert_array_equal(got, want)
        assert tvideo.get_video_fps(clip) == jvideo.get_video_fps(clip)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny diffusers-layout checkpoint written by the port's safetensors
    writer (the recipe of ``test_torch_pipeline.py``)."""
    root = tmp_path_factory.mktemp("ckpt")
    _, unet_params, vae_params = _jax_parts(cross_dim=16)
    jclip_cfg = dataclasses.replace(JCLIPTextConfig.tiny(), vocab_size=512)
    clip_params = JCLIPTextModel(jclip_cfg).init(jax.random.PRNGKey(2))
    _write_checkpoint(root, unet_params, vae_params, clip_params,
                      dataclasses.replace(CLIPTextConfig.tiny(), vocab_size=512))
    return str(root)


BASE_ARGV = ["--device", "cpu", "-p", "none", "--res", "48", "--dilations", "1", "3", "--refine-step", "1",
             "--dtype", "fp32", "--seed", "0"]


@pytest.mark.parametrize("save_snippets", [False, True])
def test_cli_end_to_end_matches_call(checkpoint, clip, tmp_path, save_snippets):
    """The output suite on the CPU; ``_pred.npy`` equals the pipeline's
    ``__call__`` with the settings the CLI resolves.  ``--save-snippets``
    writes the decoded windows, which takes the depth-space merge."""
    out = tmp_path / "out"
    extra = ["--save-snippets", "true", "--merge-in-latent", "true"] if save_snippets else []
    tcli.main(["-i", clip, "-o", str(out), "-c", checkpoint] + BASE_ARGV + extra)
    files = {p.name for p in out.iterdir()}
    want = {"clip_pred.npy", "clip_Spectral_r.mp4", "clip_Greys_r.mp4", "clip_rgbd.mp4"}
    assert files == (want | {"clip_snippets.npz"} if save_snippets else want)
    assert all((out / f).stat().st_size > 0 for f in files)
    pred = np.load(out / "clip_pred.npy")
    assert pred.shape == (8, 32, 48) and pred.dtype == np.float32

    pipe = load_pipeline(checkpoint, dtype="fp32", device="cpu")
    ref = pipe(input_video_path=clip, processing_res=48, dilations=[1, 3], refine_step=1, seed=0,
               merge_in_latent=False)
    np.testing.assert_array_equal(pred, ref.depth_pred[:, 0])
    if save_snippets:
        snippets = np.load(out / "clip_snippets.npz")
        assert sorted(snippets) == ["dilation0", "dilation1"]
        assert snippets["dilation0"].shape == (6, 3, 32, 48)  # 8 frames, windows of 3 at dilation 1
        np.testing.assert_array_equal(snippets["dilation0"], ref.snippet_ls[0].numpy()[:, :, 0])


def test_cli_eval_end_to_end(checkpoint, tmp_path, capsys):
    """``--eval`` over a synthetic split (CSV manifests, PNG frames, uint16
    GT in mm): one metric row per sequence plus a MEAN row, and the means
    printed as JSON."""
    import cv2

    split, data_root = tmp_path / "split", tmp_path / "frames"
    split.mkdir()
    rng = np.random.RandomState(0)
    for seq in ("seq_a", "seq_b"):
        (data_root / seq / "color").mkdir(parents=True)
        (data_root / seq / "depth").mkdir()
        base = (rng.rand(32, 48, 3) * 255).astype(np.uint8)
        rows = []
        for i in range(6):
            cv2.imwrite(str(data_root / seq / "color" / f"{i}.png"), np.roll(base, i, axis=1))
            gt_mm = ((np.linspace(1.0, 3.0, 32)[:, None] * np.ones((1, 48))) * 1000 + i * 10).astype(np.uint16)
            cv2.imwrite(str(data_root / seq / "depth" / f"{i}.png"), gt_mm)
            rows.append(f"color/{i}.png,depth/{i}.png")
        (split / f"{seq}.csv").write_text("rgb,depth\n" + "\n".join(rows) + "\n")

    out = tmp_path / "out"
    tcli.main(["--eval", str(split), "--eval-data-root", str(data_root), "-o", str(out), "-c", checkpoint,
               "--device", "cpu", "-p", "none", "--res", "48", "--dilations", "1", "2", "--dtype", "fp32",
               "--seed", "0"])
    with open(out / "eval_split.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["sequence", "abs_rel", "delta1", "delta2", "delta3", "rmse"]
    assert [r[0] for r in rows[1:]] == ["seq_a", "seq_b", "MEAN"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["dataset"] == "split" and 0.0 <= summary["delta1"] <= 1.0


@pytest.mark.parametrize("argv, error", [
    (["-i", "clip.mp4", "--quantize", "int4", "--device", "cpu"], SystemExit),
])
def test_unported_modes_raise(checkpoint, tmp_path, argv, error):
    """Every mode of the JAX CLI is ported (``--quantize w8a8`` runs:
    ``test_cli_w8a8_end_to_end``); a quantization the JAX CLI does not
    know is refused at parsing, as there."""
    with pytest.raises(error):
        tcli.main(argv + ["-o", str(tmp_path / "out"), "-c", checkpoint])
    with pytest.raises(SystemExit):
        jcli.build_parser().parse_args(argv + ["-o", str(tmp_path / "out")])


def test_cli_w8a8_end_to_end(checkpoint, clip, tmp_path):
    """``--quantize w8a8`` on the CPU: the output suite, and ``_pred.npy``
    equal to the W8A8 pipeline's ``__call__``; not the float pipeline's."""
    out = tmp_path / "out"
    tcli.main(["-i", clip, "-o", str(out), "-c", checkpoint, "--quantize", "w8a8"] + BASE_ARGV)
    assert {p.name for p in out.iterdir()} == {"clip_pred.npy", "clip_Spectral_r.mp4", "clip_Greys_r.mp4",
                                               "clip_rgbd.mp4"}
    pred = np.load(out / "clip_pred.npy")
    kw = dict(input_video_path=clip, processing_res=48, dilations=[1, 3], refine_step=1, seed=0,
              merge_in_latent=False)
    pipe = load_pipeline(checkpoint, dtype="fp32", quantize="w8a8", device="cpu")
    assert pipe.unet.down_blocks[0].resnets[0].conv1.weight_q.dtype == torch.int8
    np.testing.assert_array_equal(pred, pipe(**kw).depth_pred[:, 0])
    fp = load_pipeline(checkpoint, dtype="fp32", device="cpu")(**kw).depth_pred[:, 0]
    assert not np.array_equal(pred, fp) and np.corrcoef(pred.ravel(), fp.ravel())[0, 1] > 0.95


def test_missing_input_exits_1(tmp_path):
    with pytest.raises(SystemExit) as e:
        tcli.main(["-o", str(tmp_path / "out")])
    assert e.value.code not in (0, None)  # a message exit: status 1


def test_missing_video_raises(checkpoint, tmp_path):
    with pytest.raises(RuntimeError, match="Cannot open video"):
        tcli.main(["-i", str(tmp_path / "no_such.mp4"), "-o", str(tmp_path / "out"), "-c", checkpoint]
                  + BASE_ARGV)


def test_default_device_is_the_card(checkpoint, clip, tmp_path):
    """Without ``--device`` the CLI asks for the card, and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["-i", clip, "-o", str(tmp_path / "out"), "-c", checkpoint, "-p", "none"])


def test_module_entry_point_exits_1_without_input(tmp_path):
    """``python -m rollingdepth_torch.cli`` with no input exits with status 1."""
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-m", "rollingdepth_torch.cli", "-o", str(tmp_path / "out")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "Provide -i" in r.stderr


@pytest.mark.parametrize("backend", ["flash", "xla"])
def test_attn_backend_sets_the_dispatch(monkeypatch, tmp_path, backend):
    """``--attn-backend`` routes every attention call through ``ROLLINGDEPTH_ATTN``."""
    import os

    monkeypatch.setenv("ROLLINGDEPTH_ATTN", "auto")  # restored (unset) after the test
    with pytest.raises(SystemExit):
        tcli.main(["-o", str(tmp_path / "out"), "--attn-backend", backend])
    assert os.environ["ROLLINGDEPTH_ATTN"] == backend
