"""Clip round-robin across processes (``parallel/multihost.py``), executed.

- ``tools/multihost_demo.py``: 2 gloo worker processes over 5 clips, each
  output equal, bit for bit, to a single-process run of its clip; without a
  device it takes the card, and raises without one;
- ``python -m rollingdepth_torch.cli`` as 2 ranks over 3 clips with
  ``--device cpu``: each rank writes a disjoint set of clips, together every
  clip, and each output equals a single-process run's bit for bit (one CPU
  thread on both sides);
- the backend and device choice without ranks, and ``"cuda"`` without an
  index joining on the rank's own card;
- ``parallel/launch.py``: a rank that raises, or ranks that outlast their
  timeout, end every rank and raise in the caller.
Every spawn has its own timeout (``parallel/launch.py``).
"""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from rollingdepth_torch import cli as tcli
from rollingdepth_torch.parallel import multihost
from rollingdepth_torch.parallel.launch import run_ranks
from rollingdepth_torch.tools import multihost_demo
from tests.test_torch_cli import BASE_ARGV
from tests.test_torch_cli import checkpoint as checkpoint  # noqa: F401  (the module fixture)


def test_multihost_demo(tmp_path):
    result = multihost_demo.launcher(str(tmp_path / "mh"), device="cpu")
    assert result["ok"] and result["n_processes"] == 2
    assert sorted(sum(result["clips_per_worker"], [])) == list(range(multihost_demo.N_CLIPS))
    assert result["clips_per_worker"] == [[0, 2, 4], [1, 3]]
    assert len(result["numerics_check"]) == 5
    assert all(c["max_err_vs_single"] == 0.0 for c in result["numerics_check"])


def test_multihost_demo_without_a_device_needs_a_card(monkeypatch, tmp_path):
    """No ``device``: the card, as every entry point; without one it raises
    before it starts a worker."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        multihost_demo.launcher(str(tmp_path / "mh"))
    with pytest.raises(RuntimeError, match="none is available"):
        multihost_demo.main([str(tmp_path / "mh")])
    assert not (tmp_path / "mh").exists()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """3 clips of 8 frames of 32x48 in one directory, written by OpenCV."""
    import cv2

    d = tmp_path_factory.mktemp("clips")
    for c in range(3):
        writer = cv2.VideoWriter(str(d / f"clip{c}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 32))
        base = (np.random.RandomState(c).rand(32, 48, 3) * 255).astype(np.uint8)
        for i in range(8):
            writer.write(np.roll(base, i, axis=1))
        writer.release()
    return d


def test_cli_two_processes(checkpoint, clips, tmp_path):  # noqa: F811
    _cli_two_processes(checkpoint, clips, tmp_path, [])


def test_cli_two_processes_w8a8(checkpoint, clips, tmp_path):  # noqa: F811
    """``--quantize w8a8`` under the launcher, as under ``torchrun``: each
    rank's clips equal one process's, bit for bit."""
    _cli_two_processes(checkpoint, clips, tmp_path, ["--quantize", "w8a8"])


def _cli_two_processes(checkpoint, clips, tmp_path, extra):  # noqa: F811
    argv = (["-i", str(clips), "-c", checkpoint, "--cmap", "", "--save-sbs", "false"] + BASE_ARGV
            + ["--refine-step", "0"] + extra)
    ranks = run_ranks(R.cli_rank, 2, args=(argv, str(tmp_path)), device="cpu", threads=1, timeout=240)
    assert [r["world"] for r in ranks] == [2, 2]
    assert all(r["local_mesh"] == (("dp", "tp"), (1, 1)) for r in ranks)
    done = [sorted(p.name for p in (tmp_path / f"rank{r}").iterdir()) for r in range(2)]
    assert done == [["clip0_pred.npy", "clip2_pred.npy"], ["clip1_pred.npy"]]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tcli.main(argv + ["-o", str(tmp_path / "single")])
    finally:
        torch.set_num_threads(threads)
    single = tmp_path / "single"
    assert sorted(p.name for p in single.iterdir()) == [f"clip{c}_pred.npy" for c in range(3)]
    for r, names in enumerate(done):
        for name in names:
            got = np.load(tmp_path / f"rank{r}" / name)
            assert np.array_equal(got, np.load(single / name)), name


def test_backend_and_device_choice(monkeypatch):
    for var in multihost.ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert multihost.choose_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert multihost.choose_backend("cuda:0") == "nccl"  # a card a rank
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert multihost.choose_backend("cuda:0") == "gloo"  # ranks share cards: NCCL refuses that
    monkeypatch.setenv("LOCAL_RANK", "6")
    assert multihost.local_device() == torch.device("cuda:2")
    assert tcli.resolve_args(["-i", "x.mp4", "-o", "out"])[0].device == "cuda:2"


def test_bare_cuda_joins_on_this_ranks_card(monkeypatch):
    """``initialize_distributed(device="cuda")`` names no card: it sets this
    rank's own (``local_device``), as without a device, instead of passing
    an index-less device to ``torch.cuda.set_device``, which refuses it."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", torch.device(d))))
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group", lambda backend, **kw: calls.append(("init", backend)))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    for device in ("cuda", None):
        calls.clear()
        assert multihost.initialize_distributed(device=device) == "nccl"
        assert calls == [("set_device", torch.device("cuda:1")), ("init", "nccl")]


def test_failed_rank_ends_every_rank():
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="planted failure of rank 1"):
        run_ranks(R.failing_rank, 3, device="cpu", threads=1, timeout=120)


def test_ranks_past_their_timeout_are_ended():
    with pytest.raises(TimeoutError, match="still running after 5 s"):
        run_ranks(R.hanging_rank, 2, device="cpu", threads=1, timeout=5)
