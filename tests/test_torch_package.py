"""Package rules of the port: no JAX anywhere in it, and the card by default."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "rollingdepth_tpu", "safetensors", "cv2", "matplotlib")
LAZY_ONLY = ("cv2", "matplotlib")  # absent on the card's machine: imported inside the functions that need them
# the rank bodies of test_torch_parallel.py run in spawned ranks, where JAX must not load either
PORT_FILES = sorted((ROOT / "rollingdepth_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                    ROOT / "tests" / "torch_parallel_ranks.py"]


def _imports(path):
    """(module, lineno, inside a function) for every import in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    func_lines = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func_lines.update(range(node.lineno, (node.end_lineno or node.lineno) + 1))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno, node.lineno in func_lines
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, node.lineno, node.lineno in func_lines


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """No jax, optax or rollingdepth_tpu, at any depth; the safetensors
    package is absent on the card, and cv2 and matplotlib may only be
    imported lazily."""
    for mod, line, in_function in _imports(path):
        root = mod.split(".")[0]
        if root in LAZY_ONLY and in_function:
            continue
        assert root not in FORBIDDEN, f"{path.name}:{line} imports {mod}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"flash_attention.py", "attention.py", "unet.py", "rollingdepth.py", "chip_smoke.py", "cli.py", "video.py",
            "native_video.py", "colorize.py", "eval.py", "training.py", "training_data.py", "mesh.py", "sharding.py",
            "multihost.py", "launch.py", "multihost_demo.py", "torch_parallel_ranks.py", "quant.py", "profiling.py",
            "bench_init.py", "bench_int8.py"} <= names


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")


@pytest.mark.parametrize("make", ["unet", "vae", "clip", "pipeline", "loader", "resolve"])
def test_entry_points_refuse_cpu_by_default(make, tmp_path):
    """Called without ``device=``, every entry point asks for the card and
    raises on a host without one, instead of running on the CPU."""
    _no_card()
    from rollingdepth_torch import resolve_device
    from rollingdepth_torch.io.pretrained import load_rollingdepth_pipeline
    from rollingdepth_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
    from rollingdepth_torch.pipelines.rollingdepth import RollingDepthPipeline
    from rollingdepth_torch.schedulers.ddim import DDIMScheduler

    calls = {
        "unet": lambda: UNet2DConditionModel(UNetConfig.tiny()),
        "vae": lambda: AutoencoderKL(VAEConfig.tiny()),
        "clip": lambda: CLIPTextModel(CLIPTextConfig.tiny()),
        "pipeline": lambda: RollingDepthPipeline(
            UNet2DConditionModel(UNetConfig.tiny(), device="cpu"), AutoencoderKL(VAEConfig.tiny(), device="cpu"),
            DDIMScheduler(), torch.zeros(1, 2, 8)),
        "loader": lambda: load_rollingdepth_pipeline(str(tmp_path)),
        "resolve": lambda: resolve_device(None),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[make]()


def test_explicit_cpu_is_accepted():
    from rollingdepth_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")


H100 = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.mark.parametrize("smi, want", [
    (None, "cpu"),  # no nvidia-smi on the path
    ("exit 9", "cpu"),  # it fails: no card to read
    (f"echo '{H100}'", H100),
    (f"for i in 0 1 2 3; do echo '{H100}'; done", "\n".join([H100] * 4)),  # a line a card
])
def test_card_name(smi, want, tmp_path, monkeypatch):
    """``card_name`` prints what ``nvidia-smi`` reads for the query it is
    given, or "cpu" where it reads nothing."""
    from rollingdepth_torch.utils.device import card_name

    if smi is not None:
        script = tmp_path / "nvidia-smi"
        script.write_text('#!/bin/sh\n[ "$*" = "--query-gpu=name,power.limit --format=csv,noheader" ] || exit 2\n'
                          + smi + "\n")
        script.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert card_name() == want


@pytest.mark.parametrize("tool, argv", [("profile_fast_path", ["--preset", "full"]),
                                        ("chunk_times", ["--preset", "paper"]),
                                        ("fp32_attention_parts", []),
                                        ("bench_int8", [])])
def test_card_tools_refuse_without_a_card(tool, argv, capsys):
    """The timing tools run on the card only: here they exit 2 and say why."""
    import importlib

    _no_card()
    assert importlib.import_module(f"rollingdepth_torch.tools.{tool}").main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err
