"""``rollingdepth_torch/utils/profiling.py`` against ``rollingdepth_tpu/utils/profiling.py``,
and the traces the pipelines write under ``ROLLINGDEPTH_TRACE_DIR``, on the CPU."""

import json

import numpy as np
import pytest
import torch

from rollingdepth_torch.utils import profiling as tprof
from rollingdepth_tpu.utils import profiling as jprof
from tests.test_torch_pipeline import _inputs, _jax_parts, _torch_pipe

torch.set_num_threads(2)


def test_summary_and_accumulation_match_jax(monkeypatch):
    """The same phases give the same ``timings`` keys and the same summary
    format; a phase that runs twice adds up, as in JAX."""
    monkeypatch.delenv(tprof.TRACE_ENV, raising=False)
    assert tprof.TRACE_ENV == jprof.TRACE_ENV
    t, j = tprof.PhaseTimer(), jprof.PhaseTimer()
    for timer in (t, j):
        for name in ("encode", "unet", "encode"):
            with timer.phase(name):
                pass
    assert list(t.timings) == list(j.timings) == ["encode", "unet"]
    t.timings, j.timings = {"a": 1.25, "b": 0.5}, {"a": 1.25, "b": 0.5}
    assert t.summary() == j.summary() == "total=1.75s (a=1.25s, b=0.50s)"


def test_trace_dir_gets_one_trace_per_phase(monkeypatch, tmp_path):
    """A depth call under ``ROLLINGDEPTH_TRACE_DIR`` writes one Chrome trace
    per phase, each holding its phase's range; a second call numbers its own."""
    monkeypatch.setenv(tprof.TRACE_ENV, str(tmp_path / "traces"))
    _, unet_params, vae_params = _jax_parts()
    text = np.random.default_rng(5).standard_normal((1, 2, 8)).astype(np.float32)
    pipe = _torch_pipe(unet_params, vae_params, text)
    frames, noise = _inputs(n=6)
    pipe.forward(frames, dilations=[1, 3], merge_in_latent=True, init_noise=noise,
                 latent_coalign_kwargs={"num_iterations": 1})
    phases = ["encode", "snippet_infer", "coalign", "decode"]
    assert list(pipe.last_timings) == phases
    assert sorted(p.name for p in (tmp_path / "traces").iterdir()) == sorted(f"{p}.json" for p in phases)
    for phase in phases:
        with open(tmp_path / "traces" / f"{phase}.json") as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        assert f"rollingdepth.{phase}" in names, phase
    pipe.forward(frames, dilations=[1, 3], merge_in_latent=True, init_noise=noise,
                 latent_coalign_kwargs={"num_iterations": 1})
    assert len(list((tmp_path / "traces").iterdir())) == 2 * len(phases)
    assert (tmp_path / "traces" / "encode.1.json").exists()


def test_no_trace_without_the_variable(monkeypatch, tmp_path):
    monkeypatch.delenv(tprof.TRACE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    timer = tprof.PhaseTimer(verbose=True)
    with timer.phase("x"):
        pass
    assert list(tmp_path.iterdir()) == [] and timer.timings["x"] >= 0


def test_annotate_is_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.annotate("rollingdepth.test_range"):
            torch.ones(3).sum()
    assert "rollingdepth.test_range" in {e.key for e in prof.key_averages()}


def test_a_failing_phase_still_writes_its_trace(monkeypatch, tmp_path):
    monkeypatch.setenv(tprof.TRACE_ENV, str(tmp_path))
    timer = tprof.PhaseTimer()
    with pytest.raises(ValueError):
        with timer.phase("broken"):
            raise ValueError("in the phase")
    assert (tmp_path / "broken.json").exists()


def test_device_shares_counts_kernel_time_inside_each_span():
    """Spans and kernels as ``torch.profiler`` gives them: a phase's busy
    time is the union of the kernels inside it (overlaps once), clipped to
    the span; a CPU range's device copy is not a kernel."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from rollingdepth_torch.tools.profile_fast_path import device_shares

    def event(name, lo, hi, device=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=lo, end=hi))

    events = [event("rollingdepth.encode", 0, 100, DeviceType.CPU),
              event("rollingdepth.coalign", 100, 1100, DeviceType.CPU),
              event("rollingdepth.coalign", 100, 1100),  # the span's device copy
              event("k1", 10, 60), event("k2", 40, 90), event("k3", 90, 120),
              event("k4", 200, 250), event("k4", 600, 700)]
    phases, call, kernels = device_shares(events)
    assert len(kernels) == 5
    assert phases["encode"] == {"host_ms": 0.1, "device_busy_ms": 0.09, "idle_share": pytest.approx(0.1)}
    assert phases["coalign"]["device_busy_ms"] == pytest.approx(0.17)
    assert phases["coalign"]["idle_share"] == pytest.approx(0.83)
    assert call["host_ms"] == 1.1 and call["device_busy_ms"] == pytest.approx(0.26)
    assert device_shares(events[3:])[1] is None


def _spans(prof, prefixes=("rd.", "rollingdepth.", "rollingimg.")):
    """The profiler's ranges named under ``prefixes``: (name, start, end), by start."""
    from torch.autograd import DeviceType

    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU and e.name().startswith(prefixes)), key=lambda s: s[1])


def _inside(spans, outer, prefix):
    """The spans named under ``prefix`` that lie within span ``outer``, by start."""
    return [s for s in spans if s[0].startswith(prefix) and outer[1] <= s[1] and s[2] <= outer[2]]


def _check_solves(spans, n):
    solves = [s for s in spans if s[0] == "rd.solve"]
    assert len(solves) == n
    for solve in solves:
        stages = [s[0] for s in _inside(spans, solve, "rd.solve.")]
        assert stages == ["rd.solve.prepare", "rd.solve.load", "rd.solve.replay", "rd.solve.merge"]


@pytest.fixture(scope="module")
def depth_pipe():
    _, unet_params, vae_params = _jax_parts()
    text = np.random.default_rng(5).standard_normal((1, 2, 8)).astype(np.float32)
    return _torch_pipe(unet_params, vae_params, text)


DEPTH_CALL = dict(dilations=[1, 3], merge_in_latent=True, refine_step=2, refine_start_dilation=3, max_vae_bs=4,
                  latent_coalign_kwargs={"num_iterations": 2})


def test_depth_call_spans_each_layer(depth_pipe, monkeypatch):
    """Under a profiler a depth call (with refinement) is one ``rd.clip``
    holding its phases, one ``rd.unet`` per UNet chunk of the snippets and of
    refinement, one ``rd.vae.*`` per VAE chunk, and the solve's stages in
    order; on the CPU nothing is captured and no phase syncs a card."""
    monkeypatch.delenv(tprof.TRACE_ENV, raising=False)
    frames, noise = _inputs(n=8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        depth_pipe.forward(frames, init_noise=noise, **DEPTH_CALL)
    spans, chunks = _spans(prof), depth_pipe.last_chunks
    clips = [s for s in spans if s[0] == tprof.CLIP_SPAN]
    assert len(clips) == 1
    phases = _inside(spans, clips[0], "rollingdepth.")
    assert [s[0] for s in phases] == [f"rollingdepth.{p}" for p in depth_pipe.last_timings]
    assert len(phases) == len([s for s in spans if s[0].startswith("rollingdepth.")])
    names = [s[0] for s in spans]
    assert chunks["refine_unet"] > 0
    assert names.count("rd.unet") == chunks["unet"] + chunks["refine_unet"]
    assert (names.count("rd.vae.encode"), names.count("rd.vae.decode")) == (chunks["encode"], chunks["decode"])
    _check_solves(spans, 1)
    assert "rd.solve.capture" not in names and tprof.PHASE_SYNC_SPAN not in names
    assert all(clips[0][1] <= s[1] and s[2] <= clips[0][2] for s in spans)


def test_spans_leave_outputs_alone_and_cost_no_range_untraced(depth_pipe, monkeypatch):
    """With no profiler running no ``record_function`` is entered, and the
    outputs are the same bits with a profiler as without."""
    monkeypatch.delenv(tprof.TRACE_ENV, raising=False)
    frames, noise = _inputs(n=8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = depth_pipe.forward(frames, init_noise=noise, **DEPTH_CALL)

    def refuse(self):
        raise AssertionError(f"record_function {self.name!r} entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", refuse)
    calls = depth_pipe.clip_calls
    plain = depth_pipe.forward(frames, init_noise=noise, **DEPTH_CALL)
    assert depth_pipe.clip_calls == calls + 1
    np.testing.assert_array_equal(plain.depth_pred, traced.depth_pred)
    np.testing.assert_array_equal(plain.depth_coaligned, traced.depth_coaligned)
    with tprof.PhaseTimer(verbose=True).phase("x"), tprof.annotate("rollingdepth.x"), tprof.span("rd.x", {"a": 1}):
        pass
    assert tprof.span("rd.a") is tprof.span("rd.b")


def test_span_is_a_profiler_range_with_its_args():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.span("rd.test_range", {"call": 3}):
            torch.ones(3).sum()
    assert [s[0] for s in _spans(prof)] == ["rd.test_range"]


def test_relight_call_spans_each_layer(monkeypatch):
    """A relight call is one ``rd.clip`` holding its ``rollingimg.`` phases
    (``encode``, ``init``, ``snippet_infer``, ``decode``, ``coalign``), an
    ``rd.unet`` per UNet chunk of both UNets, an ``rd.t2i`` holding one
    ``rd.sampler`` per t2i step of each chunk, an ``rd.sampler`` per window
    step in ``snippet_infer``, a ``rd.vae.*`` per VAE chunk and one solve a
    channel; ``last_counters`` counts what the chunk counts imply."""
    from tests.test_torch_relight import STEPS, build_pair, frames

    monkeypatch.delenv(tprof.TRACE_ENV, raising=False)
    _, tpipe = build_pair()
    kw = dict(dilations=[1, 2], cap_dilation=False, init_mode="t2i", seed=2,
              coalign_kwargs={"num_iterations": 1}, **STEPS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tpipe.forward(frames(), frames(seed=1), **kw)
    spans, chunks = _spans(prof), tpipe.last_chunks
    clips = [s for s in spans if s[0] == tprof.CLIP_SPAN]
    assert len(clips) == 1 and all(clips[0][1] <= s[1] and s[2] <= clips[0][2] for s in spans)
    phases = ["encode", "init", "snippet_infer", "decode", "coalign"]
    assert list(tpipe.last_timings) == phases
    assert [s[0] for s in _inside(spans, clips[0], "rollingimg.")] == [f"rollingimg.{p}" for p in phases]
    names = [s[0] for s in spans]
    assert names.count("rd.unet") == chunks["unet"] + chunks["t2i_unet"]
    assert (names.count("rd.vae.encode"), names.count("rd.vae.decode")) == (chunks["encode"], chunks["decode"])
    (t2i,) = [s for s in spans if s[0] == "rd.t2i"]
    (init,) = [s for s in spans if s[0] == "rollingimg.init"]
    (infer,) = [s for s in spans if s[0] == "rollingimg.snippet_infer"]
    assert init[1] <= t2i[1] and t2i[2] <= init[2]
    t2i_chunks, t_start = 3, 2  # 6 frames two at a time; a 4-step schedule entered at strength 0.5
    assert chunks["t2i_unet"] == t2i_chunks * t_start
    assert len(_inside(spans, t2i, "rd.sampler")) == chunks["t2i_unet"]
    assert len(_inside(spans, infer, "rd.sampler")) == chunks["unet"]
    assert names.count("rd.sampler") == chunks["t2i_unet"] + chunks["unet"]
    windows = 4 + 2  # dilations 1 and 2 over 6 frames
    generators = 6 + 6 * t_start + windows * (STEPS["num_inference_steps"] - t_start)  # a frame's init, each step's
    assert tpipe.last_counters == {"iclight_unet_calls": chunks["unet"], "base_unet_calls": chunks["t2i_unet"],
                                   "sampler_steps": chunks["unet"] + chunks["t2i_unet"],
                                   "noise_generators": generators}
    _check_solves(spans, 3)
