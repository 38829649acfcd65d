"""``spans.read_spans`` and ``trace.read_events`` on synthetic profiler
events laid out as ``torch.profiler`` gives them on the card: host ranges
and runtime calls on the CPU, kernels on the CUDA side joined to their
launch by correlation id, the device copies of host ranges under the
ranges' names, and the runtime calls of every thread under the first
thread's number with the system's thread id beside it; ``spans.traced_run``
on a tiny cell on the CPU."""

import json
import os
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from rdbench import run, spans, trace
from rdbench.spans import OUTSIDE, SPAN_PREFIXES, read_spans, readings
from rdbench.trace import WINDOW_SPAN, read_events, top

from .test_rdbench_harness import SEED, bench_for

MAIN, OTHER = (1, 100), (1, 200)  # (start_thread_id, device_resource_id)
PHASES = ("rollingdepth.",)
READINGS = ("unet_busy_s", "vae_busy_s", "coalign_busy_s", "host_syncs")


class Event:
    def __init__(self, name, a, b, corr=0, device=DeviceType.CPU, thread=MAIN):
        self._v = (name, a, b, corr, device, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5][0]

    def device_resource_id(self):
        return self._v[5][1]


def host(name, a, b, corr=0, thread=MAIN):
    return Event(name, a, b, corr, DeviceType.CPU, thread)


def kernel(name, a, b, corr):
    return Event(name, a, b, corr, DeviceType.CUDA, (1, 7))


def trace_events():
    """One clip in a 1000 ns window: an encode chunk, the solve's stages (a
    pageable upload, two graph replays, the merge), a phase's card sync, a
    UNet call (a ctypes launch), a blocking copy; a kernel launched before
    the window and one after the clip; another thread's span, launch and sync."""
    return [
        host(WINDOW_SPAN, 0, 1000, corr=1),
        host("rd.clip", 100, 900, corr=2),
        kernel("rd.clip", 150, 850, corr=2),  # the range's device copy: no kernel
        host("rollingdepth.encode", 110, 300, corr=3),
        host("rd.vae.encode", 120, 200, corr=4),
        host("cudaLaunchKernel", 130, 135, corr=11), kernel("conv_k", 150, 250, 11),
        host("cudaStreamSynchronize", 190, 195, corr=12),
        host("rollingdepth.coalign", 300, 700, corr=5),
        host("rd.solve", 310, 690, corr=6),
        host("rd.solve.prepare", 315, 330, corr=7),
        host("cudaMemcpyAsync", 320, 321, corr=20), kernel("Memcpy HtoD (Pageable -> Device)", 322, 325, 20),
        host("cudaStreamSynchronize", 326, 327, corr=21),
        host("rd.solve.replay", 340, 600, corr=8),
        host("cudaGraphLaunch", 350, 355, corr=30), kernel("step_a", 360, 400, 30), kernel("step_b", 400, 450, 30),
        host("cudaGraphLaunch", 360, 365, corr=31), kernel("step_a", 450, 520, 31), kernel("step_b", 530, 560, 31),
        host("rd.solve.merge", 600, 680, corr=9),
        host("cudaLaunchKernel", 610, 611, corr=40), kernel("gather", 620, 640, 40),
        host("rd.phase_sync", 695, 699, corr=10),
        host("cudaDeviceSynchronize", 696, 698, corr=50),
        host("rd.unet", 710, 850, corr=13),
        host("cuLaunchKernel", 720, 721, corr=60), kernel("flash_fwd", 730, 800, 60),
        host("cudaMemcpyAsync", 855, 856, corr=61),  # no sync
        host("cudaMemcpy", 860, 861, corr=62),
        host("cudaLaunchKernel", 950, 951, corr=70), kernel("fill", 960, 990, 70),
        host("cudaLaunchKernel", -60, -59, corr=90), kernel("early", -50, 20, 90),
        host("rd.other", 100, 900, corr=14, thread=OTHER),
        host("cudaLaunchKernel", 500, 501, corr=80, thread=OTHER), kernel("other_k", 870, 880, 80),
        host("cudaStreamSynchronize", 505, 506, corr=81, thread=OTHER),
    ]


def profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: iter(events))))


def without_spans(events):
    """The same trace from a program without the ``rd.`` spans."""
    return [e for e in events if not e.name().startswith(SPAN_PREFIXES)]


def test_read_spans_nests_joins_and_adds_up():
    out = read_spans(profile(trace_events()), SPAN_PREFIXES + PHASES)
    s = out["by_span"]
    assert out["window_s"] == 1000e-9 and out["kernels"] == 11
    assert out["busy_s"] == pytest.approx(443e-9)
    busy = {n: round(r["busy_s"] * 1e9) for n, r in s.items() if r["busy_s"]}
    assert busy == {OUTSIDE: 50, "rd.vae.encode": 100, "rd.solve.prepare": 3, "rd.solve.replay": 190,
                    "rd.solve.merge": 20, "rd.unet": 70, "rd.other": 10}
    assert sum(r["busy_s"] for r in s.values()) == pytest.approx(out["busy_s"])
    incl = {n: round(s[n]["busy_incl_s"] * 1e9) for n in ("rd.clip", "rd.solve", "rollingdepth.coalign",
                                                          "rollingdepth.encode", "rd.unet")}
    assert incl == {"rd.clip": 383, "rd.solve": 213, "rollingdepth.coalign": 213, "rollingdepth.encode": 100,
                    "rd.unet": 70}
    idle = {n: round(r["idle_s"] * 1e9) for n, r in s.items() if r["idle_s"]}
    assert idle == {OUTSIDE: 140, "rollingdepth.encode": 72, "rd.solve.prepare": 35, "rd.solve.replay": 70,
                    "rd.solve.merge": 90, "rd.unet": 70, "rd.clip": 80}
    assert sum(r["idle_s"] for r in s.values()) == pytest.approx(out["window_s"] - out["busy_s"])
    syncs = {n: r["syncs"] for n, r in s.items() if r["syncs"]}
    assert syncs == {"rd.vae.encode": 1, "rd.solve.prepare": 1, "rd.phase_sync": 1, "rd.clip": 1, "rd.other": 1}
    assert (s["rd.clip"]["syncs_incl"], s["rd.phase_sync"]["syncs_incl"], s["rd.solve"]["syncs_incl"]) == (4, 1, 1)
    assert s["rd.clip"]["calls"] == 1 and s["rd.solve.replay"]["calls"] == 1 and s[OUTSIDE]["calls"] == 0
    assert round(s["rd.clip"]["host_self_s"] * 1e9) == 800 - 190 - 400 - 140
    assert round(s["rd.solve"]["host_self_s"] * 1e9) == 380 - 15 - 260 - 80


def test_read_events_and_the_accepted_metrics_ignore_the_spans():
    """The phases' breakdown and the accepted metrics read the same from a
    trace with the ``rd.`` spans as from one without them."""
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        accepted = [m["name"] for m in json.load(f)["per_layer"]]
    assert len(accepted) == 8
    clips = [{"frames": 60, "entry_s": 2.0, "timings": {"encode": 0.3, "snippet_infer": 0.5, "coalign": 0.6,
                                                         "decode": 0.4}}]
    readings = []
    for events in (trace_events(), without_spans(trace_events())):
        got = read_events(profile(events), PHASES)
        ctx = {"phases": {"unet": ("snippet_infer",), "vae": ("encode", "decode"), "coalign": ("coalign",)},
               "clips": clips, "window_s": 1e-6, "trace": got, "counts": {"flops": 1e3, "attn_flops": 10.0,
                                                                           "gn_bytes": 10.0},
               "peak_flops": 1e15, "peak_bytes_per_s": 1e12}
        metrics = {m: run.load_module("metrics", m).read(ctx) for m in accepted}
        readings.append((got, top(got["kernel_s"]), top(got["idle_s"]), metrics))
    assert readings[0] == readings[1]
    assert readings[0][0]["idle_s"]["rollingdepth.coalign"] == pytest.approx(195e-9)


@pytest.mark.parametrize("reading", READINGS)
def test_readings_read_the_spans_and_none_without(reading):
    want = {"unet_busy_s": 70e-9, "vae_busy_s": 100e-9, "coalign_busy_s": 213e-9, "host_syncs": 3.0}[reading]
    assert readings(read_spans(profile(trace_events()), SPAN_PREFIXES + PHASES))[reading] == pytest.approx(want)
    assert reading not in readings(read_spans(profile(without_spans(trace_events())), SPAN_PREFIXES + PHASES))


def test_traced_run_reads_the_spans_of_the_harness_profile(tiny_bench):
    """The harness's traced run with the spans read from its own profile:
    its result as the harness gives it, one ``rd.clip`` a clip holding the
    phases, the UNet, the VAE and the solve; nothing to read on the CPU."""
    result, got = spans.traced_run("tiny-full", SEED, 0.01, device="cpu", bench_dir=tiny_bench,
                                   benchmark=bench_for(tiny_bench))
    assert trace.read_events is read_events
    assert result["correct"] and "breakdown" in result
    assert {"pipeline_host_s", "unet_s", "vae_s", "coalign_s"} <= set(result["metrics"])
    s = got["by_span"]
    assert s["rd.clip"]["calls"] == result["attempted"]
    for name in ("rollingdepth.snippet_infer", "rd.unet", "rd.vae.encode", "rd.vae.decode", "rd.solve",
                 "rd.solve.replay"):
        assert s[name]["calls"] >= result["attempted"], name
    assert got["kernels"] == 0 and readings(got) == {}
