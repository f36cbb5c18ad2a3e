"""The program's layer spans in the trace (``gstk.*``, host operations
gathered by :mod:`gsbench.program`) and the readers of
``gsbench/metrics/_layer.py``.

A hand-made trace on three threads fixes the attribution: a device event
goes to the innermost program span holding its launch call, a span of the
launching thread first (the autograd engine's thread opens none, so its
launches go to the calling thread's ``backward``); an idle gap goes to the
innermost span open when it began. The same trace read with and without
the ``gstk.*`` ranges gives every older reader the same values, and
``breakdown`` the same device operations and idle time; only an idle gap
that began outside every ATen call is now named by the program's span
there. A traced train stretch on the CPU holds the spans inside the
harness's own, and the layer readers read nothing there (no device
event); on the card (``python -m pytest -m gpu
gsbench/tests/test_gsbench_layers.py``) K1 and K3 are charged to
``raster``, K2 and K4 to ``backward``, the refine's events are the same
under both spans, and the step's are among the harness step's."""

from __future__ import annotations

import importlib
import importlib.util
import json

import pytest
import torch

from gsbench import program
from gsbench import run as grun
from gsbench import trace as gtrace
from gsbench.tests.tiny import REPO, tiny_root

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
OLDER = ["refine_ms.train", "launches_per_step.train", "copy_out_ms.render",
         "k1_roofline.train", "k2_roofline.train", "k1_roofline.render",
         "idle_share.train", "idle_share.render", "mfu.train", "mfu.render"]
LAYER_METRICS = [m["name"] for m in MANIFEST["per_layer"] if m["name"] not in OLDER]
MAIN, VIEWER, AUTOGRAD = 1, 2, 3


def _layer():
    spec = importlib.util.spec_from_file_location(
        "gsbench_layer_test", REPO / "gsbench" / "metrics" / "_layer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, ts, end, tid=MAIN):
    """A harness span (a user annotation), or a program span or an ATen
    call (host operations)."""
    cat = "user_annotation" if name.startswith("gsbench.") else "cpu_op"
    return {"ph": "X", "cat": cat, "name": name, "ts": ts,
            "dur": end - ts, "pid": 1, "tid": tid}


class _Events:
    """A hand-made trace: spans, launch calls and their device events."""

    def __init__(self):
        self.events = []
        self.corr = 0

    def launch(self, ts, tid, start, dur, name="kernel_x", cat="kernel"):
        self.corr += 1
        call = "cudaMemcpyAsync" if cat == "gpu_memcpy" else "cudaLaunchKernel"
        self.events += [
            {"ph": "X", "cat": "cuda_runtime", "name": call, "ts": ts, "dur": 0.2,
             "pid": 1, "tid": tid, "args": {"correlation": self.corr}},
            {"ph": "X", "cat": cat, "name": name, "ts": start, "dur": dur,
             "pid": 0, "tid": 7, "args": {"correlation": self.corr}}]


def _synthetic(program: bool = True) -> gtrace.Trace:
    """Two steps of 100 us and a refine, a render request, a snapshot;
    with ``program`` the program's spans too (times in us)."""
    ev = _Events()
    ev.events.append(_span("gsbench.window", 0, 400))
    for k in range(2):
        o = 100.0 * k
        ev.events += [_span("gsbench.snapshot", o, o + 1), _span("gsbench.step", o + 1, o + 100)]
        if program:
            ev.events += [_span("gstk.step", o + 1.5, o + 99),
                          _span("gstk.project", o + 2, o + 20),
                          _span("gstk.raster", o + 20, o + 40),
                          _span("gstk.loss", o + 40, o + 50),
                          _span("gstk.backward", o + 50, o + 80),
                          _span("gstk.update", o + 80, o + 98),
                          # a second thread's span, open across project
                          _span("gstk.copy_out", o + 1.8, o + 30, VIEWER)]
        # an ATen call open at the start of the backward's gap
        ev.events.append(_span("aten::mul", o + 70, o + 80))
        ev.launch(o + 0.5, MAIN, o + 0.6, 0.3)  # the snapshot
        ev.launch(o + 5, MAIN, o + 6, 10)  # project
        ev.launch(o + 12, VIEWER, o + 12, 2, "Memcpy DtoH (Device -> Pageable)",
                  "gpu_memcpy")  # the second thread's own span
        ev.launch(o + 25, MAIN, o + 26, 10, "composite_fwd_kernel<4>")  # raster
        ev.launch(o + 45, MAIN, o + 45.5, 1.5)  # loss
        ev.launch(o + 60, AUTOGRAD, o + 60, 15, "composite_bwd_kernel<4>")  # backward
        ev.launch(o + 85, MAIN, o + 85, 10)  # update
        ev.launch(o + 98.5, MAIN, o + 98.6, 1)  # the step, past its layers
    ev.events += [_span("gsbench.refine", 200, 230)]
    if program:
        ev.events.append(_span("gstk.refine", 201, 229))
    ev.launch(210, MAIN, 210, 10)
    ev.events += [_span("gsbench.request", 300, 350)]
    ev.launch(310, MAIN, 312, 8, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy")
    # a device event with no launch call in the trace
    ev.events.append({"ph": "X", "cat": "kernel", "name": "orphan", "ts": 390,
                      "dur": 1, "pid": 0, "tid": 7, "args": {}})
    return gtrace.Trace(ev.events, {"k1": 2, "k2": 2, "k3": 0, "k4": 0})


class _Ctx:
    """What a reader reads, with fixed work counts."""

    f32_peak = grun.F32_PEAK
    hbm_peak = grun.HBM_PEAK

    def __init__(self, trace, iterations=2):
        self.trace = trace
        self.iterations = iterations
        self.step_ms = 0.2
        self.refine_every = 100

    def work(self, name):
        return [{"flops": 1e6, "bytes": 2e6}] * self.iterations

    def least_seconds(self, name):
        return 1e-6 * self.iterations


def test_device_and_idle_time_are_charged_to_the_innermost_span():
    layer, tr = _layer(), _synthetic()
    ctx = _Ctx(tr)
    got = {name: layer.device_ms(ctx, name) for name in
           ("project", "raster", "loss", "backward", "update", "step", "copy_out", "refine")}
    # a step's us in each of the two steps (the refine's once) / 1e3
    assert got == pytest.approx({"project": 0.01, "raster": 0.01, "loss": 0.0015,
                                 "backward": 0.015, "update": 0.01, "step": 0.001,
                                 "copy_out": 0.002, "refine": 0.005})
    # gaps: 16-26 in project (copy_out on the other thread started before
    # it), 36-45.5 raster, 47-60 loss, 75-85 backward, 95-98.6 update
    idle = {name: layer.idle_ms(ctx, name)
            for name in ("project", "raster", "loss", "backward", "update")}
    assert idle == pytest.approx({"project": 0.01, "raster": 0.0095, "loss": 0.013,
                                  "backward": 0.01, "update": 0.0036})
    # the gaps are breakdown's, and the layers' share of them no more
    gaps = sum(t - s for s, t in layer.gaps(tr)) / 1e6
    assert gaps == pytest.approx(sum(v for _, v in grun.breakdown(tr)["idle_gaps"]))
    assert sum(idle.values()) * 2 / 1e3 < gaps
    # a launch outside every program span, and an event with no call
    spans = program.of(tr)
    assert spans.layer_at(99.2) == "" and spans.layer_at(250.0) == ""
    assert spans.layer_of({"args": {}}) == ""
    # each new metric file reads its layer
    for name in LAYER_METRICS:
        want = (layer.idle_ms if "_idle_" in name else layer.device_ms)(
            ctx, name.split("_")[0])
        assert grun._metric_reader(REPO, name)(ctx) == want


def test_layer_readers_read_nothing_without_spans_or_device_events():
    layer = _layer()
    bare = _synthetic(program=False)
    for name in LAYER_METRICS:
        assert grun._metric_reader(REPO, name)(_Ctx(bare)) is None
    tr = _synthetic()
    tr.device = tr.matched = []
    for name in ("project", "raster", "loss", "backward", "update"):
        assert layer.device_ms(_Ctx(tr), name) is None
        assert layer.idle_ms(_Ctx(tr), name) is None


def test_older_readers_and_breakdown_ignore_the_program_spans():
    with_spans, without = _synthetic(True), _synthetic(False)
    assert program.of(with_spans).spans and not program.of(without).spans
    for name in OLDER:
        read = grun._metric_reader(REPO, name)
        a, b = read(_Ctx(with_spans)), read(_Ctx(without))
        assert a == b, name
    a, b = grun.breakdown(with_spans), grun.breakdown(without)
    assert a["device_ops"] == b["device_ops"]
    # the same gaps: a gap in an ATen call keeps its name, and one outside
    # every ATen call takes the program span's instead of "outside"
    outside = "(host outside any op)"
    assert dict(b["idle_gaps"]).keys() == {outside, "aten::mul"}
    assert dict(a["idle_gaps"])["aten::mul"] == dict(b["idle_gaps"])["aten::mul"]
    assert sum(v for _, v in a["idle_gaps"]) == pytest.approx(
        sum(v for _, v in b["idle_gaps"]))
    assert {n for n, _ in a["idle_gaps"]} - {outside, "aten::mul"} <= {
        program.PREFIX + n for n in program.of(with_spans).spans}
    assert gtrace.check(with_spans, True) == gtrace.check(without, True)


def _traced_train(root, device, seconds=0.3):
    """A train cell of ``root`` set up, run for ``seconds`` and traced as
    a run does it; returns the traced stretch's info."""
    manifest = grun.load_manifest(root)
    cell = next(w for w in manifest["workloads"] if w["name"] == "train.gs-1spp-30k")
    run = grun.Run(root, manifest, cell, 2 ** 31 + 17, device)
    driver = importlib.import_module("gsbench.drivers.train").DRIVER(run)
    driver.setup()
    driver.window(seconds)
    return driver.traced(lambda body: gtrace.record(body, device))


def _within(ivs, ts):
    return any(iv[0] <= ts <= iv[1] for iv in ivs)


def test_a_traced_stretch_on_the_cpu_holds_the_program_spans(tmp_path):
    torch.set_num_threads(4)
    info = _traced_train(tiny_root(tmp_path), torch.device("cpu"))
    tr, steps = info["trace"], info["iterations"]
    spans = program.of(tr).spans
    for name in ("step", "project", "raster", "loss", "backward", "update"):
        assert len(spans[name]) == steps, name
    assert len(spans["refine"]) == len(tr.spans["refine"]) == 1
    for name, harness in (("step", "step"), ("refine", "refine")):
        for start, end, _ in spans[name]:
            assert _within(tr.spans[harness], start) and _within(tr.spans[harness], end)
    ctx = grun.Context(info)
    for name in LAYER_METRICS:
        assert grun._metric_reader(REPO, name)(ctx) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_the_kernels_and_the_refine_are_charged_to_their_layers(card, tmp_path):
    info = _traced_train(tiny_root(tmp_path), torch.device("cuda", 0))
    tr = info["trace"]
    spans = program.of(tr)
    assert gtrace.check(tr, True) == []
    for key, layer in (("k1", "raster"), ("k3", "raster"), ("k2", "backward"),
                       ("k4", "backward")):
        evs = tr.kernel_events(key)
        assert len(evs) == tr.made[key] > 0, key
        assert {spans.layer_of(e) for e in evs} == {layer}, key
    corr = lambda evs: {e["args"]["correlation"] for e in evs}
    in_refine = corr(e for e in tr.matched if spans.layer_of(e) == "refine")
    assert in_refine and in_refine == corr(tr.events_in("refine"))
    in_step = corr(e for e in tr.matched if _within(
        spans.spans["step"], float(tr.calls[e["args"]["correlation"]]["ts"])))
    assert in_step and in_step <= corr(tr.events_in("step"))
