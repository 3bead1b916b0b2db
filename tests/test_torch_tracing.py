"""The port's stage marks and host spans (``core.profiling.device_stage``
and ``span``) on the CPU: no profiler range while no profiler records, the
documented spans, never nested, while one does, the marks of the merger
and datagen bodies in their documented order, and outputs unchanged by
them.  A replay's marks on the card: tests/test_torch_cuda.py."""

import contextlib

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from cluster_generator_tpu_torch import pipeline as P
from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.core import profiling
from cluster_generator_tpu_torch.core import staging
from cluster_generator_tpu_torch.parallel import ensemble as E

MERGER = dict(M200=[1.5e15, 1.0e15], conc=[4.0, 5.0],
              centers=[[-1500.0, 0, 0], [1500.0, 0, 0]],
              velocities=[[0.3, 0, 0], [-0.45, 0, 0]], r_max=5000.0,
              n_gas=(300, 200), n_dm=(240, 160), n_star=(60, 40),
              num_points=128)
ENSEMBLE = dict(M200=[1.5e15, 4e14, 8e14], conc=[4.0, 6.0, 5.0])
COUNTS = {"dm": 300, "gas": 200, "star": 50}
ORDER = ["models", "dfs", "models", "dfs", "models", "end", "tables", "end",
         "draws", "end"]


def _merger(seed=0):
    return P.merger_ic_fused(**MERGER, device="cpu",
                             generator=torch.Generator().manual_seed(seed))


def _datagen():
    return list(E.datagen_batches(ENSEMBLE["M200"], ENSEMBLE["conc"], COUNTS,
                                  batch_size=2, num_points=64, seed=0,
                                  device="cpu"))


def _spans(prof):
    """The host's ``cg.*`` ranges of a finished profile: ``[(name, start,
    end)]`` in order of start (ns)."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("cg.")
           and "CUDA" not in str(e.device_type())]
    return sorted(out, key=lambda s: s[1])


def _no_overlap(spans):
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def _equal(a, b):
    la, lb = C._leaves(a), C._leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _raise(*args, **kwargs):
    raise AssertionError("a profiler range opened with no profiler")


def test_no_profiler_no_range(monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _raise)
    assert not autograd_profiler._is_profiler_enabled
    s = profiling.span("cg.host.inputs")
    with s:
        pass
    assert profiling.span("cg.launch") is s   # the one shared null context
    _merger()
    _datagen()


def test_the_entries_emit_their_spans_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _merger()
        out = _datagen()
        host = list(staging.stream_to_host(
            [(b0, [o["dm"][0], o["gas"][1]]) for b0, o in out]))
    spans = _spans(prof)
    names = [s[0] for s in spans]
    # one for the merger's inputs, one for each batch's slice and generator
    assert names.count("cg.host.inputs") == 3
    assert names.count("cg.host.stage_copy") == 2   # one per batch
    assert _no_overlap(spans)
    assert [h[0] for h in host] == [0, 2]
    assert isinstance(host[0][1][0], np.ndarray)


def test_a_replay_names_each_host_phase_in_order():
    """A program replayed with a stand-in graph that reruns the body into
    the static outputs, as a CUDA graph's replay would."""
    def body(x, scale, uniforms):
        return {"y": x * scale + uniforms, "x": x}

    x, scale = torch.arange(4.0), torch.tensor(2.0)
    prog = C.Program(("tracing_test",), body)
    prog.device = torch.device("cpu")
    prog.inputs = (x.clone(), scale.clone())
    prog.uniforms = torch.zeros(4)
    prog.outputs = body(*prog.inputs, prog.uniforms)

    class Graph:
        def replay(self):
            for k, v in body(*prog.inputs, prog.uniforms).items():
                prog.outputs[k].copy_(v)

    prog.graph = Graph()

    def draw(out):
        out.fill_(0.5)
        return out

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = prog._replay(None, (x + 1, scale), draw)
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["cg.host.copy_in", "cg.host.draw",
                                     "cg.launch", "cg.host.hand_out"]
    assert _no_overlap(spans)
    assert torch.equal(got["y"], (x + 1) * 2 + 0.5)
    assert got["y"].data_ptr() != prog.outputs["y"].data_ptr()


def test_the_staged_copy_names_its_wait_and_unpacking():
    class Done:
        waited = 0

        def synchronize(self):
            Done.waited += 1

    src = [torch.arange(3, dtype=torch.float32),
           torch.arange(4, dtype=torch.int64).reshape(2, 2)]
    buf = torch.zeros(128, dtype=torch.uint8)
    buf[:12] = src[0].view(torch.uint8)
    buf[64:96] = src[1].reshape(-1).view(torch.uint8)
    staged = (buf, [(0, 12), (64, 32)],
              [(torch.float32, (3,)), (torch.int64, (2, 2))], Done())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a, b = staging._Ring.finish(staged)
    assert [s[0] for s in _spans(prof)] == ["cg.wait.copy", "cg.host.unpack"]
    assert Done.waited == 1
    assert np.array_equal(a, src[0].numpy()) and np.array_equal(
        b, src[1].numpy())


def test_a_room_that_synchronizes_is_a_wait(monkeypatch):
    for name, fn in (("synchronize", lambda d=None: None),
                     ("empty_cache", lambda: None),
                     ("mem_get_info", lambda d=None: (3 << 30, 8 << 30)),
                     ("get_per_process_memory_fraction", lambda d=None: 1.0),
                     ("memory_reserved", lambda d=None: 1 << 30)):
        monkeypatch.setattr(torch.cuda, name, fn)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert C.free_bytes("cuda:0", empty=False) == 3 << 30
        assert C.free_bytes("cuda:0") == 3 << 30
    assert [s[0] for s in _spans(prof)] == ["cg.wait.room"]


def test_a_span_inside_a_span_is_not_recorded():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("cg.launch"):
            with profiling.span("cg.wait.room"):
                torch.ones(2)
        with profiling.span("cg.host.inputs"):
            pass
    assert [s[0] for s in _spans(prof)] == ["cg.launch", "cg.host.inputs"]


@pytest.fixture
def marks(monkeypatch):
    """The stage marks launched, by name, with the mark launcher recording
    instead of launching."""
    got = []
    monkeypatch.setattr(profiling, "_mark",
                        lambda name, device: got.append(name))
    return got


def test_the_merger_body_marks_its_stages(marks):
    _merger()
    assert marks == ORDER


def test_the_datagen_body_marks_its_stages(marks):
    _datagen()
    assert marks == ORDER * 2   # two batches


def test_marks_leave_the_outputs_as_they_were(marks, monkeypatch):
    merger, batches = _merger(3), _datagen()
    assert marks
    null = lambda name, like: contextlib.nullcontext()  # noqa: E731
    monkeypatch.setattr(P, "device_stage", null)
    monkeypatch.setattr(E, "device_stage", null)
    del marks[:]
    assert _equal(merger, _merger(3))
    assert _equal(batches, _datagen())
    assert marks == []


def test_stages_nest_and_an_exception_marks_nothing_more(marks):
    x = torch.zeros(1)
    with profiling.device_stage("models", x):
        with profiling.device_stage("dfs", x):
            pass
        with pytest.raises(RuntimeError):
            with profiling.device_stage("tables", x):
                raise RuntimeError("stage failed")
    assert marks == ["models", "dfs", "models", "tables", "end"]
    assert profiling._open_stages() == []
    with pytest.raises(ValueError):
        with profiling.device_stage("end", x):
            pass


def test_no_mark_is_launched_on_the_cpu(monkeypatch):
    monkeypatch.setattr(profiling, "_mark_kernel", _raise)
    with profiling.device_stage("draws", torch.zeros(1)):
        pass
