"""The readers of the program's stage marks and host spans on synthetic
profiler events."""

import types

import pytest

from portbench import harness
from portbench.yardstick import stages as S
from portbench.yardstick import trace as T
from portbench.yardstick.trace import Event

STAGE_METRICS = ("models_ms_per_call", "dfs_ms_per_call",
                 "tables_ms_per_call", "draws_ms_per_call")


def mark(stage, t):
    return Event("kernel", "cg_stage_" + stage, t, 1)


def ctx(events=(), span=(0.0, 1000.0), host_events=(), host_span=None,
        host_calls=1):
    return types.SimpleNamespace(
        events=list(events), span=span, host_events=list(host_events),
        host_span=host_span, host_calls=host_calls, n_calls=host_calls)


def call(t0, models=10.0, dfs=20.0, tables=5.0, draws=8.0, dtoh=30.0):
    """One merger-like call from ``t0``: models with one DF nested, then
    tables, then draws, each top-level stage closed by ``end``, and the
    copy of its outputs to the host after the last mark."""
    ev, t = [], t0
    for stage, us in (("models", models / 2), ("dfs", dfs),
                      ("models", models / 2), ("end", 0.0),
                      ("tables", tables), ("end", 0.0), ("draws", draws),
                      ("end", 0.0)):
        ev.append(mark(stage, t))
        t += 1
        if us:
            ev.append(Event("kernel", "work_" + stage, t, us))
            t += us
    ev.append(Event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", t, dtoh))
    return ev, t + dtoh


def test_stage_names_come_from_the_mark_kernels():
    assert S.stage_of("cg_stage_models") == "models"
    assert S.stage_of("cg_stage_end") == "end"
    assert S.stage_of("void cg_stage_dfs()") == "dfs"
    assert S.stage_of("invert_cdf_rows_kernel") is None
    # no mark's name is one of the spans': a device event named as a host
    # span is taken for the span's mirror and left out of the device work
    assert not any(("cg_stage_" + s).startswith(S.SPAN) for s in
                   ("models", "dfs", "tables", "draws", "end"))


def test_nested_stages_hand_back_to_the_enclosing_one():
    ev, _ = call(0.0)
    got = {m: harness.reader(m + ".merger")(ctx(ev)) for m in STAGE_METRICS}
    # models' two stretches around the DF, each 5 us
    assert got == pytest.approx({"models_ms_per_call": 0.010,
                                 "dfs_ms_per_call": 0.020,
                                 "tables_ms_per_call": 0.005,
                                 "draws_ms_per_call": 0.008})


def test_per_call_is_over_the_complete_sequences():
    a, t = call(0.0, models=10.0)
    b, t = call(t + 50, models=30.0)
    got = harness.reader("models_ms_per_call.datagen")(ctx(a + b))
    assert got == pytest.approx((10.0 + 30.0) / 2 / 1e3)
    assert harness.reader("dfs_ms_per_call.merger")(ctx(a + b)) == \
        pytest.approx(0.020)


def test_copies_to_the_host_and_the_marks_are_no_stage_work():
    ev = [mark("draws", 0), Event("kernel", "w", 1, 4),
          Event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 2, 50),
          Event("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 6, 2),
          Event("gpu_memset", "Memset (Device)", 9, 1), mark("end", 20)]
    # the kernel 1-5, the DtoD copy 6-8 and the fill 9-10; the mark kernels'
    # own microsecond and the DtoH copy beside them left out
    assert harness.reader("draws_ms_per_call.merger")(ctx(ev)) == \
        pytest.approx(7e-3)


def test_sequences_cut_by_the_window_are_left_out():
    a, t = call(0.0)
    b, t2 = call(t + 50, draws=100.0)
    # the window ends inside the second call's draws: that sequence is
    # left out; its models and tables, each closed by its end, count
    span = (0.0, t + 50 + 60)
    assert len(S.sequences(a + b, span)) == 5
    assert harness.reader("draws_ms_per_call.merger")(ctx(a + b, span)) == \
        pytest.approx(0.008)
    assert harness.reader("models_ms_per_call.merger")(
        ctx(a + b, span)) == pytest.approx(0.010)
    # a window that begins between the calls holds only the second
    span = (t + 10, t2 + 1)
    assert harness.reader("draws_ms_per_call.merger")(ctx(a + b, span)) == \
        pytest.approx(0.100)
    # marks outside the window: nothing
    assert S.marks(a, (t + 1, t + 2)) == []


def test_nothing_to_read_without_marks_or_spans():
    ev = [Event("kernel", "w", 0, 10),
          Event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 10, 5)]
    for m in STAGE_METRICS:
        assert harness.reader(m + ".merger")(ctx(ev)) is None
        assert harness.reader(m + ".datagen")(ctx([])) is None
    # marks but no complete sequence
    assert harness.reader("models_ms_per_call.merger")(
        ctx([mark("models", 0), Event("kernel", "w", 1, 5)])) is None
    host = [Event("cpu_op", "aten::add", 0, 5),
            Event("user_annotation", "portbench.window", 0, 100)]
    assert harness.reader("host_ms_per_call.merger")(
        ctx(host_events=host, host_span=(0, 100))) is None
    assert harness.reader("host_ms_per_call.merger")(ctx()) is None


def test_host_time_is_the_hosts_own_spans_per_call():
    host = [Event("user_annotation", "portbench.window", 0, 1000),
            Event("user_annotation", "cg.host.inputs", 10, 20),
            Event("user_annotation", "cg.host.copy_in", 30, 5),
            Event("user_annotation", "cg.host.draw", 35, 15),
            Event("user_annotation", "cg.launch", 50, 40),
            Event("user_annotation", "cg.host.hand_out", 90, 30),
            Event("user_annotation", "cg.wait.copy", 120, 400),
            Event("cpu_op", "cg.host.unpack", 520, 10),   # older PyTorch
            # the device's mirror of a span is no host work
            Event("gpu_user_annotation", "cg.host.hand_out", 95, 300),
            Event("user_annotation", "cg.wait.room", 600, 100),
            Event("user_annotation", "cg.host.inputs", 990, 50)]
    got = harness.reader("host_ms_per_call.merger")(
        ctx(host_events=host, host_span=(0, 1000), host_calls=2))
    # the last span is clipped to the window: 10 us of it
    assert got == pytest.approx((20 + 5 + 15 + 30 + 10 + 10) / 1e3 / 2)


def test_gaps_are_named_by_the_span_covering_them():
    """A span covers the CUDA calls inside it, so ``trace.gap_causes``
    names a gap by its span."""
    host = [Event("user_annotation", "cg.host.draw", 0, 10),
            Event("cuda_runtime", "cudaLaunchKernel", 1, 1),
            Event("user_annotation", "cg.launch", 10, 30),
            Event("cuda_runtime", "cudaGraphLaunch", 11, 28),
            Event("cuda_runtime", "cudaMemcpyAsync", 45, 1),
            Event("user_annotation", "cg.wait.copy", 49, 22),
            Event("cuda_runtime", "cudaEventSynchronize", 50, 20),
            Event("kernel", "k", 5, 3), Event("kernel", "k", 40, 8)]
    gaps = T.gap_causes(host, (0, 100), top=2)
    # 48-100 idle: the wait covers 22 of its 52 us; 8-40: the launch
    assert gaps == [["cg.wait.copy", pytest.approx(52e-6)],
                    ["cg.launch", pytest.approx(32e-6)]]