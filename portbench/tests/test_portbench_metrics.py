"""Each metric reader on synthetic profiler events and call records."""

import types

import pytest

from portbench import harness
from portbench.yardstick import kernels, stats
from portbench.yardstick import trace as T
from portbench.yardstick.trace import Event

H100 = "NVIDIA H100 80GB HBM3"


def ctx(events=(), span=(0.0, 100.0), n_calls=2, records=(), unit="ics",
        window_s=1.0, shapes=((512, 512, 512), (128, 256, 256)),
        device=H100, peak=0, setup=7.5):
    """A run's context; the window traced with device activity alone and
    the one traced with host activity too hold the same ``events``."""
    return types.SimpleNamespace(
        events=list(events), span=span, n_calls=n_calls,
        traced_s=(span[1] - span[0]) / 1e6,
        untraced_s=(span[1] - span[0]) / 1e6, host_events=list(events),
        host_span=span, host_calls=n_calls,
        records=list(records), unit=unit, window_s=window_s,
        k1_shapes=list(shapes), device_name=device, peak_bytes=peak,
        setup_s=setup)


def test_busy_is_the_union_of_device_work_inside_the_window():
    ev = [Event("kernel", "a", 10, 20), Event("kernel", "b", 20, 20),
          Event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 60, 10),
          Event("gpu_memset", "Memset", 95, 10),
          Event("cpu_op", "aten::add", 0, 100),
          Event("kernel", "outside", 200, 10)]
    assert T.busy_us(ev, (0, 100)) == 30 + 10 + 5
    idle = harness.reader("device_idle_pct.merger")(ctx(ev))
    assert idle == pytest.approx(55.0)
    gaps = T.idle_gaps(ev, (0, 100))
    assert gaps == [(70, 95), (40, 60), (0, 10)]


def test_idle_is_over_the_host_clock_of_its_window():
    # the device's events cover 10-100 us; the device-only traced calls
    # took 200 us on the host clock, the same calls with no profiler 100 us
    ev = [Event("kernel", "a", 10, 40), Event("gpu_memcpy", "Memcpy DtoH",
                                              60, 40)]
    c = ctx(ev, span=T.extent(ev))
    c.traced_s, c.untraced_s = 200e-6, 100e-6
    assert harness.reader("device_idle_pct.datagen")(c) == pytest.approx(
        60.0)
    assert harness.reader("device_idle_pct.merger")(c) == pytest.approx(
        20.0)
    assert T.extent([]) == (0.0, 0.0)


def test_idle_reads_nothing_without_device_work():
    assert harness.reader("device_idle_pct.datagen")(
        ctx([Event("cpu_op", "x", 0, 50)])) is None


def test_host_launches_count_only_calls_that_enqueue_work():
    ev = [Event("cuda_runtime", "cudaLaunchKernel", 1, 1),
          Event("cuda_runtime", "cudaGraphLaunch", 2, 1),
          Event("cuda_runtime", "cudaMemcpyAsync", 3, 1),
          Event("cuda_runtime", "cudaStreamSynchronize", 4, 1),
          Event("cuda_runtime", "cudaEventRecord", 5, 1),
          Event("cuda_driver", "cuLaunchKernel", 6, 1),
          Event("cuda_runtime", "cudaLaunchKernel", 500, 1)]
    assert harness.reader("host_launches_per_call.merger")(
        ctx(ev, n_calls=2)) == 2.0
    assert harness.reader("host_launches_per_call.datagen")(ctx([])) is None


def test_d2h_counts_only_copies_to_the_host():
    ev = [Event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 0, 3000),
          Event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 10, 50),
          Event("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 20, 70),
          Event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 40, 1000)]
    assert harness.reader("d2h_ms_per_call.merger")(
        ctx(ev, span=(0, 10000), n_calls=4)) == pytest.approx(1.0)


def test_k1_roofline_from_the_bytes_of_its_shapes():
    assert kernels.k1_bytes(512, 512, 512) == 4 * 512 * 1024
    dm, star = kernels.k1_bytes(512, 512, 512), kernels.k1_bytes(128, 256, 256)
    least_us = (dm + star) / 3.35e12 * 1e6
    ev = [Event("kernel", "invert_cdf_rows_kernel", 0, 3.0),
          Event("kernel", "invert_cdf_rows_kernel", 10, 2.0),
          Event("kernel", "other", 20, 99.0)]
    got = harness.reader("k1_roofline_pct.merger")(ctx(ev))
    assert got == pytest.approx(100.0 * least_us / 5.0)
    assert 0 < got < 100
    # no K1 in the window, or a card without a table of peaks: nothing
    assert harness.reader("k1_roofline_pct.datagen")(ctx(ev[2:])) is None
    assert harness.reader("k1_roofline_pct.merger")(
        ctx(ev, device="cpu")) is None


def test_p95_is_the_nearest_rank_of_every_call():
    rec = [(0.0, 0.001 * (i + 1), 1) for i in range(100)]
    assert harness.reader("call_p95_ms")(ctx(records=rec)) == \
        pytest.approx(95.0)
    assert stats.percentile([3, 1, 2], 95) == 3
    assert stats.percentile([5], 95) == 5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rates_count_units_over_the_whole_window():
    rec = [(0, 0.1, 256), (0.1, 0.2, 256), (0.2, 0.4, 256)]
    c = ctx(records=rec, unit="clusters", window_s=0.5)
    assert harness.reader("clusters_per_s")(c) == pytest.approx(1536.0)
    assert harness.reader("ics_per_s")(c) is None


def test_memory_and_setup():
    assert harness.reader("peak_mem_gib")(ctx(peak=3 * 2**30)) == 3.0
    assert harness.reader("peak_mem_gib")(ctx(peak=0)) is None
    assert harness.reader("setup_s")(ctx(setup=9.25)) == 9.25


def test_breakdown_names_device_ops_and_what_the_host_did_in_gaps():
    ev = [Event("kernel", "big", 0, 60), Event("kernel", "small", 70, 5),
          Event("cuda_runtime", "cudaStreamSynchronize", 60, 10),
          Event("cpu_op", "aten::copy_", 75, 25),
          Event("user_annotation", "portbench.window", 0, 100)]
    ops = T.device_ops(ev, (0, 100))
    assert ops[0] == ["big", 60e-6] and ops[1][0] == "small"
    causes = T.gap_causes(ev, (0, 100))
    assert causes[0] == ["aten::copy_", 25e-6]
    assert causes[1] == ["cudaStreamSynchronize", 10e-6]
    assert T.span(ev, "portbench.window") == (0, 100)


class _RawEvent:
    """A profiler event as an older PyTorch gives it: no activity type."""

    def __init__(self, name, device, start_us, dur_us):
        self._n, self._d, self._s, self._t = name, device, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return self._t * 1000


def test_events_without_activity_types_and_the_annotations_device_mirror():
    raw = [_RawEvent("portbench.window", "CPU", 0, 100),
           _RawEvent("portbench.window", "CUDA", 5, 95),
           _RawEvent("cudaGraphLaunch", "CPU", 1, 2),
           _RawEvent("cuLaunchKernel", "CPU", 3, 1),
           _RawEvent("aten::mul", "CPU", 4, 1),
           _RawEvent("Memcpy DtoH (Device -> Pinned)", "CUDA", 50, 10),
           _RawEvent("Memset (Device)", "CUDA", 70, 1),
           _RawEvent("invert_cdf_rows_kernel", "CUDA", 10, 20)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    ev = T.events_of(prof)
    assert [e.kind for e in ev] == [
        "cpu_op", "gpu_user_annotation", "cuda_runtime", "cuda_driver",
        "cpu_op", "gpu_memcpy", "gpu_memset", "kernel"]
    span = T.span(ev, "portbench.window")
    assert span == (0, 100)
    assert T.busy_us(ev, span) == 20 + 10 + 1
    assert T.host_launches(ev, span) == 2
