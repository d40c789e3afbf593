"""The roofline's work and bytes, and the trace arithmetic, by hand."""

import pytest

from portbench import roofline, trace
from portbench.reference import targets_ref


def test_scan_work_by_hand():
    w = roofline.scan_work(spacers=3, sites=10, L=20, genome_bases=1000, hits=4)
    assert w["pairs"] == 30
    assert w["ops"] == 2 * 4 * 20 * 30  # 2 ops for each of 4L one-hot rows, a pair
    assert w["bytes"] == 3 * 20 + 1000 + 4 * 21


def test_least_time_takes_the_slower_bound():
    t, by = roofline.least_time(1.979e15, 1.0)
    assert by == "ops" and t == pytest.approx(1.0)
    t, by = roofline.least_time(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)


def test_sites_counted_by_hand():
    # forward NGG after the window, reverse CCN before it, around the origin
    seq = "GGTACCAATTACGGATTTACC"
    codes = targets_ref.encode([seq])[0]
    f, r = targets_ref.pam_sites(codes, True, 4, "NGG", "downstream")
    # forward: the window p..p+3, N at p+4, G at p+5 and p+6, mod 21: p = 7
    # (GG at 12, 13) and p = 16 (GG at 0, 1 across the origin); reverse: CC at
    # p-3, p-2: p = 7 (4, 5) and p = 1 (19, 20 across the origin)
    assert f.tolist() == [7, 16] and r.tolist() == [1, 7]
    lin_f, lin_r = targets_ref.pam_sites(codes, False, 4, "NGG", "downstream")
    assert lin_f.tolist() == [7] and lin_r.tolist() == [7]

def test_busy_union_covered_gaps():
    busy = trace.Busy([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert busy.merged == [[0, 3], [5, 8]]
    assert busy.covered(2, 6) == 1 + 1
    assert busy.gaps(-1, 10) == [(-1, 0), (3, 5), (8, 10)]
    assert busy.gaps(0, 3) == [] and busy.gaps(4, 5) == [(4, 5)]
    assert busy.gaps(6, 7) == [] and busy.covered(3, 5) == 0


class _Event:
    def __init__(self, name, dev, a, b):
        self._n, self._d, self._a, self._b = name, dev, a, b

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _self: events})()


def test_trace_busy_share_and_idle_pieces_by_span():
    """Two requests: busy time counts only inside them, a span's shadow on
    the device does not count, and each idle stretch is cut at the spans."""
    ev = [_Event("portbench.request", False, 0, 100), _Event("portbench.scan", False, 0, 40),
          _Event("portbench.postprocess", False, 60, 100),
          _Event("portbench.request", True, 0, 100),  # the shadow
          _Event("kernel_a", True, 10, 30), _Event("kernel_b", True, 20, 35),
          _Event("portbench.request", False, 200, 250), _Event("kernel_a", True, 210, 220),
          _Event("kernel_a", True, 300, 310)]  # outside every request
    t = trace.Trace(_Prof(ev), "request", "targets.other")
    assert t.item_busy_s == pytest.approx([25e-9, 10e-9])
    assert t.window_s == pytest.approx(150e-9) and t.busy_s == pytest.approx(35e-9)
    assert t.device_ops[0] == ["kernel_a", pytest.approx(30e-9)]
    gaps = sorted((n, round(s * 1e9)) for n, s in t.idle_gaps)
    assert gaps == sorted([("scan", 10), ("scan", 5), ("targets.other", 20),
                           ("postprocess", 40), ("targets.other", 10), ("targets.other", 30)])
