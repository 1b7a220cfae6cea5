"""The closed loop's end-to-end numbers are all the work over all the
window's time, and the tail is over every request: a stall injected into
the window moves both."""
import threading
import time
from types import SimpleNamespace

import pytest

from bench_tiny import BENCH  # noqa: F401
from benchlib import port, traffic
from benchlib.result import Clock, percentile

port.import_port()


class StubEngine:
    """Resolves every request ``service_s`` after its submission, one at a
    time; ``stall`` (start, seconds) holds every completion due in it."""

    def __init__(self, service_s: float, stall=None):
        from repro_torch.core import Promise

        self._Promise = Promise
        self.service_s, self.stall = service_s, stall
        self.t0 = None
        self.timers = []

    def submit(self, prompt, new, request_id=None):
        p = self._Promise()
        delay = self.service_s
        if self.stall is not None:
            start, length = self.stall
            now = time.perf_counter() - self.t0
            due = now + delay
            if start <= due < start + length:
                delay = start + length - now
        t = threading.Timer(delay, p.set_value, args=([1] * new,))
        t.daemon = True
        t.start()
        self.timers.append(t)
        return p.get_future()

    def metrics(self):
        return {}


def _window(stall):
    drv = __import__("benchlib.registry", fromlist=["x"]).load_module("drivers",
                                                                      "serve_closed_loop")
    mix = {"strata": 4, "clients": 4,
           "prompt": {"dist": "uniform", "min": 8, "max": 8},
           "output": {"dist": "uniform", "min": 10, "max": 10}}
    reqs = traffic.Requests(mix, 3, 100)
    eng = StubEngine(0.2, stall)
    cell = SimpleNamespace(seconds=2.0, trace=False, traffic={}, clock=Clock())
    eng.t0 = time.perf_counter()
    res = drv._window(cell, eng, reqs, 4, drv._Record())
    return res["tokens"] / cell.seconds, percentile(res["latencies"], 95), res


def test_bench_a_stall_in_the_window_moves_rate_and_tail():
    rate, p95, res = _window(None)
    assert res["failed"] == 0 and len(res["latencies"]) >= 30
    assert rate == pytest.approx(4 * 10 / 0.2, rel=0.25)
    s_rate, s_p95, s_res = _window((0.7, 0.6))
    assert s_rate < 0.85 * rate       # the stalled time counts: a rate over the whole window
    assert s_p95 > 3 * p95            # the stalled requests are in the tail
    assert max(s_res["latencies"]) >= 0.5
