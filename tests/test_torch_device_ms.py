"""The rule by which ``fewbit_tpu_torch.tools.act_timing.device_time`` (the
device timer of ``chip_smoke.py``) accepts a reading and names how it was
read, on the CPU: the profiler's and the CUDA events' readings are stood in
for, since neither reads a device here."""

import pytest
import torch

from fewbit_tpu_torch.tools import act_timing


@pytest.fixture
def readings(monkeypatch):
    """Feeds ``device_ms`` the given profiled and event readings in order;
    records the calls made."""
    calls = {"fn": 0, "profiled": [], "events": []}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def feed(profiled, events=()):
        profiled, events = list(profiled), list(events)
        monkeypatch.setattr(act_timing, "_profiled_ms", lambda fn, reps: (
            calls["profiled"].append(reps), profiled.pop(0))[1])
        monkeypatch.setattr(act_timing, "_event_ms", lambda fn, reps: (
            calls["events"].append(reps), events.pop(0))[1])

    def fn():
        calls["fn"] += 1

    return feed, fn, calls


def test_median_of_the_profiled_runs(readings):
    feed, fn, calls = readings
    feed([0.30, 0.10, 0.20])
    ms, source = act_timing.device_time(fn, reps=7)
    assert ms == pytest.approx(0.20) and source == "profiler"
    assert calls["profiled"] == [7, 7, 7] and calls["events"] == []
    assert calls["fn"] == 1  # the warm call


def test_runs_below_the_bound_are_dropped_events(readings):
    """Without a bound a low run counts (the old rule); with one it does
    not."""
    feed, fn, calls = readings
    feed([0.0013, 0.08, 0.09])
    assert act_timing.device_ms(fn) == pytest.approx(0.08)
    feed([0.0013, 0.08, 0.09])
    ms, source = act_timing.device_time(fn, bound_ms=0.05)
    assert ms == pytest.approx(0.085) and source == "profiler"
    assert calls["events"] == []


def test_every_profiled_run_below_the_bound_takes_events(readings):
    feed, fn, calls = readings
    feed([0.001, 0.0, 0.002], [0.01, 0.07])
    ms, source = act_timing.device_time(fn, reps=5, bound_ms=0.05)
    assert ms == pytest.approx(0.07) and source == "events"
    assert calls["events"] == [5, 5]


def test_every_reading_below_the_bound_raises(readings):
    feed, fn, _ = readings
    feed([0.001, 0.001, 0.001], [0.01, 0.02, 0.03])
    with pytest.raises(AssertionError, match="below the bound"):
        act_timing.device_ms(fn, bound_ms=0.05)


def test_no_device_time_without_a_bound_raises(readings):
    feed, fn, calls = readings
    feed([0.0, 0.0, 0.0])
    with pytest.raises(AssertionError, match="no device time"):
        act_timing.device_ms(fn)
    assert calls["events"] == []
