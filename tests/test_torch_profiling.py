"""The port's train/profiling.py against the JAX package's, on the CPU.

* `PhaseTimer`: the same phases on the same scripted clock (a repeated
  name, a phase that raises inside its block, `block_on` of a nested dict
  of CPU tensors here and of jax arrays there) give equal `report()`
  dicts, exactly; `reset()` empties both.
* `trace`: disabled, both yield False and write nothing; enabled under a
  directory, both yield a truthy value and leave a trace file under it
  (the port's holds the `aten::` op run inside); a window opened inside
  another yields False in both, and the outer one keeps its events;
  `logdir=None` writes nothing.
* `device_memory_stats`: both {} without a card.
* `busy_us` and `device_summary` on hand-built intervals and events.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codlad_tpu.train import profiling as JP
from codlad_tpu_torch.train import profiling as TP

# irregular steps, so that every rounding of report() is exercised
CLOCK = [0.0, 0.1234567, 1.0, 1.00000049, 2.5, 2.5004, 3.0, 3.333333333, 4.0, 4.0000001]


def _clock(monkeypatch, module):
    ticks = iter(CLOCK)
    monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks)))


def _run_phases(timer, block_on):
    with timer.phase("encode"):
        pass
    with pytest.raises(ValueError):
        with timer.phase("decode"):
            raise ValueError("inside the phase")
    with timer.phase("encode"):
        pass
    with timer.phase("sync", block_on=block_on):
        pass
    with timer.phase("tiny"):
        pass


def test_phase_timer_report_matches_jax(monkeypatch):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    _clock(monkeypatch, JP)
    _clock(monkeypatch, TP)
    jt, tt = JP.PhaseTimer(), TP.PhaseTimer()
    _run_phases(jt, {"a": jnp.asarray(x), "b": [jnp.asarray(x) + 1, (jnp.asarray(x),)]})
    _run_phases(tt, {"a": torch.from_numpy(x), "b": [torch.from_numpy(x) + 1,
                                                     (torch.from_numpy(x),)]})
    want = jt.report()
    assert list(want) == ["sync", "encode", "decode", "tiny"]   # by total, largest first
    assert want["encode"]["mean_ms"] == round(((0.1234567 - 0.0) + (2.5004 - 2.5)) / 2 * 1e3, 3)
    assert tt.report() == want
    assert dict(tt.counts) == dict(jt.counts) == {"encode": 2, "decode": 1, "sync": 1, "tiny": 1}
    jt.reset()
    tt.reset()
    assert tt.report() == jt.report() == {}
    assert not tt.totals and not tt.counts


def test_block_until_ready_walks_nested_trees():
    t = torch.ones(2)
    tree = {"a": t, "b": [1.5, (t, "text")], "c": None}
    assert TP.block_until_ready(tree) is tree
    assert TP._cuda_devices(tree, set()) == set()          # CPU tensors need no wait


def test_trace_disabled_yields_false_and_writes_nothing(tmp_path):
    for module, sub in ((JP, "jax"), (TP, "torch")):
        with module.trace(str(tmp_path / sub), enabled=False) as on:
            torch.ones(3).sum()
        assert on is False
    assert list(tmp_path.iterdir()) == []


def _files(root):
    return [os.path.join(r, f) for r, _, fs in os.walk(root) for f in fs]


def test_trace_writes_a_trace_file_under_logdir(tmp_path):
    with JP.trace(str(tmp_path / "jax")) as on:
        jnp.ones(3).block_until_ready()
    assert on
    assert any("plugins/profile/" in f for f in _files(tmp_path / "jax"))
    with TP.trace(str(tmp_path / "torch")) as prof:
        torch.ones(4, 4).matmul(torch.ones(4, 4))
    assert prof
    (path,) = _files(tmp_path / "torch")
    rel = os.path.relpath(path, tmp_path / "torch").split(os.sep)
    assert rel[:2] == ["plugins", "profile"] and rel[3].endswith(".pt.trace.json"), rel
    with open(path) as f:
        assert "aten::matmul" in f.read()
    assert any(e.name == "aten::matmul" for e in prof.events())


def test_trace_inside_a_trace_cannot_start(tmp_path):
    with JP.trace(str(tmp_path / "jax_outer")) as outer:
        with JP.trace(str(tmp_path / "jax_inner")) as inner:
            jnp.ones(3).block_until_ready()
    assert outer and inner is False
    with TP.trace(None) as outer:
        with TP.trace(str(tmp_path / "torch_inner")) as inner:
            torch.ones(4, 4).matmul(torch.ones(4, 4))
    assert outer and inner is False
    assert any(e.name == "aten::matmul" for e in outer.events())
    assert not (tmp_path / "torch_inner").exists()


def test_trace_without_logdir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with TP.trace(None) as prof:
        torch.ones(4).add(1)
    assert any(e.name == "aten::add" for e in prof.events())
    assert list(tmp_path.iterdir()) == []
    assert TP.device_summary(prof, 1.0) == {"busy": 0.0, "kernels": {}}   # no card here


def test_device_memory_stats_empty_without_a_card():
    assert TP.device_memory_stats() == JP.device_memory_stats() == {}


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),                 # overlap
    ([(0, 10), (2, 4), (3, 9)], 10.0),          # nested
    ([(20, 30), (0, 5), (10, 12)], 17.0),       # gaps, out of order
    ([(0, 5), (5, 8), (8, 8)], 8.0),            # touching, empty
    ([(0, 10), (1, 2), (9, 20), (30, 31)], 21.0),
], ids=["empty", "one", "overlap", "nested", "gaps", "touching", "mixed"])
def test_busy_us_is_the_union_length(intervals, want):
    assert TP.busy_us(intervals) == want


def _event(name, start, end, cuda=True):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    tr = types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return types.SimpleNamespace(name=name, device_type=kind, time_range=tr)


def test_device_summary_sums_by_name_and_counts_launches():
    events = [_event("k1", 0, 100), _event("k2", 50, 250), _event("k1", 300, 400),
              _event("k3", 320, 330), _event("k1", 900, 950),
              _event("aten::mm", 0, 1000, cuda=False), _event("cudaLaunchKernel", 5, 6,
                                                               cuda=False)]
    prof = types.SimpleNamespace(events=lambda: events)
    got = TP.device_summary(prof, wall_ms=1.0)
    # union: [0, 250] + [300, 400] + [900, 950] = 400 us of a 1000 us wall
    assert got["busy"] == pytest.approx(0.4, abs=1e-12)
    assert got["kernels"] == {"k1": (0.25, 3), "k2": (0.2, 1), "k3": (0.01, 1)}
    assert list(got["kernels"]) == ["k1", "k2", "k3"]           # by device ms
    only_cpu = types.SimpleNamespace(events=lambda: events[-2:])
    assert TP.device_summary(only_cpu, wall_ms=1.0) == {"busy": 0.0, "kernels": {}}
