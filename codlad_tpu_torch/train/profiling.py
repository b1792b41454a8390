"""Tracing and profiling: named wall-clock phases, a `torch.profiler`
window, and per-device memory.

Counterpart of codlad_tpu/train/profiling.py, under its names and
contracts:
  * `PhaseTimer` — named wall-clock phases with running totals; `report()`
    gives each phase's total, mean ms and share of all phases;
  * `trace` — context manager around `torch.profiler` that writes a Chrome
    trace under `logdir` (no file with `logdir=None`) and yields the
    started profiler, or False where it is off or could not start;
  * `device_memory_stats` — per-device live, peak and limit bytes.
Plus two plain functions on a finished trace: `busy_us` (the length of a
union of intervals) and `device_summary` (the device's busy share of a
window and its kernels by name).
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import time

import torch


def _cuda_devices(tree, found):
    """Add to the set `found` the device of every CUDA tensor in a tensor
    or a nested dict / list / tuple of them."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def block_until_ready(tree):
    """Wait for the work queued on the current stream of each distinct CUDA
    device that holds a tensor of `tree` (a tensor or a nested dict / list
    / tuple of them, as `jax.block_until_ready` takes a pytree); CPU tensors
    need no wait. Returns `tree`."""
    for d in _cuda_devices(tree, set()):
        torch.cuda.current_stream(d).synchronize()
    return tree


class PhaseTimer:
    """Accumulates wall-clock per named phase; report() gives totals and
    share-of-total percentages."""

    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name, block_on=None):
        """Time the block as one run of phase `name`, also when it raises.
        With `block_on` (tensors, as `block_until_ready` takes them), the
        clock is read after their devices' queued work is done."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self):
        total = sum(self.totals.values()) or 1.0
        return {
            name: {
                "total_sec": round(t, 4),
                "mean_ms": round(t / max(self.counts[name], 1) * 1e3, 3),
                "share_pct": round(t / total * 100, 2),
            }
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(logdir, enabled=True):
    """A `torch.profiler.profile` window over the block: CPU activity, and
    CUDA activity where a card is present. Yields the started profiler (its
    `events()` are read after the block), or False when `enabled` is False
    or the profiler cannot start (another one is running on this thread);
    then nothing is traced or written. On exit, with a `logdir`, the Chrome
    trace goes to
    `<logdir>/plugins/profile/<YYYY_MM_DD_HH_MM_SS>/<host>.pt.trace.json`,
    the layout `jax.profiler` writes; with `logdir=None` no file. The card's
    kernels are CUPTI's records: a short window late in a long process can
    lose some or all of them (scripts/trace_window_probe.py,
    scripts/trace_gap_probe.py), so read a window's kernels against what
    it launched."""
    # a second profiler would start without an error and end the first's
    # session, so one already running counts as "cannot start"
    prof = None
    if enabled and not torch.autograd._profiler_enabled():
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        try:
            prof.start()
        except RuntimeError:
            prof = None
    if prof is None:
        yield False
        return
    try:
        yield prof
    finally:
        prof.stop()
        if logdir is not None:
            run = os.path.join(logdir, "plugins", "profile", time.strftime("%Y_%m_%d_%H_%M_%S"))
            os.makedirs(run, exist_ok=True)
            prof.export_chrome_trace(os.path.join(run, f"{socket.gethostname()}.pt.trace.json"))


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_summary(prof, wall_ms):
    """The CUDA events of a finished `trace` window: {"busy": the share of
    `wall_ms` during which a kernel ran (the union of their intervals),
    "kernels": {name: (device ms, launches)}, largest first}. Both are
    empty readings ({} and 0.0) where the window holds no CUDA event."""
    kernels, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us, n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        spans.append((e.time_range.start, e.time_range.end))
    return {"busy": busy_us(spans) / (wall_ms * 1e3) if spans else 0.0,
            "kernels": {name: (us / 1e3, n) for name, (us, n)
                        in sorted(kernels.items(), key=lambda kv: -kv[1][0])}}


def device_memory_stats():
    """{str(device): {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}
    for each CUDA device: the caching allocator's current and peak
    allocated bytes (peak since `torch.cuda.reset_peak_memory_stats`) and
    the device's total memory; {} without CUDA."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        stats = torch.cuda.memory_stats(d)
        out[str(d)] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(d).total_memory,
        }
    return out
