#!/usr/bin/env python3
"""How many of a short window's kernels a `torch.profiler` trace keeps when
the process has not traced for a while, by the way the window is opened,
on one GPU.

    python3 scripts/trace_gap_probe.py [--ticks 25] [--every 15]

Run from a checkout's root. Every `--every` seconds (the gap), one window
traces three sleep kernels of ~2 ms (`torch.cuda._sleep`) and a
synchronise, opened by one of these ways in turn:
  * plain: `profile.start()` (CUPTI enabled and the recording started at
    once), as `torch.profiler.profile` used as a context manager does;
  * warm_0.1 / warm_1: `prepare_trace()` (CUPTI enabled), one tiny kernel
    and a synchronise, 0.1 s or 1 s of host sleep, then `start_trace()`;
  * twice: a throwaway window around one tiny kernel, then plain;
  * module: `codlad_tpu_torch.train.profiling.trace`.
Prints one JSON line a window (the process's age, the way, the kernels
kept of three) and then the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=25)
    ap.add_argument("--every", type=float, default=15.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("trace_gap_probe: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from codlad_tpu_torch.train import profiling
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(1000)
    ev[0].record()
    torch.cuda._sleep(1_000_000)
    ev[1].record()
    torch.cuda.synchronize()
    cycles = int(2.0 / ev[0].elapsed_time(ev[1]) * 1_000_000)     # ~2 ms a kernel

    def work():
        for _ in range(3):
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()

    def tiny():
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def plain():
        prof = profile(activities=acts)
        prof.start()
        work()
        prof.stop()
        return prof

    def warm(pause):
        def way():
            prof = profile(activities=acts)
            prof.prepare_trace()
            tiny()
            time.sleep(pause)
            prof.start_trace()
            work()
            prof.stop()
            return prof
        return way

    def twice():
        prof = profile(activities=acts)
        prof.start()
        tiny()
        prof.stop()
        return plain()

    def module():
        with profiling.trace(None) as prof:
            work()
        return prof

    ways = {"plain": plain, "warm_0.1": warm(0.1), "warm_1": warm(1.0), "twice": twice,
            "module": module}
    names = list(ways)
    t_start = time.perf_counter()
    for i in range(args.ticks):
        time.sleep(max(0.0, t_start + (i + 1) * args.every - time.perf_counter()))
        name = names[i % len(names)]
        prof = ways[name]()
        cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kept = sum(1 for e in cuda if e.time_range.elapsed_us() > 1000)     # the 2 ms kernels
        print(json.dumps({"age_s": round(time.perf_counter() - t_start, 1), "way": name,
                          "kept": kept, "of": 3, "cuda_events": len(cuda)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
