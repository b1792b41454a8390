#!/usr/bin/env python3
"""When a short `profiling.trace` window starts to lose the card's kernels
in a long process, on one GPU.

    python3 scripts/trace_window_probe.py [--seed 0] [--repeats 40]

Run from a checkout's root: it drives that checkout's kernels and
`chip_smoke` phases. The check is `chip_smoke.kernel_split`'s window: K3
(`message_sum_bwd`) at the sequence-sharded shape (B96, 64 rows, a node
table of 128, K64) in f32 and bf16, one untraced call, then three calls in
a window opened three ways: `profiling.trace` (module); `prepare_trace()`,
a tiny kernel, 0.1 s, then `start_trace()` (warm); a throwaway
`profiling.trace` around a tiny kernel, then the module's (twice). It
reports the window's CUDA events by name (count) against the first
check's, and the process's Python threads. The check runs once
fresh, `--repeats` times in a row (many short sessions), then after each
of `chip_smoke.py`'s phase functions in their order (train_stage2_full,
guided_sampling, stage1_variants, flows, distill). Prints one JSON line a
check and then the card's name and power limit.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=40)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("trace_window_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from codlad_tpu_torch.kernels import build
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    from codlad_tpu_torch.train import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    build.timed_build()
    dev = torch.device("cuda", 0)
    dims = (cs.B, cs.SEQ_ROWS, cs.K)
    calls = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = cs.kernel_inputs(dtype, args.seed, dev, dims, cs.L)
        g = torch.Generator().manual_seed(args.seed + 7)
        dout = torch.randn(dims[0], dims[1], cs.H, generator=g).to(dev) / 30.0
        sum_args = [x[k] for k in ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3")]
        calls[str(dtype).split(".")[-1]] = (lambda a=sum_args, d=dout: MK.message_sum_bwd(*a, d))
    first = {}

    def module(call):
        with profiling.trace(None) as prof:
            for _ in range(3):
                call()
        return prof

    def warm(call):
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.prepare_trace()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.1)
        prof.start_trace()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        prof.stop()
        return prof

    def twice(call):
        with profiling.trace(None):
            torch.cuda._sleep(1000)
        return module(call)

    def check(tag):
        for way, window in (("module", module), ("warm", warm), ("twice", twice)):
            for dname, call in calls.items():
                call()
                torch.cuda.synchronize()
                prof = window(call)
                kernels = profiling.device_summary(prof, 1.0)["kernels"] if prof else {}
                got = {n.replace("(anonymous namespace)::", "").replace("void ", "")[:70]: c
                       for n, (ms, c) in kernels.items() if "spin" not in n}
                first.setdefault(dname, got)
                lost = {k: c - got.get(k, 0) for k, c in first[dname].items()
                        if got.get(k, 0) != c}
                print(json.dumps({"tag": tag, "way": way,
                                  "age_s": round(time.perf_counter() - t_start, 1),
                                  "dtype": dname, "started": bool(prof),
                                  "events": sum(got.values()),
                                  "fresh_events": sum(first[dname].values()), "lost": lost,
                                  "threads": threading.active_count()}), flush=True)

    check("fresh")
    for i in range(args.repeats):
        check(f"repeat {i + 1}")
    timer = profiling.PhaseTimer()
    records = collections.defaultdict(dict)
    card = cs.gpu_line()
    for name, phase in (("train_stage2_full", cs.phase_train_stage2_full),
                        ("guided_sampling", cs.phase_guided_sampling),
                        ("stage1_variants", cs.phase_stage1_variants),
                        ("flows", cs.phase_flows),
                        ("distill", cs.phase_distill)):
        phase(args.seed, dev, records, card, timer)
        check(f"after {name}")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
