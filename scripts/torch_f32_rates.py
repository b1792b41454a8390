#!/usr/bin/env python3
"""The f32 message chains of the PyTorch port (codlad_tpu_torch) on one GPU.

    python3 scripts/torch_f32_rates.py [--draws 3] [--steps 6] [--seed 0]

Run from a checkout's root: it drives that checkout's kernels through its
`chip_smoke` helpers (copy it into an older checkout to compare the two in
turns, one process each). Prints one JSON line:

* the device ms (CUDA graph replay, `chip_smoke.replay_ms`) of the f32 K1
  (fused_message_sum), K2 (fused_message_edge_lnmod) and K7
  (fused_edge_then_sum) at B96 L128 K64, B96 L48 K48 and B96 with 64 edge
  rows against a node table of 128 (N != L), each with max|d| against its
  plain version run in float64;
* the f32 100-step draw (the sampling path of `chip_smoke.build_pipeline`
  with no compute dtype, decode included) at B96 L128 K64: one untimed
  draw, then the median seconds of `--draws` and its denoise steps/s;
* the f32 Stage-2 training step (`chip_smoke.build_trainer`, dropout 0.6)
  at B96 L128: the median ms of `--steps` steps after one untimed step;
* the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("torch_f32_rates: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from codlad_tpu_torch.kernels import build
    from codlad_tpu_torch.kernels import mpnn_kernels as MK

    torch.backends.cuda.matmul.allow_tf32 = False
    build.timed_build()
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    out = {"checkout": os.getcwd(), "kernels": {}}
    for tag, dims, n in (("B96 L128 K64", (96, 128, 64), None),
                         ("B96 L48 K48", (96, 48, 48), None),
                         ("B96 L64 N128 K64", (96, 64, 64), 128)):
        x = cs.kernel_inputs(f32, args.seed, dev, dims, n)
        y = cs.kernel_inputs(f32, args.seed + 1, dev, dims, n)
        s_keys = ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3", "b3")
        e_keys = ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3", "sh", "sc", "g")
        k7 = ([x[k] for k in e_keys] + [y["A"], y["Gn"]]
              + [y[k] for k in ("W_e", "W2", "b2", "W3", "b3")] + [x["mask"], 30.0])
        calls = {
            "fused_message_sum": (lambda: MK.fused_message_sum(*(x[k] for k in s_keys), 30.0),
                                  lambda v: MK.ref_message_sum(*(v[k] for k in s_keys), 30.0)),
            "fused_message_edge_lnmod": (
                lambda: MK.fused_message_edge_lnmod(*(x[k] for k in e_keys)),
                lambda v: MK.ref_message_edge_lnmod(*(v[k] for k in e_keys))),
            "fused_edge_then_sum": (lambda: MK.fused_edge_then_sum(*k7), None),
        }
        res = {}
        for name, (kern, plain) in calls.items():
            got = kern()
            if plain is not None:
                want = plain(cs.as_f64(x))
            else:
                got = torch.cat([t.reshape(-1) for t in got])
                xd, yd = cs.as_f64(x), cs.as_f64(y)
                a = ([xd[k] for k in e_keys] + [yd["A"], yd["Gn"]]
                     + [yd[k] for k in ("W_e", "W2", "b2", "W3", "b3")] + [xd["mask"], 30.0])
                want = torch.cat([t.reshape(-1) for t in MK.ref_edge_then_sum(*a)])
            torch.cuda.synchronize()
            err = (got.double() - want).abs().max().item()
            del got, want
            (ms,) = cs.replay_ms(kern)
            res[name] = {"device_ms": ms, "max_abs_err": err}
        out["kernels"][tag] = res
        del x, y, k7, calls
        torch.cuda.empty_cache()

    batch = _batch(96, 128, args.seed, dev)
    pipe = cs.build_pipeline(dev, args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cs.run_slice(pipe, batch, gen)
    secs = [cs.run_slice(pipe, batch, gen)["seconds"] for _ in range(args.draws)]
    steps = pipe.process.num_timesteps
    out["draw"] = {"seconds": secs, "median_s": statistics.median(secs),
                   "steps_per_s": steps / statistics.median(secs)}
    del pipe
    torch.cuda.empty_cache()

    x1, extras = cs.train_batch(96, 128, args.seed + 1, dev)
    model, state, step = cs.build_trainer(dev, args.seed)
    expect = cs.train_launches(len(model.enc_layers), len(model.dec_layers), cs.P_DROP)
    times, _, _ = cs.run_train(state, step, x1, extras, args.seed, args.steps + 1, expect)
    out["train"] = {"ms": times[1:], "median_ms": statistics.median(times[1:])}
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out))
    return 0


def _batch(n_frames, n_res, seed, device):
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    return to_device(synthetic_cg_batch(n_frames, n_res, seed=seed), device)


if __name__ == "__main__":
    sys.exit(main())
