#!/usr/bin/env python3
"""Warm sampling rates of the PyTorch port (codlad_tpu_torch) on one GPU.

    python3 scripts/torch_sampling_rates.py [--draws 9] [--seed 0]
        [--adaln_mode trunk|residual] [--trained] [--flow euler|midpoint|rk4]

Drives the bf16 sampling path through `chip_smoke.build_pipeline` and
`chip_smoke.run_slice` (100 denoise steps and the decode, random weights
from the seed) at the bench shape, B96 L128 K64, and at the L = 48 bucket,
B96 L48 K48: one untimed draw at each shape first (it builds the kernels and
pays every first-call cost), then `--draws` timed draws at each, the two
shapes in turns. Prints each draw's seconds, the median and the best rate
of each shape in denoise steps/s (the host's noise only slows a draw), and
the card's name and power limit, as one JSON line. `--adaln_mode residual`
drives the adaLN residual denoiser (gates open; its encoder's edge chain is
K6) instead of the trunk one (K2). `--trained` drives the converted trained
denoiser and VQ-VAE (`chip_smoke.trained_pipeline`, weights/) on the
convergence study's val proteins instead, their first 96 frames by the
study's recipe: prot_0030 (B96 L64) and prot_0031 (B96 L96), K 64.
`--flow METHOD` drives the flow pipeline instead (`chip_smoke.build_flow_pipeline`:
the same denoiser with C output channels, integrated by METHOD over 100
denoiser evaluations); its rates are solver steps/s.

It imports chip_smoke.py and codlad_tpu_torch from the checkout that holds
it, so two commits compare on one card by running each checkout's copy from
its own root, in turns.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adaln_mode", choices=("trunk", "residual"), default="trunk")
    ap.add_argument("--trained", action="store_true",
                    help="the trained weights on the study's val proteins (trunk adaLN)")
    ap.add_argument("--flow", choices=("euler", "midpoint", "rk4"), default=None,
                    help="a flow draw by this solver, 100 evaluations (random weights)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_sampling_rates: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as S
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device

    device = torch.device("cuda", 0)
    if args.trained:
        from codlad_tpu_torch.data.batch import collate, quantize_spec, spec_for
        from codlad_tpu_torch.data.synthetic import corpus_protein
        args.adaln_mode = "trunk"
        pipe = S.trained_pipeline(device, torch.bfloat16)
        batches = {}
        for i in (30, 31):
            ex = corpus_protein(i, S.B)
            nb = collate(ex, quantize_spec(spec_for(ex)))
            batches[f"l{nb['res_type'].shape[1]}"] = {
                k: torch.as_tensor(v, device=device) for k, v in nb.items()}
    else:
        if args.flow:
            from codlad_tpu_torch.gen.solvers import NFE_PER_STEP
            pipe = S.build_flow_pipeline(device, args.seed, method=args.flow,
                                         steps=100 // NFE_PER_STEP[args.flow],
                                         compute_dtype=torch.bfloat16,
                                         adaln_mode=args.adaln_mode)
        else:
            pipe = S.build_pipeline(device, args.seed, compute_dtype=torch.bfloat16,
                                    adaln_mode=args.adaln_mode)
        batches = {name: to_device(synthetic_cg_batch(b, l, seed=args.seed + i), device)
                   for i, (name, (b, l)) in enumerate((("l128", (S.B, S.L)),
                                                       ("l48", S.K48[:2])))}
    shapes = {name: tuple(b["res_type"].shape) for name, b in batches.items()}
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for batch in batches.values():
        S.run_slice(pipe, batch, gen)
    seconds = {name: [] for name in shapes}
    for _ in range(args.draws):
        for name, batch in batches.items():
            out = S.run_slice(pipe, batch, gen)
            S.check_slice(out, *shapes[name])
            seconds[name].append(out["seconds"])
    steps = pipe.ode_steps if args.flow else pipe.process.num_timesteps
    result = {"card": S.gpu_line(), "adaln_mode": args.adaln_mode, "flow": args.flow,
              "weights": "trained" if args.trained else "random", "steps": steps,
              **{f"{name}_s": s for name, s in seconds.items()},
              **{f"{name}_steps_per_s": steps / statistics.median(s)
                 for name, s in seconds.items()},
              **{f"{name}_best_steps_per_s": steps / min(s) for name, s in seconds.items()}}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
