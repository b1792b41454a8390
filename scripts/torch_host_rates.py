#!/usr/bin/env python3
"""Warm rates of the port's host-bound Stage-1 paths on one GPU, alone.

    python3 scripts/torch_host_rates.py [--rounds 5] [--seed 0]

Drives the f32 recon batch and the bf16 Stage-1 training step at the
Stage-1 bench batch (4 synthetic frames of 132 residues) through
`chip_smoke.build_recon` / `run_recon` and `build_stage1_trainer` /
`run_stage1_train`, random weights from the seed: one untimed batch and
step first (the kernel build and every first-call cost), then `--rounds`
rounds of one recon batch and three training steps. Prints each reading,
the medians (recon ms a batch, Stage-1 ms a step) and the card's name and
power limit as one JSON line. Both paths are host-bound, so a reading
taken after other work in the same process (as in `chip_smoke.py`) may
differ from one taken here.

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
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_host_rates: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    batch = S.stage1_batch(args.seed, device)
    pipe = S.build_recon(device, args.seed)
    _, state, step = S.build_stage1_trainer(device, args.seed, compute_dtype=torch.bfloat16)
    expect = S.stage1_train_launches()
    S.run_recon(pipe, batch)
    S.run_stage1_train(state, step, batch, 1, expect)
    recon_ms, step_ms = [], []
    for _ in range(args.rounds):
        recon_ms.append(S.run_recon(pipe, batch)["seconds"] * 1e3)
        step_ms += S.run_stage1_train(state, step, batch, 3, expect)[0]
    print(json.dumps({"card": S.gpu_line(), "recon_ms": recon_ms, "stage1_step_ms": step_ms,
                      "recon_ms_median": statistics.median(recon_ms),
                      "stage1_step_ms_median": statistics.median(step_ms)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
