"""Checkpoints of a train state, in torch's own format.

Counterpart of codlad_tpu/train/checkpoints.py (orbax there): each named
checkpoint (`last`, `best`, `step_N`, `epoch_N`) is one file
`<dir>/<name>.pt` holding {step, params, ema_params, opt_state,
learning_rate, vq_state}, written to a temporary file and renamed into
place, so a killed save never leaves a half-written `last`. Nothing here
reads orbax.
"""

from __future__ import annotations

import json
import os

import torch


class CheckpointManager:
    def __init__(self, directory):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def path(self, name):
        return os.path.join(self.directory, f"{name}.pt")

    def save_config(self, config):
        with open(os.path.join(self.directory, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)

    def load_config(self):
        with open(os.path.join(self.directory, "config.json")) as f:
            return json.load(f)

    def save(self, state, name):
        tmp = self.path(name) + f".{os.getpid()}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self.path(name))

    def restore(self, state, name, load_opt=True):
        """Load checkpoint `name` into `state` (its tensors keep their
        device). load_opt=False loads the params and the EMA only and leaves
        the step and the optimizer as they are (a warm start)."""
        sd = torch.load(self.path(name), map_location="cpu", weights_only=True)
        if load_opt:
            state.load_state_dict(sd)
            return state
        with torch.no_grad():
            for tree in ("params", "ema_params"):
                for k, v in (getattr(state, tree) or {}).items():
                    v.copy_(sd[tree][k])
        return state

    def exists(self, name):
        return os.path.isfile(self.path(name))

    def available_snapshots(self, prefix):
        """Sorted N of the saved '<prefix>_N' checkpoints."""
        out = set()
        for f in os.listdir(self.directory):
            stem, ext = os.path.splitext(f)
            if ext == ".pt" and stem.startswith(prefix + "_") and stem[len(prefix) + 1:].isdigit():
                out.add(int(stem[len(prefix) + 1:]))
        return sorted(out)

    def best_resume_name(self, snapshot_prefix):
        """The checkpoint a resumed run restores: 'last' if saved, else the
        newest '<snapshot_prefix>_N', else 'best', else None."""
        names = (["last"] + [f"{snapshot_prefix}_{n}" for n in
                             reversed(self.available_snapshots(snapshot_prefix))] + ["best"])
        return next((n for n in names if self.exists(n)), None)
