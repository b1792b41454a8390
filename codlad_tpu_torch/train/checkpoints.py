"""Checkpoints of the Stage-2 train state, in torch's own format.

Counterpart of codlad_tpu/train/checkpoints.py (orbax there): each named
checkpoint (`last`, `best`, `step_N`) is one file `<dir>/<name>.pt` holding
{step, params, ema_params, opt_state}, written to a temporary file and
renamed into place, so a killed save never leaves a half-written `last`.
Nothing here reads orbax.
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

    def save(self, state, name):
        tmp = self.path(name) + f".{os.getpid()}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self.path(name))

    def restore(self, state, name):
        """Load checkpoint `name` into `state` (its tensors keep their device)."""
        sd = torch.load(self.path(name), map_location="cpu", weights_only=True)
        state.load_state_dict(sd)
        return state
