"""Convert a reference (PyTorch) checkpoint into a logdir of the port.

Twin of codlad_tpu/cli/import_checkpoint.py:

  # GenZProt (C2):
  python -m codlad_tpu_torch.cli.import_checkpoint \
      --torch_ckpt /path/to/model.pt --kind genzprot --out results/c2_imported

  # VQ-VAE (N6 / K3 / K4): a checkpoint DIRECTORY is resolved by the
  # reference's model number (model_module.py:111-116):
  #   --modelnum -1  -> model.pt          (default)
  #   --modelnum 999 -> best_model.pt
  #   --modelnum N   -> model_N.pt
  python -m codlad_tpu_torch.cli.import_checkpoint \
      --torch_ckpt results/Vae_vqvaeangle_PDB_ns36_vq3_vq4096 --modelnum 999 \
      --kind vqvae --out results/k3_imported

The output is a logdir as the port's cli.train_vqvae writes one
(`config.json` and `last.pt`, a train/state.TrainState saved by
train/checkpoints.CheckpointManager), which `cli.test --vae_ckpt`,
`cli.extract_features --ckpt` and `cli.train_latent` read as they are. The
K3 / K4 IC_Decoder_angle layout is detected from the state dict
(convert/torch_import.is_angle_layout) and recorded as `predict_angle`.
The conversion runs on the host (numpy and torch.load) and needs neither
JAX nor a card; the weights are checked against the port's model by name
and shape as they load.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def resolve_ckpt_file(path, modelnum=-1):
    """The reference's checkpoint-file choice (model_module.py:111-116): a
    directory resolves to model.pt / best_model.pt / model_{n}.pt by
    modelnum; a file path is used as it is."""
    if not os.path.isdir(path):
        return path
    name = ("model.pt" if modelnum == -1 else "best_model.pt" if modelnum == 999
            else f"model_{modelnum}.pt")
    return os.path.join(path, name)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--torch_ckpt", type=str, required=True,
                   help="a .pt file, or a reference run directory (resolved via --modelnum)")
    p.add_argument("--kind", type=str, default="genzprot", choices=["genzprot", "vqvae"])
    p.add_argument("--modelnum", type=int, default=-1,
                   help="-1=model.pt, 999=best_model.pt, N=model_N.pt "
                        "(reference model_module.py:111-116)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--dec_nconv", type=int, default=4)
    p.add_argument("--embed_dim", type=int, default=36)
    p.add_argument("--vqdim", type=int, default=3,
                   help="N6/K3/K4 all ship vqdim 3 (model_module.py:42)")
    p.add_argument("--codebook_size", type=int, default=4096)
    args = p.parse_args(argv)

    import torch

    from codlad_tpu_torch.cli.test import _vae_from_config
    from codlad_tpu_torch.convert import torch_import as TI
    from codlad_tpu_torch.convert.from_flax import load_flax
    from codlad_tpu_torch.models.vq import VQState
    from codlad_tpu_torch.train.checkpoints import CheckpointManager
    from codlad_tpu_torch.train.state import TrainState

    ckpt_file = resolve_ckpt_file(args.torch_ckpt, args.modelnum)
    vq_state = None
    if args.kind == "genzprot":
        params = TI.convert_genzprot(ckpt_file, num_conv=args.dec_nconv)
        extra_cfg = {"train_section": "ivae"}
    else:
        sd = TI.load_reference_state_dict(ckpt_file)
        predict_angle = TI.is_angle_layout(sd)
        params, vq = TI.convert_vae(sd, num_conv=args.dec_nconv, embed_dim=args.embed_dim,
                                    vqdim=args.vqdim)
        if vq is not None:
            vq_state = VQState(**{k: torch.as_tensor(np.asarray(v, np.float32))
                                  for k, v in vq.items()})
            if vq["codebook"].shape[0] != args.codebook_size:
                print(f"note: checkpoint codebook has {vq['codebook'].shape[0]} codes "
                      f"(--codebook_size {args.codebook_size} overridden)")
                args.codebook_size = int(vq["codebook"].shape[0])
        extra_cfg = {"train_section": "vqvae", "vqdim": args.vqdim,
                     "codebook_size": args.codebook_size, "quantize_type": "vqvae",
                     "predict_angle": bool(predict_angle)}
        print(f"decoder layout: "
              f"{'IC_Decoder_angle (K3/K4)' if predict_angle else 'IC_Decoder (N6)'}")

    n = sum(int(np.prod(v.shape)) for v in _leaves(params["params"]))
    print(f"imported {n:,} parameters from {ckpt_file}")

    cfg = {"embed_dim": args.embed_dim, "n_rbf": 15, "cg_cutoff": 21.0, "atom_cutoff": 9.0,
           "enc_nconv": 3, "dec_nconv": args.dec_nconv, "imported_from": ckpt_file,
           **extra_cfg}
    model = load_flax(_vae_from_config(cfg), params)
    state = TrainState(dict(model.named_parameters()), lambda step: np.float32(0.0),
                       ema=False, vq_state=vq_state)
    ckpt = CheckpointManager(args.out)
    ckpt.save_config(cfg)
    ckpt.save(state, "last")
    print(f"wrote {ckpt.path('last')}")


if __name__ == "__main__":
    main()
