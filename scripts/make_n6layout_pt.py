"""Write the trained VQ-VAE of the convergence study in the reference's N6
key layout, so that the port's checkpoint importer can be driven end to end
on a file in the repository.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/make_n6layout_pt.py \
        [--weights weights/convergence_vqvae.npz] \
        [--out weights/convergence_vqvae_n6layout.pt]

The state dict is the inverse of codlad_tpu/convert/torch_import.convert_vae
(`_synthesize_n6_state_dict` of tests/test_convert.py: module names of the
reference's vae_model.py:686-707, the e3nn per-path corrections undone, the
codebook buffers under `quantize._codebook.*` with a group axis), with every
key under DDP's `module.` prefix and one obsolete `dist_filter` key, the
surgery the importer must undo. Tensors are stored in float32, as the
reference trains. Runs on the CPU with JAX in a few seconds; the port never
imports it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", default=os.path.join(ROOT, "weights", "convergence_vqvae.npz"))
    ap.add_argument("--out", default=os.path.join(ROOT, "weights",
                                                  "convergence_vqvae_n6layout.pt"))
    args = ap.parse_args(argv)

    import torch

    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from codlad_tpu_torch.convert.from_flax import read_flax_npz
    from test_convert import _synthesize_n6_state_dict

    w = read_flax_npz(args.weights)
    vq = {k: np.asarray(w[k], np.float32) for k in ("codebook", "embed_avg", "cluster_size")}
    sd = _synthesize_n6_state_dict({"params": w["params"]}, vq,
                                   num_conv=w["config"].get("dec_nconv", 4))
    sd = {k: (v.to(torch.float32) if v.is_floating_point() else v).contiguous()
          for k, v in sd.items()}
    torch.save(sd, args.out)
    print(f"wrote {args.out}: {len(sd)} tensors, {os.path.getsize(args.out):,} bytes")


if __name__ == "__main__":
    main()
