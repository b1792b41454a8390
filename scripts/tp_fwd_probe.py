#!/usr/bin/env python3
"""Where the f32 K10's time goes, on one GPU: the kernel with parts of its
tile loop cut out or its design choices changed, each variant built by nvcc
from an edited copy of codlad_tpu_torch/csrc/fused_tp.cu, timed by CUDA
graph replay.

    python3 scripts/tp_fwd_probe.py [--seed 0]

Run from a checkout's root. Variants: `full` (the kernel as it is),
`nocols` (no output column computed: the table copy, the staging, the
barriers and the stores alone), `onex` (each nonzero reads one operand,
x[rf], and forms no product: the cost of a walk over a prebuilt xcat,
without building it), `unroll2` (the walk's loop unrolled twice) and
`rt1` (one row a lane, 32-row tiles, where the kernel takes two). Each
runs at the Stage-1 bench batch (4 frames of 132 residues, 65536 directed
atom edges a frame) at the encoder's three layer signatures. Prints one JSON line: device ms by variant and layer, the
worst |d| / limit against the plain K10 in float64 (limit atol 2e-4 + rtol
2e-4) of every variant but `nocols` and `onex`, the registers that ptxas
reports and the card's name and power limit. `nocols` and `onex` compute
wrong outputs by design and are not checked.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

CUTS = {
    "full": [],
    "nocols": [("for (int u = sc[warp]; u < sc[warp + 1]; ++u) {",
                "for (int u = sc[warp]; u < sc[warp]; ++u) {")],
    "onex": [("fmaf(cf, __fmul_rn(xp[32 * r], hp[32 * r]), tr[r])", "fmaf(cf, xp[32 * r], tr[r])")],
    "unroll2": [("      uint2 e = ez[z];\n      for (; z < ze; ++z) {",
                 "      uint2 e = ez[z];\n#pragma unroll 2\n      for (; z < ze; ++z) {")],
    "rt1": [("  if (two <= cap) return f32k::launch<2>(a, two, st);\n", "")],
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("tp_fwd_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from codlad_tpu_torch.kernels import build
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.graph import make_directed_batched
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

    src = (build.CSRC / "fused_tp.cu").read_text()
    out_dir = str(build.BUILD_DIR / "tp_fwd_probe")     # git-ignored, as the kernels' builds
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               os.path.join(out_dir, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns, regs = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"fused_tp_f32_kernelILi(\d)E", line)
            if m and "Compiling entry" in line:
                used = next(x for x in lines[i:] if "Used" in x)
                regs[f"{name} RT {m.group(1)}"] = used.strip()
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")), "fused_tp_f32")
        fn.restype = ctypes.c_int
        fn.argtypes = TK._ARGTYPES["fused_tp_f32"] + [ctypes.c_void_p]
        fns[name] = fn

    dev = torch.device("cuda", 0)
    batch = cs.stage1_batch(args.seed, dev)
    edges, _ = make_directed_batched(batch["atom_edges"], batch["atom_edges_mask"])
    lead = (batch["res_type"].shape[0], edges.shape[1])
    ladder = irrep_ladder(12, 4)
    g = torch.Generator().manual_seed(args.seed + 13)
    out = {"device_ms": {}, "worst_over_limit": {}, "registers": regs}
    for layer in range(3):
        tb = fused_tp_tables(tuple(ladder[layer]), tuple(SH_IRREPS), tuple(ladder[layer + 1]))
        din, numel, dout = ladder[layer].dim, tb["numel"], tb["SUMR"].shape[1]
        x = torch.randn(*lead, din, generator=g).to(dev)
        sh = sh_l2(torch.randn(*lead, 3, generator=g)).to(dev)
        w = (torch.randn(*lead, numel, generator=g) * din ** -0.5).to(dev)
        ft = TK._device_tables(tb, dev, torch.float32)["f32_fwd"]
        o = torch.empty(*lead, dout, device=dev)
        rows = x.numel() // din
        want = TK.ref_fused_tp(x.double(), sh.double(), w.double(), tb["CBIG_R"], tb["EXPW"],
                               tb["SUMR"])
        times = {}
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                rc = fn(x.data_ptr(), sh.data_ptr(), w.data_ptr(), ft["blob"].data_ptr(),
                        o.data_ptr(), rows, din, 9, numel, dout,
                        *(ft[k] for k in ("bytes", "q", "cp", "sc")),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name}: cudaError {rc}")
            if name not in ("nocols", "onex"):
                call()
                torch.cuda.synchronize()
                out["worst_over_limit"][f"{name} layer {layer}"] = (
                    (o.double() - want).abs() / (2e-4 + 2e-4 * want.abs())).max().item()
            (times[name],) = cs.replay_ms(call)
        out["device_ms"][f"layer {layer} {lead}"] = times
        del x, sh, w, o, want
        torch.cuda.empty_cache()
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
