#!/usr/bin/env python3
"""How far the f32 K6 backward's grads lie from float64, on the card or in a model.

    python3 scripts/torch_f32_bwd_accuracy.py                # on a GPU
    JAX_PLATFORMS=cpu python3 scripts/torch_f32_bwd_accuracy.py --model rz

Run from a checkout's root. The inputs are those of
tests/test_torch_cuda.py::test_message_edge_kernels_match_plain at B3 L64
N64 K64 (12288 edge rows); the reference is autograd of `ref_message_edge`
in float64. For each grad it prints max|d| and the worst ratio of |d| to
that test's f32 limit, 2e-4 + 2e-4 |ref|:

* on the card: the kernel (`fused_message_edge`'s backward) and autograd of
  the plain version in f32 (cuBLAS sums), one JSON line;
* with --model (on the CPU): the torch emulation of the kernel's loops
  (tests/test_torch_chain_bwd_tiles_f32.py `emulate_edge_bwd`, which
  imports the JAX package's tests' helpers) with each 3xTF32 k8 step's
  sums taken as `rn` (round to nearest, as the tests take them), `rz` (each
  mma's sum of its products and the running accumulator truncated toward
  zero, a model of the tensor core's adder) or `fresh` (`rz` with the three
  products summed from zero and then added in f32, `mma3_rn`'s order); the
  weight-grad pass keeps `rz`, its stages sum from zero already.
"""

import argparse
import json
import os
import subprocess
import sys

H = 128
NAMES = ("A", "E", "Gn", "W_e", "W2", "b2", "W3", "b3")
KEYS = ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3")


def inputs():
    """The card test's operands and cotangent, made on the CPU."""
    import torch
    g = torch.Generator().manual_seed(5)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g) * sc
    B, L, N, K = 3, 64, 64, 64
    x = dict(A=r(B, L, H), E=r(B, L, K, H), Gn=r(B, N, H),
             idx=torch.randint(0, N, (B, L, K), generator=g),
             mask=(torch.rand(B, L, K, generator=g) > 0.3).float(),
             W_e=r(H, H, sc=H ** -0.5), W2=r(H, H, sc=H ** -0.5), b2=r(H, sc=0.1),
             W3=r(H, H, sc=H ** -0.5), b3=r(H, sc=0.1))
    ct = torch.randn(B, L, K, H, generator=torch.Generator().manual_seed(6))
    return x, ct


def grads(fn, x, ct):
    import torch
    leaves = {k: x[k].detach().clone().requires_grad_(k in NAMES) for k in KEYS}
    out = fn(*(leaves[k] for k in KEYS))
    return dict(zip(NAMES, torch.autograd.grad(out, [leaves[k] for k in NAMES], ct)))


def ratios(got, want):
    """{name: (max|d|, worst |d| / (2e-4 + 2e-4 |ref|))} against float64."""
    out = {}
    for n, w in want.items():
        d = (got[n].double().reshape(w.shape).to(w.device) - w).abs()
        out[n] = (d.max().item(), (d / (2e-4 + 2e-4 * w.abs())).max().item())
    return out


def model(kind):
    """The emulated kernel's grads with kind's sums (module note)."""
    import torch
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import test_torch_chain_bwd_tiles_f32 as T1
    import test_torch_chain_tiles_f32 as T
    f32 = torch.float32

    def rz(v):
        f = v.to(f32)
        return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)

    mode = [kind]

    def mma3(a, b, acc=None, single=False):
        (ah, al), (bh, bl) = T.split(a), T.split(b)
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=f32) if acc is None else acc
        for kk in range(a.shape[1] // 8):
            s = slice(8 * kk, 8 * kk + 8)
            prods = [al[:, s].double() @ bh[s].double(), ah[:, s].double() @ bl[s].double(),
                     ah[:, s].double() @ bh[s].double()]
            if mode[0] == "rn":
                for p in prods:
                    acc = (acc.double() + p).to(f32)
            elif mode[0] == "rz":
                for p in prods:
                    acc = rz(acc.double() + p)
            else:
                t = torch.zeros_like(acc)
                for p in prods:
                    t = rz(t.double() + p)
                acc = acc + t
        return acc

    wgrad = T1.wgrad

    def wgrad_rz(X, Y, single=False):
        keep, mode[0] = mode[0], "rz" if kind != "rn" else "rn"
        try:
            return wgrad(X, Y, single)
        finally:
            mode[0] = keep

    T1.mma3, T.mma3, T1.wgrad = mma3, mma3, wgrad_rz
    x, ct = inputs()
    got = T1.emulate_edge_bwd(*(x[k] for k in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3")),
                              ct)
    return dict(zip(NAMES, got))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("rn", "rz", "fresh"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    x, ct = inputs()
    f64 = {k: v.double() if v.is_floating_point() else v for k, v in x.items()}
    want = grads(MK.ref_message_edge, f64, ct.double())
    if args.model:
        out = {"model": args.model, "ratios": ratios(model(args.model), want)}
    else:
        if not torch.cuda.is_available():
            print("torch_f32_bwd_accuracy: no CUDA device (or pass --model)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        xd = {k: v.to(dev) for k, v in x.items()}
        out = {"kernel": ratios(grads(MK.fused_message_edge, xd, ct.to(dev)), want),
               "f32_autograd": ratios(grads(MK.ref_message_edge, xd, ct.to(dev)), want),
               "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                       "--format=csv,noheader"], capture_output=True,
                                      text=True).stdout.strip()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
