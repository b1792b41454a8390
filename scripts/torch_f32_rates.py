#!/usr/bin/env python3
"""The f32 message chains of the PyTorch port (codlad_tpu_torch) on one GPU.

    python3 scripts/torch_f32_rates.py [--draws 3] [--steps 6] [--seed 0]
                                       [--sections fwd,bwd,draw,train,tp]

Run from a checkout's root: it drives that checkout's kernels through its
`chip_smoke` helpers (copy it into an older checkout to compare the two in
turns, one process each). Prints one JSON line:

* the device ms (CUDA graph replay, `chip_smoke.replay_ms`) of the f32 K1
  (fused_message_sum), K2 (fused_message_edge_lnmod), K6's forward
  (fused_message_edge) and K7 (fused_edge_then_sum) at B96 L128 K64, B96
  L48 K48 and B96 with 64 edge rows against a node table of 128 (N != L),
  each with max|d| against its plain version run in float64;
* the f32 100-step draw (the sampling path of `chip_smoke.build_pipeline`
  with no compute dtype, decode included) at B96 L128 K64: one untimed
  draw, then the median seconds of `--draws` and its denoise steps/s;
* the f32 backwards (section bwd) at the same three shapes: K3
  (`message_sum_bwd`), K4 (`message_edge_lnmod_bwd`), K5's backward with
  seeds and with a keep tensor, and K6's backward (`message_edge_bwd`), and
  K5's forward with seeds and with a keep tensor, each by graph replay, and one
  call of each traced (`profiling.trace`) split into the device ms of every CUDA
  kernel it launched (main pass, weight-grad pass, `sum_partials`);
* the f32 Stage-2 training step (`chip_smoke.build_trainer`) at B96 L128,
  dropout 0.6 and dropout 0, and the adaLN residual denoiser's (gates open,
  dropout 0.6): the median ms of `--steps` steps after one untimed step,
  then one more step at dropout 0.6 (trunk and residual) traced (the
  device ms of each CUDA kernel in it);
* the f32 K10 (section tp, `fused_tp`) and K11 (`fused_tp_bwd`) at the
  Stage-1 bench batch (4 frames of 132 residues, L 192: 65536 directed
  atom edges a frame) at the encoder's three layer signatures, on the atom
  edges and on the dense cross graph [4, 192, 14], and K10 at CGPrior's
  layer-2 call (the batch's directed CG edges): device ms by graph
  replay, max|d| against the plain K10 run in float64 (K10: max|d| / limit
  too, limit atol 2e-4 + rtol 2e-4; K11: max|d| / max|ref| of dx, dsh and
  dw against its float64 autograd), and a sha256 of the outputs' bytes (to
  compare two checkouts' bits); then the f32 Stage-1 training step
  (`chip_smoke.build_stage1_trainer`, the default trainer): the median ms
  of `--steps` steps after one untimed step and one more step traced; and
  the f32 recon batch (`chip_smoke.build_recon`, the
  same batch): the median ms of `--steps` batches after one untimed one
  and one more traced;
* the card's name and power limit.

`--sections` picks the parts to run (fwd: the K1 / K2 / K6 / K7 lines).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sections", default="fwd,bwd,draw,train,tp")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
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
    out = {"checkout": os.getcwd(), "kernels": {}, "backwards": {}}
    for tag, dims, n in (("B96 L128 K64", (96, 128, 64), None),
                         ("B96 L48 K48", (96, 48, 48), None),
                         ("B96 L64 N128 K64", (96, 64, 64), 128)):
        if "bwd" in sections:
            out["backwards"][tag] = _backwards(cs, MK, dims, n, args.seed, dev)
        if "fwd" not in sections:
            continue
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
            "fused_message_edge": (
                lambda: MK.fused_message_edge(*(x[k] for k in e_keys[:9])),
                lambda v: MK.ref_message_edge(*(v[k] for k in e_keys[:9]))),
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

    if "draw" in sections:
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

    if "train" in sections:
        x1, extras = cs.train_batch(96, 128, args.seed + 1, dev)
        for key, p, mode in (("train", cs.P_DROP, "trunk"), ("train_dropout0", 0.0, "trunk"),
                             ("train_residual", cs.P_DROP, "residual")):
            model, state, step = cs.build_trainer(dev, args.seed, dropout=p, adaln_mode=mode,
                                                  gates=mode == "residual")
            expect = cs.train_launches(len(model.enc_layers), len(model.dec_layers), p, mode)
            times, _, _ = cs.run_train(state, step, x1, extras, args.seed, args.steps + 1,
                                       expect)
            out[key] = {"ms": times[1:], "median_ms": statistics.median(times[1:])}
            if p:
                out[key]["traced_kernels_ms"] = _traced(
                    lambda: step(state, x1, extras, args.seed + 99))
            del model, state, step
            torch.cuda.empty_cache()
    if "tp" in sections:
        out["tp"] = _tp(cs, args.seed, args.steps, dev)
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out))
    return 0


def _traced(fn, reps=1):
    """{CUDA kernel name: device ms a call} of `reps` calls of fn in a
    `profiling.trace` window (after one untraced call), largest first."""
    import torch
    from chip_smoke import read_trace
    from codlad_tpu_torch.train import profiling
    fn()
    torch.cuda.synchronize()
    with profiling.trace(None) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {name: ms / reps for name, (ms, _) in read_trace(prof, wall_ms)["kernels"].items()}


def _backwards(cs, MK, dims, n, seed, dev):
    """Device ms (graph replay) of the f32 K3, K4, K5's (seeds, keep) and
    K6's backwards and of K5's forward (seeds, keep) at dims, and each
    call's kernels by device ms (traced)."""
    import torch
    b, l, k = dims
    x = cs.kernel_inputs(torch.float32, seed, dev, dims, n)
    g = torch.Generator().manual_seed(seed + 7)
    ct_sum = torch.randn(b, l, cs.H, generator=g).to(dev) / 30.0
    ct_edge = torch.randn(b, l, k, cs.H, generator=g).to(dev)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=g, dtype=torch.int32).to(dev)
    keep = MK.keep_scales(seeds, (l, k, cs.H), cs.P_DROP)
    base = [x[key] for key in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3")]
    sum_args = [x[key] for key in ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3")]
    edge = base + [x["b3"], x["sc"], x["g"], ct_edge]
    fwd = [x[key] for key in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3", "sh",
                              "sc", "g")]
    calls = {"fused_message_sum_bwd": lambda: MK.message_sum_bwd(*sum_args, ct_sum),
             "fused_message_edge_lnmod_bwd": lambda: MK.message_edge_lnmod_bwd(*edge),
             "fused_message_edge_lnmod_drop_bwd": lambda: MK.message_edge_lnmod_bwd(
                 *edge, seeds=seeds, p=cs.P_DROP),
             "fused_message_edge_lnmod_drop_bwd_keep": lambda: MK.message_edge_lnmod_bwd(
                 *edge, keep=keep),
             "fused_message_edge_bwd": lambda: MK.message_edge_bwd(*base, ct_edge),
             "fused_message_edge_lnmod_drop": lambda: MK.fused_message_edge_lnmod_pdrop(
                 *fwd, seeds, cs.P_DROP),
             "fused_message_edge_lnmod_drop_keep": lambda: MK.fused_message_edge_lnmod_drop(
                 *fwd, keep)}
    res = {}
    for name, call in calls.items():
        (ms,) = cs.replay_ms(call)
        res[name] = {"device_ms": ms, "traced_kernels_ms": _traced(call, reps=3)}
    del x, keep, calls
    torch.cuda.empty_cache()
    return res


def _digest(tensors):
    import hashlib
    return hashlib.sha256(b"".join(t.contiguous().cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()[:16]


def _tp_forward(cs, TK, tb, x, sh, w):
    """Device ms, max|d| against the plain K10 in float64, max|d| / limit
    and the output's hash of one f32 K10 call."""
    import torch
    kern = lambda: TK.fused_tp(x, sh, w, tb)
    got = kern()
    want = TK.ref_fused_tp(x.double(), sh.double(), w.double(), tb["CBIG_R"], tb["EXPW"],
                           tb["SUMR"])
    d = (got.double() - want).abs()
    res = {"max_abs_err": d.max().item(),
           "max_d_over_limit": (d / (2e-4 + 2e-4 * want.abs())).max().item(),
           "sha256": _digest([got])}
    del got, want, d
    (res["device_ms"],) = cs.replay_ms(kern)
    torch.cuda.empty_cache()
    return res


def _tp(cs, seed, steps, dev):
    """The f32 K10 and K11 at the Stage-1 bench batch (device ms, accuracy,
    a hash of their outputs), K10 at CGPrior's layer-2 call, then the f32
    Stage-1 training step and the f32 recon batch (ms, traced)."""
    import torch
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.graph import make_directed_batched
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables
    batch = cs.stage1_batch(seed, dev)
    nb, nl = batch["res_type"].shape
    edges, _ = make_directed_batched(batch["atom_edges"], batch["atom_edges_mask"])
    cg_edges, _ = make_directed_batched(batch["cg_edges"], batch["cg_edges_mask"])
    ladder = irrep_ladder(12, 4)
    g = torch.Generator().manual_seed(seed + 13)
    res = {}
    for layer in range(3):
        tb = fused_tp_tables(tuple(ladder[layer]), tuple(SH_IRREPS), tuple(ladder[layer + 1]))
        din, numel, dout = ladder[layer].dim, tb["numel"], tb["SUMR"].shape[1]
        shapes = [("edges", (nb, edges.shape[1])), ("cross", (nb, nl, 14))]
        if layer == 2:
            shapes.append(("CG", (nb, cg_edges.shape[1])))
        for where, lead in shapes:
            x = torch.randn(*lead, din, generator=g).to(dev)
            sh = sh_l2(torch.randn(*lead, 3, generator=g)).to(dev)
            w = (torch.randn(*lead, numel, generator=g) * din ** -0.5).to(dev)
            ct = torch.randn(*lead, dout, generator=g).to(dev)
            tag = f"layer {layer} {where} {tuple(lead)}"
            res[f"fwd {tag}"] = _tp_forward(cs, TK, tb, x, sh, w)
            if where == "CG":
                continue
            kern = lambda: TK.fused_tp_bwd(x, sh, w, ct, tb)
            got = kern()
            leaves = [t.double().requires_grad_(True) for t in (x, sh, w)]
            want = torch.autograd.grad(TK.ref_fused_tp(*leaves, tb["CBIG_R"], tb["EXPW"],
                                                       tb["SUMR"]), leaves, ct.double())
            err = {n: (a.double() - b).abs().max().item() / b.abs().max().item()
                   for n, a, b in zip(("dx", "dsh", "dw"), got, want)}
            digest = _digest(got)
            del got, want, leaves
            (ms,) = cs.replay_ms(kern)
            res[tag] = {"device_ms": ms, "max_d_over_max_ref": err, "sha256": digest}
            del x, sh, w, ct
            torch.cuda.empty_cache()
    _, state, step = cs.build_stage1_trainer(dev, seed)
    weights = cs.stage1_weights()
    times = []
    for _ in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch, weights)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    holder = [state]

    def one():
        holder[0], _ = step(holder[0], batch, weights)

    res["train_stage1_f32"] = {"ms": times[1:], "median_ms": statistics.median(times[1:]),
                               "traced_kernels_ms": _traced(one)}
    del state, step, holder
    torch.cuda.empty_cache()
    pipe = cs.build_recon(dev, seed)
    times = [cs.run_recon(pipe, batch)["seconds"] * 1e3 for _ in range(steps + 1)]
    res["recon_f32"] = {"ms": times[1:], "median_ms": statistics.median(times[1:]),
                        "traced_kernels_ms": _traced(lambda: cs.run_recon(pipe, batch))}
    return res


def _batch(n_frames, n_res, seed, device):
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    return to_device(synthetic_cg_batch(n_frames, n_res, seed=seed), device)


if __name__ == "__main__":
    sys.exit(main())
