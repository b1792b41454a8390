#!/usr/bin/env python3
"""Smoke run of the PyTorch port (codlad_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its seconds:
  1. build   -- compile csrc/*.cu with plain nvcc (one process per source);
                each kernel's name, registers, static shared memory and
                spills from `-Xptxas -v`;
  2. kernels -- K1 (fused_message_sum; bf16 on the tensor cores,
                message_sum_mma_kernel; f32 on them in 3xTF32,
                message_sum_f32_mma_kernel) and K2 (fused_message_edge_lnmod;
                bf16 on the tensor cores, message_edge_lnmod_mma_kernel; f32
                message_edge_lnmod_f32_mma_kernel) at the bench shape (B96
                L128 K64 H128) and at B96 L48 K48, bf16 and f32, against
                their plain PyTorch versions on the same inputs, timed with
                CUDA events and by CUDA graph replay beside their bound; then
                the backwards K3 (bf16 on the tensor cores,
                message_sum_bwd_mma_kernel; every bf16 weight-grad pass,
                wgrad_mma_kernel) and K4 and the dropout kernel K5 (forward
                and backward; bf16 K4 and K5's backward on the tensor cores,
                message_edge_lnmod_bwd_mma_kernel; the bf16 K5 forward on
                K2's tensor-core kernel, message_edge_lnmod_mma_kernel at
                DROP 1 or 2: its seeded forward bit for bit the debug
                forward's and the keep-tensor forward given that mask, a
                keep of ones bit for bit K2, each forward twice bit for
                bit), against torch.autograd
                of the plain versions on the same inputs and cotangent, K5's
                mask bit for bit against the plain generator, the bf16 K3,
                K4 and K5's backward twice bit for bit but dGn, K5's seeded
                backward bit for bit (but dGn) its keep-tensor backward
                given the forward's own mask, each timed a call and by graph
                replay (K4's and K5's backward beside the CUDA-core body's
                device time they replaced), K3's weight-grad
                pass's yardstick beside it (its three X^T Y as torch.mm on
                operands of the scratch's shapes);
                the same checks at the L = 48 bucket (B96 L48 K48: a block
                owns a partial tile of residues); then the Stage-1 kernels
                at the Stage-1 bench shape (4 synthetic frames of 132
                residues, L 192, 2688 atoms, 65536 directed atom edges a
                frame), f32 and bf16: K8 (edge_gather; vector or scalar
                path by width and alignment) bit for bit, K9
                (edge_aggregate: F 12 and 48 means, the F 36 sum of K8's
                backward, and a graph with nodes of 200+ edges; twice bit
                for bit, and bit for bit csr_order_aggregate of
                tests/_torch_aggregate_order.py, the order the CPU tests
                hold against the TPU kernel) and K10 (fused_tp, the three layer
                signatures on the atom edges and on the cross graph's
                [B, L, 14, *] operands; bf16 on the tensor cores) within
                their tolerances, each timed beside its bound, its plain
                version and the nearest PyTorch call (the kernel and that
                call also by CUDA graph replay: the device's time); K11
                (fused_tp_bwd: dx, dsh, dw; bf16 on the tensor cores) at
                K10's six shapes against autograd of the plain K10 (float64
                for f32), timed beside its bound, the plain backward and
                the dense form's backward in cuBLAS (both also by graph
                replay); the K8/K9 backwards (each the other
                kernel) against autograd of their plain versions;
  3. kernels_k6 -- K6 (fused_message_edge, the adaLN residual encoder's raw
                per-edge messages; bf16 on the tensor cores,
                message_edge_mma_kernel) at B96 L128 K64 and B96 L48 K48, f32
                and bf16, against ref_message_edge, and its backward (bf16 on
                the tensor cores, message_edge_bwd_mma_kernel, twice bit for
                bit but dGn) against autograd of ref_message_edge (float64
                for f32), timed a call and by graph replay beside the bound,
                the plain version and the CUDA-core body's device time;
  4. kernels_k7 -- K7 (fused_edge_then_sum: K2 of one encoder layer chained
                into K1 of the next in one kernel; bf16 on the tensor cores,
                edge_then_sum_mma_kernel; f32 edge_then_sum_f32_mma_kernel)
                at the same shapes and dtypes (f32 also at N != L: B96, 64
                rows, N 128)
                against ref_edge_then_sum, and against K2's kernel followed
                by K1's kernel on the same inputs, which it must equal bit
                for bit; timed a call beside both and on the device (graph
                replay) beside the pair;
  5. slice   -- the Stage-2 inference path at full width: a synthetic CG
                batch of 96 frames x 128 residues, 100 respaced ancestral
                steps of the 3+3-layer bf16 denoiser, VQ snap, IC decode
                and xyz14 in f32, with the kernels' launch counts read
                around it (the decoder's graph ops are K8/K9);
  6. timing  -- one more 100-step sample_and_decode, timed; one draw at the
                L = 48 bucket (96 x 48, K = 48);
  7. fused_sampling -- the counterpart of scripts/bench_fuse_ablation.py:
                100-step bf16 scans of the same denoiser with
                denoise(fuse_pairs=True) and False from the same noise,
                timed in turns in one process; launches of a fused scan
                asserted (300 K7, 300 K1, no K2), the two paths' final
                latents and first-step outputs bit for bit equal (and
                within FUSE_TOL);
 7b. f32_chain -- the f32 denoiser (the trainers' default precision and the
                --no-bf16 draw): a 100-step f32 draw to xyz14 at B96 L128
                K64 with launches asserted (600 K1, 300 K2), timed (steps/s),
                one at B96 L48 K48; one denoise call traced (K1 and K2 must
                run as message_sum_f32_mma_kernel and
                message_edge_lnmod_f32_mma_kernel, K7 with fuse_pairs as
                edge_then_sum_f32_mma_kernel, no chain_kernel); an f32 fused
                scan against the unfused one (300 K7, bit for bit equal);
                f32 training steps at dropout 0.6 (ms a step, K1's forward
                traced as message_sum_f32_mma_kernel);
  8. reference -- a small batch through the same path in f32 on the card
                and with the plain versions on the CPU, same weights and
                noise (kNN indices, one denoise call, 10 sampling steps,
                decode);
  9. residual_sampling -- the slice with the adaLN residual denoiser (gates
                open): 100 bf16 steps to xyz14 with launches asserted (600
                K1, 300 K6, no K2), timed, and its f32 reference (8.);
 9b. trace_sampling -- at B96 L128 K64 and at B96 L48 K48, one draw of
                the bf16 sampling path (5.) through `sample_latents` with a
                step hook: 3 steps' untraced wall time, 3 steps' device
                time (queued behind a sleep kernel: the untraced step's
                device busy share), and 3 steps under torch.profiler: the
                device's busy share of the traced wall and the kernels by
                device time; K2 must run as message_edge_lnmod_mma_kernel
                and no chain_kernel may run (after the sampling phases,
                which thus run before any profiler session);
 10. train   -- the Stage-2 training path: 20 steps of make_latent_step at
                B96 L128 K64 H128, 3+3 layers, bf16, dropout 0.6, with the
                launches of every step counted (6 K1, 3 K5, 6 K3, 3 K5
                backward), median ms/step and peak memory, the last 3
                steps under torch.profiler (the device's busy share and
                the kernels by device time; K5's forward must run as
                message_edge_lnmod_mma_kernel, K3 as
                message_sum_bwd_mma_kernel, K5's backward as
                message_edge_lnmod_bwd_mma_kernel and the weight grads as
                wgrad_mma_kernel, no chain_kernel or chain_bwd_kernel);
                then 2 steps at
                dropout 0
                (6 K1, 3 K2, 6 K3, 3 K4 a step);
 11. train entry -- `python -m codlad_tpu_torch.cli.train_latent` (its
                main) for 5 bf16 steps on a synthetic 96 x 128 feature set;
                finite logged losses, a `last` checkpoint that restores;
 12. train reference -- one f32 step at dropout 0.6 on a small batch on the
                card and on the CPU, same weights, t, noise and dropout seed:
                loss, grad norm, every parameter's grad, updated params
                and EMA;
 13. residual_train -- 10 bf16 steps at dropout 0.6 with the adaLN residual
                denoiser (gates open), launches asserted every step (6 K1,
                3 K6, 6 K3, 3 K6 backward), median ms/step, peak memory, the
                last step under torch.profiler (K6 must run as
                message_edge_mma_kernel, its backward as
                message_edge_bwd_mma_kernel, no chain_kernel or
                chain_bwd_kernel); one f32 step at dropout 0
                card against CPU (12.); the trainer's main with
                --adaln_mode residual for 3 steps;
 13b. train_stage2_full -- the whole Stage-2 trainer at B96 L128 K64 H128,
                3+3 layers, bf16, dropout 0.6: train_latent.main with
                --self_condition --class_dropout_prob 0.1 --t_sampler
                loss_second_moment --grad_accum 2 --remat and validation
                every 4 epochs on a val feature set, 8 micro-steps, each
                one's launches asserted from its self-conditioning coin and
                remat (K1 6 and K5 3 a forward: the main pass, its
                recomputation, and the no-grad first pass on heads; K3 6
                and K5's backward 3), `best` and the val rows written; then
                --resume to micro-step 12 (restarting at 8, the best val
                loss replayed) and a --model_ckpt warm start of 2
                micro-steps with a fresh optimizer; the self-conditioned
                step (heads) with and without remat on one batch: median
                ms and peak memory (remat's peak must be the lower); two
                f32 micro-steps at dropout 0 under accumulation 2,
                self-conditioning heads then tails, class dropout injected,
                card against CPU (as 12.);
 14. recon   -- the Stage-1 reconstruction path (`--experiment recon`) at
                the production VQ-VAE config (results/convergence/vqvae:
                embed 36, vqdim 3, ns 12, nv 4, 3 encoder and 4 decoder
                layers, cutoffs 9 and 21 Å, f32, a 512-code codebook) with
                random weights from --seed, on the Stage-1 bench batch:
                encode, VQ snap, decode, xyz14, metrics; launches of K8, K9
                and K10 per encoder forward and per decode asserted; wall
                time, the encoder's share, peak memory; a small batch card
                against CPU (latents, VQ codes with near-ties allowed,
                decode); the bf16 encoder forward timed at the bench batch;
 15. recon trained -- the trained VQ-VAE converted from the study's
                checkpoint (weights/convergence_vqvae.npz) on four frames of
                its val protein prot_0030, against the JAX outputs stored
                beside it (weights/convergence_vqvae_fixture.npz): codes,
                per-frame rmsd_aligned;
 16. recon entry -- `python -m codlad_tpu_torch.cli.test --experiment
                recon` (its main) on a shard directory the port writes,
                with the trained weights; summary_stats.json.
 16b. latent_trained -- the trained Stage-2 denoiser converted from the
                study's checkpoint (weights/convergence_latent.npz, EMA) in
                f32 on the fixture's four prot_0030 frames, against the JAX
                outputs in weights/convergence_latent_fixture.npz: the kNN
                graph, one denoise, a 100-step DDIM run at eta 0 from the
                fixture's x_T (600 K1 and 300 K2 launches asserted), the VQ
                codes (near-ties allowed) and per-frame rmsd_aligned; the
                same run on the CPU's plain versions for the card/CPU drift;
 16c. latent_entry -- `cli.test --experiment latent` (its main; bf16, 100
                ancestral steps, 10 members) and then `--experiment prior`
                with the trained weights on shards the port writes of the
                study's val proteins prot_0030 and prot_0031 (first 96
                frames, the study's recipe): each protein's ensemble means
                and wall seconds beside the card's name and power limit,
                held against the JAX evaluation's numbers (JAX_EVAL, within
                EVAL_TOL, on the JAX side of the port's prior), the
                summaries' keys the JAX CLI's, the launches of the latent
                run (per draw 600 K1, 300 K2 and a decode's K8/K9); then
                three timed bf16 draws of each protein's batch (96 x 64 and
                96 x 96), one draw whose first and last steps' K1/K2 calls
                and whose decode's K8/K9 calls are each held against the
                plain version on the same inputs (`check_trained_calls`:
                the real shapes and padding), and one draw through
                `trace_sampling`.
 16d. guided_sampling -- a self-conditioned denoiser (x_in 6 -> 128,
                random weights, gates open) under create_diffusion("100",
                self_condition=True), guided at cfg 1.5, bf16, through
                sample_and_decode on the 96 x 128 batch: 600 K1 and 300 K2
                launches on the condition-doubled 192 rows and a decode's
                K8/K9 (asserted), a timed draw, every K1/K2 call of the
                first and last step against the plain version (bf16 within
                TOL + CALL_SCALE_TOL_BF16 max|ref|), one traced window
                (`trace_sampling`); small f32 draws (4 x 64) card against
                CPU on the CPU's conditioning: guided and self-conditioned,
                the masked decoder with an injected decoding_randn,
                use_seq_in_encoder=False, final_adln=False, and cfg 1
                against the unguided draw; `cli.test --experiment latent
                --cfg_scale 1.5 --num_ensemble 2` with the trained weights on
                prot_0030 (finite summary, launches asserted, wall s).
 17. train_stage1 -- the Stage-1 trainer's step (make_vqvae_step) at the
                Stage-1 bench batch and the trained run's config (3 + 4
                layers, 512 codes), random weights from --seed, bf16 feature
                path: 10 steps, launches of K8-K11 asserted every step,
                the loss finite and no step skipped, median ms/step, the
                first step, peak memory, the last step under
                torch.profiler; then 3 steps in f32;
 18. train_stage1_reference -- one f32 step on a small batch (2 x 40) on
                the card and on the CPU: loss, every parameter's grad, the
                VQ state;
 19. train_stage1_entry -- the chain through its entry points on two
                synthetic proteins: cli.train_vqvae (-bf16, 2 epochs, then
                -resume), cli.extract_features, 2 steps of cli.train_latent
                on those features, cli.test --experiment recon --vae_ckpt;
 20. stage1_variants -- the rest of Stage 1 at the K3/K4 recipe's widths
                (embed 36, vqdim 3, 4096 codes, 3 + 4 layers): CGPrior's
                K8-K11 calls on the bench batch's CG graph, f32 and bf16,
                against their plain versions (the f32 layer-2 calls timed:
                records cgprior_*); 3 bf16 steps of the angle VQ-VAE and 3
                f32 steps of GenZProt at the Stage-1 bench batch, launches
                asserted every step; one f32 step card vs CPU of GenZProt,
                the angle VQ-VAE and fgvae (a grad outside the f32 limit
                refereed against a float64 CPU step); one step of each
                quantizer kind card vs CPU; the chain train_vqvae
                -train_section ivae -> cli.test --experiment genzprot
                (launches a draw asserted), -predict_angle -quantize_type
                fsq_5 -> extract_features -> recon, fgvae ->
                extract_features --learn_sigma.
 21. flows  -- flow matching and the data I/O: the port's native host
                library loaded (not its fallbacks), its LAP equal to
                scipy's and its radius graph to the dense form, an XTC
                round trip within the codec's precision; bf16 flow draws of
                the 3+3-layer denoiser (C output channels) at B96 L128 K64
                by euler (100 steps), midpoint (50) and rk4 (25), each
                100 evaluations: 6 K1 and 3 K2 an evaluation and a decode's
                K8/K9 asserted, each timed, euler beside the diffusion
                timing phase's rate and traced (`trace_sampling`); dopri5
                at rtol = atol = 1e-5 within 100 attempts (nfe, accepted,
                rejected, host reads, launches asserted); f32 draws card vs
                CPU on the CPU's conditioning (4 x 64, euler and dopri5:
                1e-5 of max|latent|, nfe equal); 10 bf16 otcfm and sbcfm
                steps at dropout 0.6 (launches asserted, ms/step, the host
                LAP's ms) and 2 otcfm steps at dropout 0 (K2/K4); an f32
                step of each card vs CPU (loss rtol 1e-6, grads 1e-3); the
                user path: synthetic proteins written by the port's
                write_pdb / write_xtc -> cli.preprocess --xtc_dir ->
                features from the committed VQ-VAE -> train_latent --model
                otcfm --bf16 -> cli.test --model otcfm --method euler
                --save_pdb --save_xtc (launches asserted, the PDB and XTC
                parsed back).
 22. distill -- progressive distillation: 20 bf16 steps of
                make_distill_step at B96 L128 K64 (ddim100 -> 50, the
                student starting as the teacher), launches asserted every
                step (18 K1, 9 K2, 6 K3, 3 K4: two teacher evaluations and
                the student's forward, and its backward), median ms/step,
                peak memory, the last step traced (K1-K4 must run as
                message_sum_mma_kernel, message_edge_lnmod_mma_kernel,
                message_sum_bwd_mma_kernel and
                message_edge_lnmod_bwd_mma_kernel<0>); one f32 step card vs
                CPU (as 12.); the user path with the trained weights:
                cli.extract_features --vae_weights on 16c's val shards,
                one round of cli.distill (100 -> 50, --teacher_weights, bf16),
                the distillation loss of a held batch before and after it
                (it must fall), cli.test --latent_ckpt on the student (DDIM
                on its 50-step grid: 300 K1 + 150 K2 a draw asserted) beside
                the teacher's 100-step DDIM means.
 23. parallel -- K1-K4 at the sequence-sharded shape (B96, 64 local rows
                of a node table of N 128, K 64), both dtypes, against their
                plain versions (records *_seq); cli.train_latent and
                cli.train_vqvae -dp without a process group and then in a
                process group of one rank (NCCL, made from torchrun's
                variables): their losses equal (rtol 1e-3); on that rank
                ring_knn against the dense kNN, the seq-mode denoiser's f32
                forward and step against the dense ones, one bf16 seq-mode
                step, the dryrun twin (parallel/dryrun.py, with its data x
                tensor configuration at a model axis of 1), a bf16 dp x tp
                step (parallel/tensor.py) at B96 L128 K64, dropout 0,
                against the plain step (launches asserted: 6 K1, 3 K2, 6
                K3, 3 K4), and a bf16 training step with and without that
                rank's mesh, timed in turns; with two cards, the dryrun
                twin on two NCCL ranks.
 24. import -- cli.import_checkpoint on weights/convergence_vqvae_n6layout.pt
                (the trained VQ-VAE in the reference's N6 key layout, with
                DDP's prefix and a dist_filter key) into a port logdir; its
                f32 recon on the fixture frames against the converted
                weights' (every VQ code equal) and the JAX outputs (as
                recon_trained); `cli.test --experiment recon --vae_ckpt` on
                two proteins against the `--vae_weights` run (every metric
                within rtol 1e-4), its K8 / K9 / K10 launches counted; a
                K3 / K4 angle-layout state dict at the trained widths (a
                random decoder; a temporary file only) through a run
                directory and --modelnum 999.
 25. protein_mpnn -- the autoregressive ProteinMPNN at the JAX class's
                default widths (hidden 128, 3 + 3 layers, K 64, 21 letters),
                4 chains x 128, f32, random weights, card vs CPU: the
                teacher-forced log-probs and unconditional_probs within
                1e-4; conditional_probs (both modes) against the CPU's
                teacher-forced forward at 4 positions; sample and
                tied_sample with the same Gumbel noise (sequences equal,
                probs within 1e-4, or a first differing draw whose top-two
                gap is under 1e-4, logged); the seconds of a draw.

Sampling weights, but in 15, 16, 16b and 16c (the trained weights), are the
port's init from --seed with the adaLN heads (zero at init) drawn small and
random, so that every layer reaches the output; a missing weights file
fails its phase;
the trunk training phases start from the plain init, as the trainer does;
the residual ones open the gates too (at init a residual layer is the
identity and K6's backward would receive a zero cotangent). The line
before the last is the card's name and power limit from nvidia-smi; the
last line is {"ok": true, "device": {...}}; the line before that one the
kernels' JSON (K1-K11, each record with its dtype: the main path's, and for
K8, K9 and K10 both the f32 record of recon and the bf16 one of the Stage-1
trainer, whose launches are those of the bf16 training steps, and for
K1 the bench shape's record and the L = 48 bucket's, keyed
fused_message_sum_k48, whose launches are the L = 48 draw's; the f32 K1,
K2 and K7 records (`<name>_f32` at the bench shape, `<name>_f32_k48` at
L = 48; K7's at N != L logged), whose launches are those of phase 7b's
f32 draws and f32 fused scan; K1, K2 and
the f32 K8 and K9 records also carry latent_cli_launches, their launches
over phase 16c's latent run; K1 and K2 guided_launches, those of 16d's
guided draw; K1, K2, K8 and K9 flow_launches, those of phase 21's euler
draw, and K1-K5 flow_train_launches, those of its flow steps; K1-K4
distill_launches, those of phase 22's 20 steps, and K1, K2
distill_cli_launches, those of its student's draws; the *_seq records
(K1-K4 at N != L, each dtype), whose launches are those of phase 23's
seq-mode steps on one rank (where N = L); K1, K3
and K5's two train_full_launches, those of 13b's 8 micro-steps; K8-K11's cgprior_* records, CGPrior's f32 calls, whose
launches are CGPrior's share of phase 20's GenZProt steps; every ms
one call timed with CUDA events, and the K1-K11 records' device_ms
(K8-K11 also library_device_ms; K3 wgrad_library_ms and
wgrad_library_device_ms, the torch.mm yardstick of its weight-grad pass)
the device's time by graph replay). Exits
non-zero, printing no result, without a CUDA device or when any phase fails.
"""

from __future__ import annotations

import argparse
import atexit
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

B, L, K, H = 96, 128, 64, 128   # bench shape (bench.py)
STEPS = "ddim100"                # 100 respaced steps of a 1000-step process
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores
# The f32 K1, K2 and K7 run on the tensor cores in 3xTF32 (three TF32
# products for each f32 one): their records also carry tc_bound_ms, the
# larger of the bytes' time and 3 x the products' operations at the TF32
# tensor cores' 495 TFLOP/s (dense; the H100 SXM data sheet).
TF32_OPS = 495e12
TOL = {"float32": (2e-4, 2e-4),   # atol, rtol as tests/test_kernels.py:77
       "bfloat16": (2e-2, 2e-2)}  # ~2.5 bf16 ulps: one-ulp rounding flips of gelu(pre)
# Backward grads. f32 (against the float64 plain versions): |d| <= 2e-4 +
# 2e-4 * |ref| + 2e-6 * max|ref|; the last term is f32 rounding of the
# per-row terms that a weight grad sums over 786k edge rows (~4e-7 of the
# largest element measured for K4's dW_e), which no per-element tolerance
# can absorb where the sum is near zero. bf16 (against the bf16 plain
# versions): |d| <= c * max|ref|, c per output. The grads that leave in
# bf16 or sum bf16-rounded products (dA, dE, dGn, dW_e, dW2, db2, dW3)
# differ by about one bf16 ulp of their largest element, 2^-8 to 2^-7 of
# max|ref|: c = 2e-2, ~3 ulps. db3, dsh, dsc and dgate are f32 sums of the
# same terms on both sides, which differ in order only: c = 2e-4, 20x
# below one bf16 rounding (2^-9), so that a kernel rounding them fails.
GRAD_SCALE_TOL_F32 = 2e-6
GRAD_TOL_BF16 = dict(dict.fromkeys(("A", "E", "Gn", "W_e", "W2", "b2", "W3"), 2e-2),
                     **dict.fromkeys(("b3", "sh", "sc", "g"), 2e-4))
P_DROP = 0.6                     # the trainer's default dropout
# The CUDA-core main passes that the bf16 K4, K5's and K6's backwards ran on
# before their tensor-core kernels: device ms by graph replay, (B96 L128 K64,
# B96 L48 K48), this script on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's
# kernel table). Logged beside the new times.
CUDA_CORE_BWD_MS = {"fused_message_edge_lnmod_bwd": (9.0936, 3.2978),
                    "fused_message_edge_lnmod_drop_bwd": (9.4042, 3.3845),
                    "fused_message_edge_bwd": (7.0483, 2.6091)}
KERNELS = {  # name -> (TPU kernel it replaces, CUDA source)
    "fused_message_sum": ("codlad_tpu/kernels/mpnn_kernels.py:395", "message_chain.cu"),
    "fused_message_edge_lnmod": ("codlad_tpu/kernels/mpnn_kernels.py:519",
                                 "message_chain.cu"),
    "fused_message_sum_bwd": ("codlad_tpu/kernels/mpnn_kernels.py:810",
                              "message_chain_bwd.cu"),
    "fused_message_edge_lnmod_bwd": ("codlad_tpu/kernels/mpnn_kernels.py:854",
                                     "message_chain_bwd.cu"),
    # K5: K2's and K4's TPU kernels in their seeds mode (reached from
    # fused_message_edge_lnmod_pdrop :1137 and _pdrop_bwd :1098)
    "fused_message_edge_lnmod_drop": ("codlad_tpu/kernels/mpnn_kernels.py:519",
                                      "message_chain.cu"),
    "fused_message_edge_lnmod_drop_bwd": ("codlad_tpu/kernels/mpnn_kernels.py:854",
                                          "message_chain_bwd.cu"),
    "edge_gather": ("codlad_tpu/kernels/edge_kernels.py:119", "edge_ops.cu"),
    "edge_aggregate": ("codlad_tpu/kernels/edge_kernels.py:140", "edge_ops.cu"),
    "fused_tp": ("codlad_tpu/kernels/tp_kernels.py:152", "fused_tp.cu"),
    "fused_tp_bwd": ("codlad_tpu/kernels/tp_kernels.py:193", "fused_tp_bwd.cu"),
    "fused_message_edge": ("codlad_tpu/kernels/mpnn_kernels.py:418", "message_chain.cu"),
    "fused_message_edge_bwd": ("codlad_tpu/kernels/mpnn_kernels.py:833",
                               "message_chain_bwd.cu"),
    "fused_edge_then_sum": ("codlad_tpu/kernels/mpnn_kernels.py:436", "message_chain.cu"),
}
# K7 in bf16: its edge output is K2's arithmetic, held within the JAX test's
# atol 5e-2 (tests/test_kernels.py:796) + K2's rtol 2e-2; its node sum and
# K6's messages within 2e-2 max|ref| (a few bf16 ulps of the largest element:
# one-ulp flips of cast(gelu(pre)) and of the edge output feed the products).
K7_EDGE_TOL_BF16 = (5e-2, 2e-2)
MSG_TOL_BF16 = 2e-2
# Pair-fused vs unfused sampling (bf16, 100 steps, the same x_T and per-step
# noise): on the card the two must be bit for bit equal (K7 runs K2's and K1's
# instructions); FUSE_TOL, the denoiser's output at the first step within
# 2e-2 max|ref| and the final latents within 2e-2 max|latent|, is checked
# too, and is what the CPU rehearsal (plain versions) holds.
FUSE_TOL = 2e-2
WEIGHTS = Path(__file__).resolve().parent / "weights" / "convergence_vqvae.npz"
FIXTURE = WEIGHTS.with_name("convergence_vqvae_fixture.npz")
K48 = (B, 48, 48)               # the L = 48 length bucket: K = min(64, L) = 48
STAGE1 = (4, 132)               # bench.py:309-327: synthetic_examples(4, 132), quantize_spec
# K9 in bf16 (kernel vs plain, both f32 sums in different orders, then cast
# and divided in bf16): a sum that lands on the other side of a rounding
# boundary is one bf16 ulp (<= 2^-7 of the value) apart, and the division
# rounds once more: |d| <= 2^-6 |ref| + 1e-4 max|ref|, the last term for
# sums that cancel to near zero (f32 order error ~1e-7 of the summed terms).
AGG_TOL_BF16 = (2.0 ** -6, 1e-4)
# K10 in bf16: the plain version rounds TR to bf16 before w * TR, the kernel
# (as the Pallas kernel) keeps it in f32, so each of a column's ~14 products
# differs by up to half a bf16 ulp and the output is rounded once more:
# |d| <= 2e-2 max|ref|, ~3 bf16 ulps of the largest output.
TP_TOL_BF16 = 2e-2
ENC_LAYERS, DEC_LAYERS = 3, 4   # results/convergence/vqvae/modelparams.json
CODEBOOK = 512
CODE_MARGIN = 1e-4              # near-tie of the two nearest codes, squared distance
FLOOR = {"rmsd_aligned": 0.6615, "ged": 0.0165, "clash": 0.0041}  # FLOOR_TABLE.md recon
LATENT_WEIGHTS = WEIGHTS.with_name("convergence_latent.npz")
LATENT_FIXTURE = WEIGHTS.with_name("convergence_latent_fixture.npz")
# The trained denoiser in f32 against its JAX fixture: the denoise at one t
# and the 100-step DDIM latents as fractions of max|ref| (the latents reach
# ~370 in normalised units), per-frame rmsd_aligned in Å. Measured on an H100
# (this script): denoise 8.5e-7 of max|ref| on the card and on the CPU,
# latents 6.6e-7 card vs JAX, CPU vs JAX and card vs CPU alike (f32 sums in
# another order); the limits are ~15x that.
DENOISE_TOL = 1e-5
LATENT_TOL = 1e-5
LATENT_RMSD_TOL = 1e-2
# The JAX evaluation of the trained model (results/convergence/eval_latent and
# eval_prior/summary_stats.json: cli.test, bf16, 100 ancestral steps, 10
# members, the first 96 frames), per protein; the card does not get results/.
JAX_EVAL = {
    "prot_0030.npz": {"latent": {"rmsd_aligned": 3.4463385581970214,
                                 "ged": 0.5789645969867706, "clash": 0.021719863265752794,
                                 "div": 0.32082098722457886},
                      "prior": {"rmsd_aligned": 3.018958497047424}},
    "prot_0031.npz": {"latent": {"rmsd_aligned": 3.6418501853942873,
                                 "ged": 0.6634328901767731, "clash": 0.02422882867977023,
                                 "div": 0.33537226915359497},
                      "prior": {"rmsd_aligned": 3.245240330696106}},
}
EVAL_TOL = {"rmsd_aligned": 0.10, "ged": 0.03, "clash": 0.01, "div": 0.03}
_METRICS = {"rmsd", "rmsd_aligned", "ged", "clash", "inter", "xyz", "bond", "angle",
            "torsion", "graph_valid_ratio", "graph_diff_ratio"}
_ENSEMBLE = _METRICS | {"div", "rmsd_ref_ens", "rmsd_gen_ens", "wallclock_sec"}
JAX_SUMMARY_KEYS = (_ENSEMBLE | {"per_ensemble"}, _METRICS, _ENSEMBLE | {"total_sec"},
                    _ENSEMBLE)  # a protein, a member, __global__, __global_stats__


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def open_gates(model, gen, std=0.02):
    """Draw the zero-initialised adaLN heads N(0, std^2) so the trunk is not
    gated shut (as after training)."""
    import torch
    heads = [layer.Dense_0 for layer in [*model.enc_layers, *model.dec_layers]]
    if model.final_adln:
        heads.append(model.w_out.Dense_0)
    with torch.no_grad():
        for lin in heads:
            for p in lin.parameters():
                p.normal_(0.0, std, generator=gen)


def build_pipeline(device, seed, hidden=H, layers=3, k=K, codebook_size=4096,
                   respacing=STEPS, compute_dtype=None, adaln_mode="trunk", cfg_scale=0.0,
                   self_condition=False, **model_kw):
    """The port's sampling pipeline at the production configuration, in the
    given adaLN mode; guided at cfg_scale != 0, self-conditioned (denoiser
    and process) with self_condition, and the denoiser's other options as
    `model_kw` give them."""
    import torch
    from codlad_tpu_torch.eval.harness import SamplingPipeline
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    from codlad_tpu_torch.models.vae import VAE

    gen = torch.Generator().manual_seed(seed)
    denoiser = MPNNDenoiser(gen, hidden_dim=hidden, edge_features=hidden,
                            num_encoder_layers=layers, num_decoder_layers=layers,
                            k_neighbors=k, adaln_mode=adaln_mode,
                            self_condition=self_condition, **model_kw)
    open_gates(denoiser, gen)
    codebook = torch.randn((codebook_size, 3), generator=gen)
    return SamplingPipeline(
        denoiser=denoiser.to(device).eval(),
        process=create_diffusion(respacing, diffusion_steps=1000,
                                 self_condition=self_condition),
        vae=VAE(gen, encoder=False).to(device).eval(), codebook=codebook.to(device),
        norm_mean=[0.0, 0.0, 0.0], norm_std=[1.0, 1.0, 1.0],
        compute_dtype=compute_dtype, cfg_scale=cfg_scale)


def run_slice(pipe, batch, generator):
    """Drive the main path once and read the kernels' launch counts around
    it: {latents, ic, xyz14, seconds, launches}."""
    import torch
    from codlad_tpu_torch import kernels

    dev = batch["res_type"].device
    extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
              "mask": batch["res_mask"]}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    lat = pipe.sample_latents(extras, generator=generator)
    ic, xyz = pipe.decode(batch, lat)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"latents": lat, "ic": ic, "xyz14": xyz, "seconds": seconds,
            "launches": kernels.launch_counts()}


def fused_scans(pipe, batch, seed, rounds=2):
    """The port's counterpart of scripts/bench_fuse_ablation.py: ancestral
    scans over every step of the pipeline's process with the pipeline's
    (bf16) denoiser called with fuse_pairs=True and False, from the same x_T
    and per-step noise, through `p_sample_loop` with the conditioning
    computed once. One fused scan with the launches counted, then `rounds`
    rounds timed in turns (F U, U F, ...). Returns the launches, the seconds
    of each path's timed scans, the max |d| between the two paths' final
    latents and between their denoiser outputs at the first step, the scale
    (max |.|) of each, and whether each pair is bit for bit equal."""
    import torch
    from codlad_tpu_torch import kernels

    extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
              "mask": batch["res_mask"]}
    dev = batch["res_type"].device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    model, cd, proc = pipe._denoise_model, pipe.compute_dtype, pipe.process
    n = proc.num_timesteps
    shape = tuple(batch["res_type"].shape) + (pipe.latent_size,)
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(shape, generator=g, device=dev)
    noises = [torch.randn(shape, generator=g, device=dev) for _ in range(n)]
    with torch.no_grad():
        cond = pipe.condition(extras)

        def denoise(x, t, fuse):
            return model.denoise(x if cd is None else x.to(cd), t, cond,
                                 fuse_pairs=fuse).to(torch.float32)

        def scan(fuse):
            sync()
            t0 = time.perf_counter()
            x = proc.p_sample_loop(lambda x, t: denoise(x, t, fuse), shape, noise=noise,
                                   noises=noises)
            sync()
            return x, time.perf_counter() - t0

        kernels.reset_launches()
        scan(True)
        launches = kernels.launch_counts()
        seconds, final = {True: [], False: []}, {}
        for i in range(rounds):
            for fuse in ((True, False) if i % 2 == 0 else (False, True)):
                final[fuse], sec = scan(fuse)
                seconds[fuse].append(sec)
        t_first = proc.map_t(torch.full(shape[:1], n - 1, dtype=torch.long, device=dev))
        first = {fuse: denoise(noise, t_first, fuse) for fuse in (True, False)}
    return {"launches": launches, "fused_s": seconds[True], "unfused_s": seconds[False],
            "latents_d": (final[True] - final[False]).abs().max().item(),
            "latents_scale": final[False].abs().max().item(),
            "first_d": (first[True] - first[False]).abs().max().item(),
            "first_scale": first[False].abs().max().item(), "steps": n,
            "latents_equal": torch.equal(final[True], final[False]),
            "first_equal": torch.equal(first[True], first[False])}


def trace_sampling(pipe, batch, seed, n=3, sleep_cycles=400_000_000):
    """One draw of the pipeline's (bf16) sampling path through its entry
    point, `sample_latents`, with a step hook that reads three windows of n
    steps after the first step:
      1. untraced: the host's wall time a step (synchronised at both ends);
      2. the device's own time a step: the n steps queued behind a sleep
         kernel of `sleep_cycles`, so that the host has queued them all
         before the device reaches them (held: the host's queueing time is
         below the sleep's), timed by CUDA events; its share of (1.) is the
         untraced step's device busy share;
      3. under torch.profiler: the busy share of the traced wall time and
         the kernels by device time a step (`trace_summary`).
    On the CPU (a rehearsal) (2.) is left out. Returns the names of the
    kernels that ran on the device in (3.)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
              "mask": batch["res_mask"]}
    dev = batch["res_type"].device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else []
    got = {"queue_ms": math.inf}

    def untraced_start():
        sync()
        got["t"] = time.perf_counter()

    def queued_start():
        sync()
        got["wall_ms"] = (time.perf_counter() - got["t"]) * 1e3 / n
        if cuda:
            ev[0].record()
            torch.cuda._sleep(sleep_cycles)
            ev[1].record()
            got["t"] = time.perf_counter()

    def traced_start():
        if cuda:
            ev[2].record()
            got["queue_ms"] = (time.perf_counter() - got["t"]) * 1e3
        sync()
        prof.start()
        got["t"] = time.perf_counter()

    def traced_stop():
        sync()
        got["traced_ms"] = (time.perf_counter() - got["t"]) * 1e3
        prof.stop()

    marks = {1: untraced_start, 1 + n: queued_start, 1 + 2 * n: traced_start,
             1 + 3 * n: traced_stop}
    g = torch.Generator(device=dev).manual_seed(seed)
    pipe.sample_latents(extras, generator=g, step_hook=lambda i: marks.get(i, lambda: None)())
    sleep_ms, dev_ms = ((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]) / n) if cuda
                        else (0.0, 0.0))
    if got["queue_ms"] < sleep_ms:
        log(f"  untraced sampling step: wall {got['wall_ms']:.3f} ms, device "
            f"{dev_ms:.3f} ms (the {n} steps queued in {got['queue_ms']:.1f} ms behind "
            f"a {sleep_ms:.1f} ms sleep): device busy {dev_ms / got['wall_ms']:.3f} of the "
            f"untraced wall")
    else:
        log(f"  untraced sampling step: wall {got['wall_ms']:.3f} ms; device time not "
            f"measured (queueing the {n} steps took {got['queue_ms']:.1f} ms, longer than "
            f"the {sleep_ms:.1f} ms sleep)")
    trace_summary(prof, got["traced_ms"], n)
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def check_launches(got, expect, where):
    """Every kernel launched as `expect` says (0 where it says nothing)."""
    for name, n in got.items():
        if n != expect.get(name, 0):  # expect > 0: a kernel never launched fails too
            raise RuntimeError(f"{name} launched {n} times on {where}, "
                               f"expected {expect.get(name, 0)}")


def check_slice(out, n_frames, n_res):
    import torch
    shapes = {"latents": (n_frames, n_res, 3), "ic": (n_frames, n_res, 13, 3),
              "xyz14": (n_frames, n_res, 14, 3)}
    for key, shape in shapes.items():
        v = out[key]
        if tuple(v.shape) != shape:
            raise RuntimeError(f"{key} has shape {tuple(v.shape)}, expected {shape}")
        if not torch.isfinite(v).all():
            raise RuntimeError(f"{key} is not finite")


def kernel_inputs(dtype, seed, device, dims=(B, L, K), n_nodes=None):
    """Full-width K1/K2 operands in the layout the main path gives them;
    n_nodes: the node table's rows N (default L), as the sequence-sharded
    denoiser gives them (L local edge rows, idx into the gathered N)."""
    import torch
    b, l, k = dims
    n = n_nodes or l
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(device)
    return dict(
        A=r(b, l, H).to(dtype), E=r(b, l, k, H).to(dtype), Gn=r(b, n, H).to(dtype),
        idx=torch.randint(0, n, (b, l, k), generator=g, dtype=torch.int32).to(device),
        mask=(torch.rand(b, l, k, generator=g) > 0.2).float().to(device),
        W_e=r(H, H, sc=H ** -0.5).to(dtype), W2=r(H, H, sc=H ** -0.5).to(dtype),
        b2=r(H, sc=0.1), W3=r(H, H, sc=H ** -0.5).to(dtype), b3=r(H, sc=0.1),
        sh=r(b, H, sc=0.3), sc=r(b, H, sc=0.3), g=r(b, H))


def kernel_calls(x):
    """{name: (kernel call, plain call, bytes moved, matmul flops)}."""
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    es = x["E"].element_size()
    b, l, k, _ = x["E"].shape
    n = x["Gn"].shape[1]
    n_edge = b * l * k
    chain_in = (b * l * H + n_edge * H + b * n * H) * es + n_edge * 4 + 3 * H * H * es + 2 * H * 4
    s_args = [x[k] for k in ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3", "b3")]
    e_args = [x[k] for k in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3",
                             "sh", "sc", "g")]
    return {
        "fused_message_sum": (
            lambda: MK.fused_message_sum(*s_args, 30.0),
            lambda: MK.ref_message_sum(*s_args, 30.0),
            chain_in + n_edge * 4 + b * l * H * 4,
            2 * 2 * n_edge * H * H + 2 * b * l * H * H),
        "fused_message_edge_lnmod": (
            lambda: MK.fused_message_edge_lnmod(*e_args),
            lambda: MK.ref_message_edge_lnmod(*e_args),
            chain_in + 3 * b * H * 4 + n_edge * H * es,
            3 * 2 * n_edge * H * H),
    }


def time_calls(*fns, reps=10):
    """Median ms of each call, timed with CUDA events, the order of the
    calls reversed every other round."""
    import torch
    times = [[] for _ in fns]
    for i in range(reps):
        order = list(enumerate(fns))
        for j, fn in (order if i % 2 == 0 else order[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times[j].append(e0.elapsed_time(e1))
    return tuple(statistics.median(t) for t in times)


_REPLAY_STREAM = []  # the one side stream every capture uses


def replay_ms(*fns, n=20, reps=5):
    """Device ms of one call of each fn, without the host's time: n calls
    captured in one CUDA graph (after three warm-up calls on the capture
    stream), the graph replayed `reps` times in turns with the others',
    timed with CUDA events; the median over n. A call whose device work
    is shorter than its Python wrapper's host time reads as the host's
    time under `time_calls`; here it does not. Every capture runs on one
    side stream; the graphs and the cuBLAS workspaces (one a stream) are
    freed before returning, so later phases' peak memory excludes them."""
    import gc
    import torch
    if not _REPLAY_STREAM:
        _REPLAY_STREAM.append(torch.cuda.Stream())
    side = _REPLAY_STREAM[0]
    graphs = []
    for fn in fns:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1], stream=side):
            for _ in range(n):
                fn()
    times = [[] for _ in fns]
    for i in range(reps + 1):
        for j, g in (list(enumerate(graphs)) if i % 2 == 0 else list(enumerate(graphs))[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g.replay()
            e1.record()
            torch.cuda.synchronize()
            if i:                                   # the first replay warms up
                times[j].append(e0.elapsed_time(e1) / n)
    for g in graphs:
        g.reset()
    del graphs
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return tuple(statistics.median(t) for t in times)


def check_kernels(device, seed, dims=(B, L, K), n_nodes=None, f32_records=False):
    """Every kernel against its plain version, both dtypes, timed a call
    (CUDA events) and on the device (`replay_ms`, the records'
    device_ms); returns the bf16 (main-path dtype) record of each kernel,
    with its shape, and with f32_records also the f32 one (key
    `<name>_f32`). n_nodes: see kernel_inputs."""
    import torch
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        x = kernel_inputs(dtype, seed, device, dims, n_nodes)
        atol, rtol = TOL[dname]
        for name, (kern, plain, nbytes, flops) in kernel_calls(x).items():
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            ok = bool((diff <= atol + rtol * want.float().abs()).all())
            ms, plain_ms = time_calls(kern, plain)
            (dev_ms,) = replay_ms(kern)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_OPS[dname] * 1e3
            log(f"kernel {name} {dname} {dims_tag(dims, n_nodes)}: max|d|={err:.3g} (atol {atol:g} + "
                f"rtol {rtol:g}*|ref|) "
                f"{'ok' if ok else 'FAIL'}; a call (events) kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms; device (graph replay) kernel {dev_ms:.4f} ms; "
                f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.1f} GFLOP)")
            if not ok:
                raise RuntimeError(f"{name} ({dname}) disagrees with its plain version")
            if dtype == torch.bfloat16 or f32_records:
                key = name if dtype == torch.bfloat16 else f"{name}_f32"
                records[key] = dict(record(name, dname, err, ms, plain_ms, t_bytes, t_ops),
                                    shape=dims_tag(dims, n_nodes), device_ms=dev_ms)
                if dtype == torch.float32:
                    records[key]["tc_bound_ms"] = tc_bound_ms(nbytes, flops)
                    log(f"  {name} f32 on the tensor cores (3xTF32): device {dev_ms:.4f} ms, "
                        f"tensor-core bound {records[key]['tc_bound_ms']:.4f} ms, FFMA bound "
                        f"{max(t_bytes, t_ops):.4f} ms")
        del x
    return records


def tc_bound_ms(nbytes, flops):
    """The 3xTF32 kernels' least time: the bytes at HBM's rate or three TF32
    products for each f32 one at the tensor cores' peak, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_OPS) * 1e3


def record(name, dname, err, ms, plain_ms, t_bytes, t_ops, library_ms=None):
    """One row of the `kernels` JSON line, for the kernel's `dname`
    (bfloat16 or float32) launch (launches filled in later)."""
    replaces, source = KERNELS[name]
    return {"name": name, "dtype": dname, "route": "cuda",
            "source": f"codlad_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


_DIFF = ("A", "E", "Gn", "W_e", "W2", "b2", "W3", "b3")
_SUM_KEYS = ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3", "b3")
_EDGE_KEYS = ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3", "sh", "sc", "g")


def as_f64(x):
    """x with every floating tensor in float64."""
    return {k: v.double() if v.is_floating_point() else v for k, v in x.items()}


def grads_of(fn, x, keys, diff, ct):
    """(output, {name: grad}, plain backward closure) of fn at x's values."""
    import torch
    leaves = {k: x[k].detach().clone().requires_grad_(k in diff) for k in keys}
    out = fn(*(leaves[k] for k in keys))
    ins = [leaves[k] for k in diff]
    gs = torch.autograd.grad(out, ins, ct, retain_graph=True)
    return out.detach(), dict(zip(diff, gs)), (
        lambda: torch.autograd.grad(out, ins, ct, retain_graph=True))


def compare_grads(label, got, want, dname):
    """Every grad against its plain version; returns the largest |d|.
    Logs max|d| / max|ref| of each before failing on any."""
    worst, bad = 0.0, []
    for n, w in want.items():
        d = (got[n].float() - w.float()).abs()
        ref = w.float().abs()
        if dname == "float32":
            bound = (TOL["float32"][0] + TOL["float32"][1] * ref
                     + GRAD_SCALE_TOL_F32 * ref.max())
            limit = "atol 2e-4 + rtol 2e-4 + 2e-6 max|ref|"
        else:
            bound = GRAD_TOL_BF16[n] * ref.max()
            limit = f"{GRAD_TOL_BF16[n]:g} max|ref|"
        ok = bool((d <= bound).all())
        err = d.max().item()
        worst = max(worst, err)
        log(f"  {label} {dname} d{n}: max|d|={err:.3g} max|ref|={ref.max().item():.3g} "
            f"ratio {err / max(ref.max().item(), 1e-30):.3g} ({limit}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"d{n}")
    if bad:
        raise RuntimeError(f"{label} ({dname}) {bad} disagree with plain autograd")
    return worst


def dims_tag(dims, n_nodes=None):
    tag = "B{} L{} K{}".format(*dims)
    return tag if n_nodes in (None, dims[1]) else tag.replace(" K", f" N{n_nodes} K")


def bwd_bytes_flops(es, edge, dims=(B, L, K), raw=False, n_nodes=None):
    """Bytes (each input read once, each output written once) and matmul
    flops of K3 (edge=False), K4 / K5's backward (edge=True) or K6's
    backward (edge=True, raw=True: no b3, sc, g, dsh, dsc, dgate, and no
    recomputed W3 product); n_nodes: Gn's and dGn's rows (default L)."""
    b, l, k = dims
    n_edge, n_node = b * l * k, b * l
    n_tab = b * (n_nodes or l)
    nbytes = ((n_node * H + n_tab * H + n_edge * H) * es + n_edge * 4 + 3 * H * H * es
              + 2 * H * 4
              + n_node * H * 4 + n_edge * H * es + n_tab * H * 4       # dA, dE, dGn
              + 3 * H * H * 4 + 2 * H * 4)                              # weight grads
    if raw:    # dout; no mask and one bias less
        nbytes += n_edge * H * es - n_edge * 4 - H * 4
        flops = 8 * 2 * n_edge * H * H
    elif edge:   # + sc, g, dout; dsh, dsc, dgate
        nbytes += 2 * b * H * 4 + n_edge * H * es + 3 * b * H * 4
        flops = 9 * 2 * n_edge * H * H
    else:      # + mask, dout f32 [B, L, H]
        nbytes += n_edge * 4 + n_node * H * 4
        flops = 6 * 2 * n_edge * H * H + 2 * 2 * n_node * H * H
    return nbytes, flops


_BWD_OUTS = ("dA", "dE", "dGn", "dW_e", "dW2", "db2", "dW3", "db3", "dsh", "dsc", "dgate")


def check_same_bits(label, first, again, what):
    """Every output of two backward calls (`what` says which) but dGn (f32
    atomics) bit for bit equal, or raise."""
    import torch
    torch.cuda.synchronize()
    moved = [n for n, u, v in zip(_BWD_OUTS, first, again)
             if n != "dGn" and not torch.equal(u, v)]
    log(f"  {label}: {what} {'bit for bit equal' if not moved else f'DIFFER in {moved}'} "
        f"in every output but dGn (f32 atomics)")
    if moved:
        raise RuntimeError(f"{label}: {what} differ in {moved}")


def check_repeats(label, call):
    check_same_bits(label, call(), call(), "two calls on the same inputs:")


def check_bwd_kernels(device, seed, dims=(B, L, K), n_nodes=None, f32_records=False):
    """K3, K4 and K5 (forward and backward) at the training shape, f32 and
    bf16, against autograd of the plain versions; K5's mask bit for bit
    against the plain generator. Returns the bf16 record of each.

    The f32 kernels are held against the plain versions run in float64 on
    the same (upcast) inputs and cotangent: in f32, autograd's weight grads
    are cuBLAS products over 786k edge rows that accumulate in f32 and carry
    ~1e-6 of the summed terms' scale themselves (~2e-3 for K4's dW_e), more
    than the f32 tolerance. The plain f32 versions remain the timing
    yardstick. bf16 kernels are held against the bf16 plain versions.
    n_nodes and f32_records: as check_kernels."""
    import torch
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    records = {}
    b, l, k = dims
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8
        x = kernel_inputs(dtype, seed, device, dims, n_nodes)
        g = torch.Generator().manual_seed(seed + 7)
        ct_sum = torch.randn(b, l, H, generator=g).to(device)
        ct_edge = torch.randn(b, l, k, H, generator=g).to(device).to(dtype)
        seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=g, dtype=torch.int32).to(device)
        edge_diff = _DIFF + ("sh", "sc", "g")
        args = lambda keys: [x[k] for k in keys]

        f32 = dtype == torch.float32
        xr = as_f64(x) if f32 else x  # the correctness reference's inputs
        ref_ct = (lambda c: c.double()) if f32 else (lambda c: c)

        def reference(fn, keys, diff, ct):
            return grads_of(fn, xr, keys, diff, ref_ct(ct))

        # K3 through K1's autograd wrapper
        _, gk, _ = grads_of(lambda *a: MK.fused_message_sum(*a, 30.0), x, _SUM_KEYS, _DIFF,
                            ct_sum)
        _, gp, _ = reference(lambda *a: MK.ref_message_sum(*a, 30.0), _SUM_KEYS, _DIFF,
                             ct_sum)
        err = compare_grads(f"K3 {dims_tag(dims, n_nodes)}", gk, gp, dname)
        del gp
        _, _, plain_bwd = grads_of(lambda *a: MK.ref_message_sum(*a, 30.0), x, _SUM_KEYS,
                                   _DIFF, ct_sum)
        sum_args = args(("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3"))
        dout = ct_sum / 30.0
        k3 = lambda: MK.message_sum_bwd(*sum_args, dout)
        check_repeats(f"K3 {dname} {dims_tag(dims, n_nodes)}", k3)
        ms, plain_ms = time_calls(k3, plain_bwd)
        # the yardstick of K3's weight-grad pass alone: its three products
        # X^T Y as torch.mm (cuBLAS) on operands of the scratch's shapes and
        # dtype ([B L K, H] twice, [B L, H]), a call and on the device
        gw = torch.Generator(device=device).manual_seed(seed + 11)
        mats = [(torch.randn(m, H, generator=gw, device=device).to(dtype),
                 torch.randn(m, H, generator=gw, device=device).to(dtype))
                for m in (b * l * k, b * l * k, b * l)]
        wgrad_lib = lambda: [torch.mm(xm.t(), ym) for xm, ym in mats]
        (lib_ms,) = time_calls(wgrad_lib)
        dev_ms, lib_dev_ms = replay_ms(k3, wgrad_lib)
        del mats
        recs = {"fused_message_sum_bwd": (err, ms, plain_ms,
                                          *bwd_bytes_flops(es, False, dims, n_nodes=n_nodes),
                                          dict(device_ms=dev_ms, wgrad_library_ms=lib_ms,
                                               wgrad_library_device_ms=lib_dev_ms))}
        del gk, plain_bwd

        # K4 through K2's autograd wrapper
        _, gk, _ = grads_of(MK.fused_message_edge_lnmod, x, _EDGE_KEYS, edge_diff, ct_edge)
        _, gp, _ = reference(MK.ref_message_edge_lnmod, _EDGE_KEYS, edge_diff, ct_edge)
        err = compare_grads(f"K4 {dims_tag(dims, n_nodes)}", gk, gp, dname)
        del gp
        _, _, plain_bwd = grads_of(MK.ref_message_edge_lnmod, x, _EDGE_KEYS, edge_diff,
                                   ct_edge)
        bwd_args = args(("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3", "sc", "g"))
        k4 = lambda: MK.message_edge_lnmod_bwd(*bwd_args, ct_edge)
        if dtype == torch.bfloat16:
            check_repeats(f"K4 {dname} {dims_tag(dims, n_nodes)}", k4)
        ms, plain_ms = time_calls(k4, plain_bwd)
        (dev_ms,) = replay_ms(k4)
        recs["fused_message_edge_lnmod_bwd"] = (err, ms, plain_ms,
                                                *bwd_bytes_flops(es, True, dims, n_nodes=n_nodes),
                                                dict(device_ms=dev_ms))
        del gk, plain_bwd

        # K5: the seeded forward's mask, its rate, its output and its backward
        out, mask = MK.edge_lnmod_pdrop_debug(*args(_EDGE_KEYS), seeds, P_DROP)
        want_mask = MK.keep_scales(seeds, (l, k, H), P_DROP)
        same = torch.equal(mask, want_mask)
        frac = (mask > 0).double().mean().item()
        want = MK.plain_message_edge_lnmod_pdrop(*args(_EDGE_KEYS), seeds, P_DROP)
        d = (out.float() - want.float()).abs()
        atol, rtol = TOL[dname]
        fwd_ok = bool((d <= atol + rtol * want.float().abs()).all())
        log(f"  K5 {dname}: mask {'equals' if same else 'DIFFERS FROM'} the plain generator's "
            f"({mask.numel()} elements); keep fraction {frac:.6f} (1-p = {1 - P_DROP:g} "
            f"+/- 0.002); forward max|d|={d.max().item():.3g} (max|d| / max|ref| "
            f"{d.max().item() / want.float().abs().max().item():.3g}) "
            f"{'ok' if fwd_ok else 'FAIL'}")
        if not (same and abs(frac - (1 - P_DROP)) <= 0.002 and fwd_ok):
            raise RuntimeError(f"K5 ({dname}) forward or mask disagrees with its plain version")
        if dtype == torch.bfloat16:
            check_k5_forward_bits(args(_EDGE_KEYS), seeds, out, mask, dims)
        del out, mask, want
        fwd_err = d.max().item()
        k5 = lambda: MK.fused_message_edge_lnmod_pdrop(*args(_EDGE_KEYS), seeds, P_DROP)
        ms, plain_ms = time_calls(
            k5, lambda: MK.plain_message_edge_lnmod_pdrop(*args(_EDGE_KEYS), seeds, P_DROP))
        (dev_ms,) = replay_ms(k5)
        k2_bytes, k2_flops = kernel_calls(x)["fused_message_edge_lnmod"][2:]
        recs["fused_message_edge_lnmod_drop"] = (fwd_err, ms, plain_ms, k2_bytes + b * 4,
                                                 k2_flops, dict(device_ms=dev_ms))
        pd = lambda *a: MK.fused_message_edge_lnmod_pdrop(*a, seeds, P_DROP)
        plain_pd = lambda *a: MK.plain_message_edge_lnmod_pdrop(*a, seeds, P_DROP)
        _, gk, _ = grads_of(pd, x, _EDGE_KEYS, edge_diff, ct_edge)
        _, gp, _ = reference(plain_pd, _EDGE_KEYS, edge_diff, ct_edge)
        err = compare_grads(f"K5 seeded {dims_tag(dims, n_nodes)}", gk, gp, dname)
        del gp
        _, _, plain_bwd = grads_of(plain_pd, x, _EDGE_KEYS, edge_diff, ct_edge)
        k5b = lambda: MK.message_edge_lnmod_bwd(*bwd_args, ct_edge, seeds=seeds, p=P_DROP)
        if dtype == torch.bfloat16:
            check_repeats(f"K5 backward {dname} {dims_tag(dims, n_nodes)}", k5b)
            # the mask the seeded backward regenerates is the forward's: the
            # keep-tensor backward given the forward's own mask (2.5 and 0,
            # exact in bf16) gives the same bits but dGn's
            _, fwd_mask = MK.edge_lnmod_pdrop_debug(*args(_EDGE_KEYS), seeds, P_DROP)
            check_same_bits(f"K5 backward {dname} {dims_tag(dims, n_nodes)}", k5b(),
                            MK.message_edge_lnmod_bwd(*bwd_args, ct_edge,
                                                      keep=fwd_mask.to(dtype)),
                            "seeded and given the forward's own mask as keep (the mask it "
                            "regenerates is the forward's):")
            del fwd_mask
        ms, plain_ms = time_calls(k5b, plain_bwd)
        (dev_ms,) = replay_ms(k5b)
        nbytes, flops = bwd_bytes_flops(es, True, dims, n_nodes=n_nodes)
        recs["fused_message_edge_lnmod_drop_bwd"] = (err, ms, plain_ms, nbytes + b * 4, flops,
                                                     dict(device_ms=dev_ms))
        del gk, plain_bwd

        # K5 with the keep operand: forward and grads
        keep = want_mask.to(dtype)
        kd = lambda *a: MK.fused_message_edge_lnmod_drop(*a, keep)
        out_k, gk, _ = grads_of(kd, x, _EDGE_KEYS, edge_diff, ct_edge)
        out_p, gp, _ = reference(lambda *a: MK.ref_message_edge_lnmod(*a, keep=keep),
                                 _EDGE_KEYS, edge_diff, ct_edge)
        d = (out_k.float() - out_p.float()).abs()
        if not bool((d <= atol + rtol * out_p.float().abs()).all()):
            raise RuntimeError(f"K5 keep variant ({dname}) forward disagrees")
        compare_grads(f"K5 keep {dims_tag(dims, n_nodes)}", gk, gp, dname)
        del gk, gp, out_k, out_p, keep, want_mask, x, xr
        torch.cuda.empty_cache()

        for name, rec in recs.items():
            records_bwd(records, name, dname, dims, *rec, n_nodes=n_nodes,
                        keep_f32=f32_records)
    return records


def check_k5_forward_bits(x, seeds, out, mask, dims):
    """The bf16 K5 forward runs K2's tensor-core kernel: given the debug
    forward's (out, mask), the seeded forward equals it and the keep-tensor
    forward given that mask (2.5 and 0, exact in bf16), a keep of ones
    equals K2, each bit for bit, and every forward repeats bit for bit;
    raise otherwise."""
    import torch
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    seeded = lambda: MK.fused_message_edge_lnmod_pdrop(*x, seeds, P_DROP)
    kept = lambda: MK.fused_message_edge_lnmod_drop(*x, mask.to(torch.bfloat16))
    ones = torch.ones_like(out)
    checks = {
        "the seeded forward equals the debug forward": (seeded(), out),
        "the keep-tensor forward given that mask equals the seeded one": (kept(), seeded()),
        "a keep of ones equals K2": (MK.fused_message_edge_lnmod_drop(*x, ones),
                                     MK.fused_message_edge_lnmod(*x)),
        "the seeded forward repeats": (seeded(), seeded()),
        "the keep-tensor forward repeats": (kept(), kept()),
        "the debug forward repeats (out, mask)": (
            torch.cat([v.float().reshape(-1) for v in
                       MK.edge_lnmod_pdrop_debug(*x, seeds, P_DROP)]),
            torch.cat([out.float().reshape(-1), mask.reshape(-1)])),
    }
    torch.cuda.synchronize()
    bad = [k for k, (a, b) in checks.items() if not torch.equal(a, b)]
    log(f"  K5 forward bfloat16 {dims_tag(dims)} (K2's tensor-core kernel): "
        f"{'; '.join(k for k in checks if k not in bad)}: bit for bit"
        + (f"; FAILED: {bad}" if bad else ""))
    if bad:
        raise RuntimeError(f"K5 forward bfloat16 {dims_tag(dims)}: {bad}")


def records_bwd(records, name, dname, dims, err, ms, plain_ms, nbytes, flops, extra,
                n_nodes=None, keep_f32=False):
    """Log one kernel's timing line (a call by CUDA events, the device by
    graph replay, `extra`'s other times) beside its bound; keep the bf16
    record, with `extra`, in `records` (with keep_f32 the f32 one too, key
    `<name>_f32`)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[dname] * 1e3
    more = "".join(f", {k} {v:.4f} ms" for k, v in extra.items() if k != "device_ms")
    if (dname == "bfloat16" and name in CUDA_CORE_BWD_MS and n_nodes is None
            and tuple(dims) in ((B, L, K), K48)):
        was = CUDA_CORE_BWD_MS[name][0 if dims[2] == K else 1]
        more += f" (the CUDA-core body's device {was:.4f} ms, {was / extra['device_ms']:.2f}x)"
    log(f"kernel {name} {dname} {dims_tag(dims, n_nodes)}: max|d|={err:.3g}; a call (events) kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; device (graph replay) kernel "
        f"{extra['device_ms']:.4f} ms{more}; bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
    if dname == "bfloat16" or keep_f32:
        key = name if dname == "bfloat16" else f"{name}_f32"
        records[key] = dict(record(name, dname, err, ms, plain_ms, t_bytes, t_ops),
                            shape=dims_tag(dims, n_nodes), **extra)


_MSG_KEYS = ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3")


def bf16_close(got, want, tol):
    """(max|d|, |d| <= tol * max|ref| everywhere)."""
    d, ref = (got.float() - want.float()).abs(), want.float().abs()
    return d.max().item(), bool((d <= tol * ref.max()).all())


def check_k6_kernels(device, seed, dims=(B, L, K)):
    """K6 (fused_message_edge) against ref_message_edge, and its backward
    against autograd of ref_message_edge (float64 for the f32 kernel, as K4),
    f32 and bf16; timed beside the bound and the plain version. Returns the
    bf16 record of each."""
    import torch
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    records = {}
    b, l, k = dims
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8
        x = kernel_inputs(dtype, seed, device, dims)
        args = [x[n] for n in _MSG_KEYS]
        n_edge = b * l * k
        chain_in = (2 * b * l * H + n_edge * H) * es + n_edge * 4 + 3 * H * H * es + 2 * H * 4
        kern = lambda: MK.fused_message_edge(*args)
        plain = lambda: MK.ref_message_edge(*args)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if dtype == torch.float32:
            d = (got - want).abs()
            err, ok = d.max().item(), bool((d <= 2e-4 + 2e-4 * want.abs()).all())
            limit = "atol 2e-4 + rtol 2e-4*|ref|"
        else:
            (err, ok), limit = bf16_close(got, want, MSG_TOL_BF16), f"{MSG_TOL_BF16:g} max|ref|"
        ms, plain_ms = time_calls(kern, plain)
        (dev_ms,) = replay_ms(kern)
        fwd = (err, ms, plain_ms, chain_in + n_edge * H * es, 3 * 2 * n_edge * H * H,
               dict(device_ms=dev_ms))
        log(f"kernel fused_message_edge {dname} {dims_tag(dims)}: max|d|={err:.3g} ({limit}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"K6 ({dname}) disagrees with its plain version")
        del got, want

        g = torch.Generator().manual_seed(seed + 9)
        ct = torch.randn(b, l, k, H, generator=g).to(device).to(dtype)
        _, gk, _ = grads_of(MK.fused_message_edge, x, _MSG_KEYS, _DIFF, ct)
        if dtype == torch.float32:
            _, gp, _ = grads_of(MK.ref_message_edge, as_f64(x), _MSG_KEYS, _DIFF, ct.double())
        else:
            _, gp, _ = grads_of(MK.ref_message_edge, x, _MSG_KEYS, _DIFF, ct)
        err = compare_grads(f"K6 bwd {dims_tag(dims)}", gk, gp, dname)
        del gk, gp
        _, _, plain_bwd = grads_of(MK.ref_message_edge, x, _MSG_KEYS, _DIFF, ct)
        bwd_args = [x[n] for n in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3")]
        k6b = lambda: MK.message_edge_bwd(*bwd_args, ct)
        if dtype == torch.bfloat16:
            check_repeats(f"K6 backward {dname} {dims_tag(dims)}", k6b)
        ms, plain_ms = time_calls(k6b, plain_bwd)
        (dev_ms,) = replay_ms(k6b)
        bwd = (err, ms, plain_ms, *bwd_bytes_flops(es, True, dims, raw=True),
               dict(device_ms=dev_ms))
        del plain_bwd, x, args, ct
        torch.cuda.empty_cache()
        for name, rec in (("fused_message_edge", fwd), ("fused_message_edge_bwd", bwd)):
            records_bwd(records, name, dname, dims, *rec)
    return records


def k7_args(dtype, seed, device, dims=(B, L, K), n_nodes=None):
    """fused_edge_then_sum's operands: K2's of one layer, K1's of the next
    (its own A, Gn, weights) and the mask, then the scale; n_nodes: see
    kernel_inputs."""
    x = kernel_inputs(dtype, seed, device, dims, n_nodes)
    y = kernel_inputs(dtype, seed + 1, device, dims, n_nodes)
    return ([x[n] for n in _EDGE_KEYS] + [y["A"], y["Gn"]]
            + [y[n] for n in ("W_e", "W2", "b2", "W3", "b3")] + [x["mask"], 30.0])


def check_k7_kernels(device, seed, dims=(B, L, K), n_nodes=None, dtypes=None):
    """K7 (fused_edge_then_sum) against ref_edge_then_sum, f32 and bf16 (or
    `dtypes`), and against K2's kernel followed by K1's kernel on the same
    inputs, whose outputs it must equal bit for bit (raises otherwise);
    timed a call beside the bound, the plain composition and that pair, and
    on the device (graph replay) beside the pair. Returns the records, the
    bf16 one keyed fused_edge_then_sum, the f32 one fused_edge_then_sum_f32
    (with tc_bound_ms). n_nodes: see kernel_inputs."""
    import torch
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    records = {}
    b, l, k = dims
    n = n_nodes or l
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8
        a = k7_args(dtype, seed, device, dims, n_nodes)
        kern = lambda: MK.fused_edge_then_sum(*a)
        plain = lambda: MK.ref_edge_then_sum(*a)

        def pair():
            e2 = MK.fused_message_edge_lnmod(*a[:12])
            return e2, MK.fused_message_sum(a[12], e2, a[13], a[3], a[19], *a[14:19], a[20])

        (e2, ns), (e2_p, ns_p), (e2_k, ns_k) = kern(), plain(), pair()
        torch.cuda.synchronize()
        d_e = (e2.float() - e2_p.float()).abs()
        d_n = (ns - ns_p).abs()
        if dtype == torch.float32:
            ok = (bool((d_e <= 2e-4 + 2e-4 * e2_p.abs()).all())
                  and bool((d_n <= 2e-4 + 2e-4 * ns_p.abs()).all()))
            limits = ("atol 2e-4 + rtol 2e-4*|ref|",) * 2
        else:
            ae, re = K7_EDGE_TOL_BF16
            ok = (bool((d_e <= ae + re * e2_p.float().abs()).all())
                  and bf16_close(ns, ns_p, MSG_TOL_BF16)[1])
            limits = (f"{ae:g} + {re:g}*|ref|", f"{MSG_TOL_BF16:g} max|ref|")
        err = max(d_e.max().item(), d_n.max().item())
        same_e, same_n = torch.equal(e2, e2_k), torch.equal(ns, ns_k)
        pair_d = (ns - ns_k).abs().max().item()
        log(f"kernel fused_edge_then_sum {dname} {dims_tag(dims, n_nodes)}: edge out max|d|="
            f"{d_e.max().item():.3g} ({limits[0]}), node sum max|d|={d_n.max().item():.3g} "
            f"({limits[1]}) {'ok' if ok else 'FAIL'}; against K2 then K1 (kernels): edge out "
            f"{'bit for bit equal' if same_e else 'DIFFERS'}, node sum "
            f"{'bit for bit equal' if same_n else f'DIFFERS (max|d|={pair_d:.3g})'}")
        if not ok:
            raise RuntimeError(f"K7 ({dname}) disagrees with its plain version")
        if not (same_e and same_n):
            raise RuntimeError(f"K7 ({dname}) is not K2's kernel then K1's, bit for bit")
        del e2, ns, e2_p, ns_p, e2_k, ns_k, d_e, d_n
        ms, plain_ms, pair_ms = time_calls(kern, plain, pair)
        dev_ms, pair_dev_ms = replay_ms(kern, pair)
        n_edge, n_node = b * l * k, b * l
        nbytes = ((n_node * H + n_edge * H + b * n * H) * es + n_edge * 4 + 3 * H * H * es
                  + 2 * H * 4 + 3 * b * H * 4                    # edge chain, sh, sc, g
                  + (n_node * H + b * n * H) * es + 3 * H * H * es + 2 * H * 4
                  + n_edge * 4                                   # node chain
                  + n_edge * H * es + n_node * H * 4)             # e2, node sum
        flops = 5 * 2 * n_edge * H * H + 2 * n_node * H * H
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_OPS[dname] * 1e3
        log(f"kernel fused_edge_then_sum {dname} {dims_tag(dims, n_nodes)}: max|d|={err:.3g}; a call "
            f"(events) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, K2 then K1 {pair_ms:.4f} ms "
            f"(K7 / pair {ms / pair_ms:.3f}); device (graph replay) kernel {dev_ms:.4f} ms, "
            f"K2 then K1 {pair_dev_ms:.4f} ms (K7 / pair {dev_ms / pair_dev_ms:.3f}); bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
        key = "fused_edge_then_sum" + ("" if dtype == torch.bfloat16 else "_f32")
        records[key] = dict(
            record("fused_edge_then_sum", dname, err, ms, plain_ms, t_bytes, t_ops),
            shape=dims_tag(dims, n_nodes), device_ms=dev_ms, pair_device_ms=pair_dev_ms)
        if dtype == torch.float32:
            records[key]["tc_bound_ms"] = tc_bound_ms(nbytes, flops)
            log(f"  fused_edge_then_sum f32 on the tensor cores (3xTF32): device "
                f"{dev_ms:.4f} ms, tensor-core bound {records[key]['tc_bound_ms']:.4f} ms, FFMA "
                f"bound {max(t_bytes, t_ops):.4f} ms")
        del a
        torch.cuda.empty_cache()
    return records


def reference_check(seed, device="cuda", adaln_mode="trunk"):
    """The path in f32 on the card (kernels) against the CPU (plain
    versions): same weights and inputs, B2 L32, in the given adaLN mode.

    * condition: each residue's K neighbours must be the same set (their
      order may differ where distances tie up to rounding: consecutive
      C-alpha are all 3.8 A apart, and every layer is invariant to the
      order of a residue's neighbours);
    * one denoise call on the CPU's condition: atol 1e-4 + rtol 1e-4;
    * 10 ancestral steps with the same x_T and per-step noise, each side on
      its own condition: 1e-4 of the latents' scale. Each residue is its own
      first neighbour, and the featurizer's quaternion of that near-identity
      rotation turns f32 rounding differences (~1e-7) into ~3e-4 between the
      devices; the sampler carries that into x_0 (and x_0 reaches hundreds
      with these random weights: sqrt(1/acp) ~ 70 at the first step);
    * the CPU's latents decoded on both sides (so that a code flip at a VQ
      boundary can neither hide nor fake a decode difference): atol 1e-3."""
    import torch
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device

    pipes = {dev: build_pipeline(dev, seed, respacing="ddim10", adaln_mode=adaln_mode)
             for dev in ("cpu", device)}
    nb = synthetic_cg_batch(2, 32, seed=seed + 1)
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((2, 32, 3), generator=g)
    zs = [torch.randn((2, 32, 3), generator=g)
          for _ in range(pipes["cpu"].process.num_timesteps)]
    batches, conds, dens, lats = {}, {}, {}, {}
    for dev, pipe in pipes.items():
        batch = batches[dev] = to_device(nb, dev)
        extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
                  "mask": batch["res_mask"]}
        with torch.no_grad():
            conds[dev] = pipe.denoiser.compute_condition(
                extras["res_type"], extras["cg_xyz"], extras["mask"])
            cond = {k: v.to(dev) for k, v in conds["cpu"].items()}
            steps = torch.full((2,), 500, device=dev)
            dens[dev] = pipe.denoiser.denoise(noise.to(dev), steps, cond).cpu()
        lats[dev] = pipe.sample_latents(extras, noise=noise.to(dev),
                                        noises=[z.to(dev) for z in zs]).cpu()
    idx_same = torch.equal(conds["cpu"]["idx"].sort(dim=-1).values,
                           conds[device]["idx"].cpu().sort(dim=-1).values)
    ref = dens["cpu"]
    d_den = (dens[device] - ref).abs()
    den_ok = bool((d_den <= 1e-4 + 1e-4 * ref.abs()).all())
    scale = lats["cpu"].abs().max().item()
    d_lat = (lats[device] - lats["cpu"]).abs().max().item()
    xyz = {dev: pipe.decode(batches[dev], lats["cpu"].to(dev))[1].cpu()
           for dev, pipe in pipes.items()}
    d_xyz = (xyz[device] - xyz["cpu"]).abs().max().item()
    log(f"reference {adaln_mode} (card f32 kernels vs CPU plain versions): kNN neighbour sets "
        f"{'equal' if idx_same else 'DIFFER'}; denoise max|d|={d_den.max().item():.3g} "
        f"(atol 1e-4 + rtol 1e-4); latents max|d|={d_lat:.3g} (tol {1e-4 * scale:.3g} = "
        f"1e-4 * max|latent| {scale:.3g}); xyz14 max|d|={d_xyz:.3g} (atol 1e-3)")
    if not (idx_same and den_ok and d_lat <= 1e-4 * scale and d_xyz <= 1e-3):
        raise RuntimeError("the card's path disagrees with the CPU reference")


TRAIN_STEPS = 20
TRACED_STEPS = 3                 # the last ones, under torch.profiler
RESID_TRAIN_STEPS = 10           # residual mode: the last one under torch.profiler


def train_launches(n_enc, n_dec, dropout, adaln_mode="trunk"):
    """Kernel launches of one training step: K1 for every node update, the
    encoder's edge update through K2 (K5 with dropout; in residual mode K6,
    its dropout outside the kernel), and their backwards."""
    if adaln_mode == "residual":
        edge = "fused_message_edge"
    else:
        edge = "fused_message_edge_lnmod" + ("_drop" if dropout > 0 else "")
    return {"fused_message_sum": n_enc + n_dec, edge: n_enc,
            "fused_message_sum_bwd": n_enc + n_dec, edge + "_bwd": n_enc}


def build_trainer(device, seed, hidden=H, layers=3, k=K, dropout=P_DROP,
                  compute_dtype=None, lr=3e-4, warmup=0, gates=False, adaln_mode="trunk",
                  self_condition=False, remat=False, class_dropout_prob=0.0, accum=1,
                  ema_decay=0.9999):
    """(model, TrainState, train_step) of the production denoiser in the
    given adaLN mode (self-conditioned, with remat, class dropout and
    gradient accumulation as asked). gates=True draws the adaLN heads small
    and random (open_gates), so that every parameter gets a gradient at the
    first step (in residual mode, that every branch reaches the loss)."""
    import torch
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    from codlad_tpu_torch.train.state import TrainState, warmup_linear_schedule
    from codlad_tpu_torch.train.steps import make_latent_step

    gen = torch.Generator().manual_seed(seed)
    model = MPNNDenoiser(gen, hidden_dim=hidden, edge_features=hidden,
                         num_encoder_layers=layers, num_decoder_layers=layers,
                         k_neighbors=k, dropout=dropout, adaln_mode=adaln_mode,
                         self_condition=self_condition, remat=remat)
    if gates:
        open_gates(model, gen)
    model.to(device)
    state = TrainState(dict(model.named_parameters()), warmup_linear_schedule(lr, warmup),
                       grad_clip=1.0, accum_steps=accum)
    process = create_diffusion(None, diffusion_steps=1000, self_condition=self_condition)
    step, _ = make_latent_step(model, process, dropout=dropout > 0, compute_dtype=compute_dtype,
                               class_dropout_prob=class_dropout_prob,
                               ema_decay=ema_decay ** (1.0 / accum))
    return model, state, step


def train_batch(n_frames, n_res, seed, device, jitter=0.0):
    """(x1, extras) of a synthetic training batch: N(0, 1) latents and random
    C-alpha walks; `jitter` (Å, N(0, jitter^2)) breaks the exact 3.8 Å ties
    of consecutive C-alpha, so that the kNN order is the same on every device."""
    import numpy as np
    import torch
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch
    nb = synthetic_cg_batch(n_frames, n_res, seed=seed)
    rng = np.random.default_rng(seed)
    cg = nb["cg_xyz_og"][:, 1:-1]
    cg = (cg + jitter * rng.standard_normal(cg.shape)).astype(np.float32)
    x1 = rng.standard_normal(nb["res_type"].shape + (3,)).astype(np.float32)
    extras = {"res_type": nb["res_type"], "cg_xyz": cg, "mask": nb["res_mask"]}
    return (torch.as_tensor(x1, device=device),
            {k: torch.as_tensor(v, device=device) for k, v in extras.items()})


CHAIN_KERNELS = ("chain_kernel", "chain_bwd_kernel", "wgrad_kernel", "sum_partials",  # csrc
                 "message_sum_f32_mma_kernel", "message_edge_lnmod_f32_mma_kernel",
                 "edge_then_sum_f32_mma_kernel", "message_sum_mma_kernel",
                 "message_edge_lnmod_mma_kernel", "edge_then_sum_mma_kernel",
                 "message_edge_mma_kernel", "message_sum_bwd_mma_kernel", "wgrad_mma_kernel",
                 "message_edge_lnmod_bwd_mma_kernel", "message_edge_bwd_mma_kernel")
STAGE1_KERNELS = ("gather_kernel", "aggregate_kernel", "fused_tp_kernel",          # csrc
                  "fused_tp_mma_kernel", "fused_tp_bwd_kernel", "fused_tp_bwd_mma_kernel")


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace_summary(prof, wall_ms, n_steps, top=12, mine=CHAIN_KERNELS,
                  label="message-chain kernels", unit="step"):
    """Log the device's busy share of the traced wall time (the union of
    kernel intervals) and the kernels by device time a `unit` (the `top`
    and every kernel named in `mine`), those of `mine` (default the message
    chains, K1-K5) also summed apart."""
    import torch
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        spans.append((e.time_range.start, e.time_range.end))
    if not by_name:
        log("  trace: no device events; device time not measured")
        return set()
    busy = busy_us(spans) / (wall_ms * 1e3)
    total = sum(us for us, _ in by_name.values())
    chain = sum(us for k, (us, _) in by_name.items() if any(c in k for c in mine))
    log(f"  trace of {n_steps} {unit}s ({wall_ms / n_steps:.2f} ms/{unit} wall): device busy "
        f"{busy:.3f} (idle {1 - busy:.3f}); kernels {total / 1e3 / n_steps:.2f} ms/{unit}, "
        f"{label} {chain / 1e3 / n_steps:.2f} ms ({chain / total:.3f}), other "
        f"{(total - chain) / 1e3 / n_steps:.2f} ms; "
        f"{sum(n for _, n in by_name.values()) // n_steps} launches a {unit}")
    for i, (name, (us, n)) in enumerate(sorted(by_name.items(), key=lambda kv: -kv[1][0])):
        if i >= top and not any(c in name for c in mine):
            continue
        log(f"  {us / 1e3 / n_steps:9.3f} ms/{unit} {n // n_steps:5d}x  {name[:100]}")
    return set(by_name)


def run_train(state, step, x1, extras, seed, n_steps, expect, traced=0, names=None):
    """n_steps training steps with every step's launches counted and held
    to `expect` (zero for any kernel it does not name); the last `traced`
    of them run under torch.profiler, whose summary is logged (and the
    names of the kernels that ran on the device added to the set `names`).
    Returns the ms of the untraced steps, the last metrics and the launch
    totals."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from codlad_tpu_torch import kernels
    cuda = x1.device.type == "cuda"
    p0 = {k: v.clone() for k, v in state.params.items()}
    e0 = {k: v.clone() for k, v in state.ema_params.items()}
    totals, times = dict.fromkeys(kernels.launch_counts(), 0), []
    with contextlib.ExitStack() as stack:
        for i in range(n_steps):
            if i == n_steps - traced:
                prof = stack.enter_context(profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            if cuda:
                torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, metrics = step(state, x1, extras, seed + i)
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = kernels.launch_counts()
            want = dict(dict.fromkeys(got, 0), **expect)
            if got != want:
                raise RuntimeError(f"training step {i} launched {got}, expected {want}")
            totals = {k: totals[k] + n for k, n in got.items()}
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise RuntimeError(f"training step {i}: loss {loss}, grad_norm {gnorm}")
    if traced:
        ran = trace_summary(prof, sum(times[n_steps - traced:]), traced)
        if names is not None:
            names |= ran
    moved = lambda a, b: any(not torch.equal(a[k], b[k]) for k in a)
    if not (moved(state.params, p0) and moved(state.ema_params, e0)):
        raise RuntimeError("the params or the EMA did not move")
    return times[:n_steps - traced], metrics, totals


def run_train_cli(seed, device="cuda", n_frames=B, n_res=L, batch=B, steps=5,
                  adaln_mode="trunk"):
    """The trainer's entry point on a synthetic feature set in a temporary
    directory, in the given adaLN mode: finite logged losses, the mode in
    its config, and a `last` checkpoint that restores into a fresh state.
    Returns the logged rows."""
    import json
    import tempfile
    import numpy as np
    import torch
    from codlad_tpu_torch.cli import train_latent as CLI
    from codlad_tpu_torch.data.cg_batch import write_synthetic_features
    from codlad_tpu_torch.data.norm import save_stats
    from codlad_tpu_torch.train.checkpoints import CheckpointManager
    from codlad_tpu_torch.train.state import TrainState

    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_features(f"{tmp}/feat", n_frames, n_res, seed=seed)
        save_stats(f"{tmp}/stats", "SMOKE", np.zeros(3, np.float32), np.ones(3, np.float32))
        state = CLI.main(["--feature_dir", f"{tmp}/feat", "--exp", f"{tmp}/exp",
                          "--stats_name", "SMOKE", "--stats_dir", f"{tmp}/stats",
                          "--batch_size", str(batch), "--max_steps", str(steps),
                          "--log_step", "1", "--save_step", str(steps), "--warmup", "100",
                          "--seed", str(seed), "--bf16", "--device", str(device),
                          "--adaln_mode", adaln_mode])
        with open(f"{tmp}/exp/metrics.jsonl") as f:
            rows = [r for r in map(json.loads, f) if r["split"] == "train"]  # not the val row
        with open(f"{tmp}/exp/config.json") as f:
            if json.load(f)["adaln_mode"] != adaln_mode:
                raise RuntimeError("the trainer's config does not record its adaLN mode")
        if [r["step"] for r in rows] != list(range(1, steps + 1)) or not all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
            raise RuntimeError(f"trainer log: {rows}")
        fresh = TrainState({k: torch.zeros_like(v) for k, v in state.params.items()},
                           lambda s: 0.0)
        CheckpointManager(f"{tmp}/exp").restore(fresh, "last")
        if fresh.step != steps or any(not torch.equal(fresh.params[k], v)
                                      for k, v in state.params.items()):
            raise RuntimeError("the trainer's `last` checkpoint does not restore its state")
    return rows


# Weights of the 2.45M whose clipped grads have opposite signs on the two
# devices (12 and 13 at seeds 0 and 1 on an NVIDIA H100 80GB HBM3, 700 W):
# ~4x room.
MAX_SIGN_FLIPS = 50


def train_reference(seed, device="cuda", hidden=H, layers=3, dropout=P_DROP,
                    adaln_mode="trunk"):
    """One f32 training step (dropout 0.6 by default) on a B2 L32 K16 batch,
    on the card (kernels) and on the CPU (plain versions), from the same
    weights, t, noise and dropout seed, in the given adaLN mode. Tolerances,
    as tests/test_torch_train_step.py holds the port against JAX: the
    featurizer's self-edge quaternions carry ~3e-4 of rounding noise on
    either device, so loss, mse and grad norm rtol 1e-3 and each
    parameter's grad 1e-3 * max|grad|. Updated
    params: AdamW's first step moves a weight by -lr * u(g), u(g) = g /
    (|g| + 1e-8) of the clipped grad g, which turns a tiny grad difference
    into a large one where g is near zero; so each weight is held at atol
    2e-5 + rtol 1e-5 plus lr times the bound on |u(g_card) - u(g_cpu)| that
    the two sides' own clipped grads give: eps |dg| / (min|g| + eps)^2 where
    the signs agree. Where they do not (a grad within its rounding of zero,
    or zero on one side only), u may differ by up to 2, so those weights are
    counted and at most MAX_SIGN_FLIPS of them may take the bound |u(g_card)|
    + |u(g_cpu)|. EMA: ema = 0.9999 p0 + 1e-4 p, from the same p0 on both
    sides, so |d ema| <= 1e-4 |d p| + two f32 roundings of ema (2^-22 |ema|).
    The kNN order must be the same on both (the dropout mask belongs to the
    (l, k) slot), so the trace is jittered off the exact 3.8 Å ties."""
    import torch
    lr, decay = 1e-3, 0.9999
    x1, extras = train_batch(2, 32, seed + 2, "cpu", jitter=0.1)
    g = torch.Generator().manual_seed(seed + 3)
    t = torch.randint(0, 1000, (2,), generator=g)
    noise = torch.randn((2, 32, 3), generator=g)
    runs = {}
    for dev in ("cpu", device):
        model, state, step = build_trainer(dev, seed, hidden=hidden, layers=layers, k=16,
                                           lr=lr, gates=True, dropout=dropout,
                                           adaln_mode=adaln_mode)
        ex = {k: v.to(dev) for k, v in extras.items()}
        with torch.no_grad():
            idx = model.compute_condition(ex["res_type"], ex["cg_xyz"], ex["mask"])["idx"]
        state, m = step(state, x1.to(dev), ex, seed, t=t.to(dev), noise=noise.to(dev))
        runs[str(dev)] = (idx.cpu(), {k: float(m[k]) for k in ("loss", "mse", "grad_norm")},
                          {k: v.cpu() for k, v in m["grads"].items()},
                          {k: v.cpu() for k, v in state.params.items()},
                          {k: v.cpu() for k, v in state.ema_params.items()})
    (idx_c, m_c, g_c, p_c, e_c), (idx_d, m_d, g_d, p_d, e_d) = runs["cpu"], runs[str(device)]
    if not torch.equal(idx_c, idx_d):
        raise RuntimeError("the kNN order differs between the devices")
    worst_g = max(((g_d[k] - v).abs().max() / (v.abs().max() + 1e-30)).item()
                  for k, v in g_c.items())
    upd = check_update(g_c, g_d, m_c["grad_norm"], m_d["grad_norm"], p_c, p_d, e_c, e_d, lr,
                       1 - decay)
    rel = {k: abs(m_d[k] - m_c[k]) / abs(m_c[k]) for k in m_c}
    log(f"train reference {adaln_mode} (card f32 kernels vs CPU plain, dropout {dropout}): loss "
        f"{m_d['loss']:.6g} vs {m_c['loss']:.6g}, grad_norm {m_d['grad_norm']:.6g} vs "
        f"{m_c['grad_norm']:.6g}; rel |d| {', '.join(f'{k} {v:.3g}' for k, v in rel.items())} "
        f"(rtol 1e-3); worst max|dgrad|/max|grad| over {len(g_c)} params {worst_g:.3g} "
        f"(tol 1e-3); {upd['msg']}")
    if not (all(v <= 1e-3 for v in rel.values()) and worst_g <= 1e-3 and upd["ok"]):
        raise RuntimeError("the card's training step disagrees with the CPU reference")


def check_update(g_c, g_d, norm_c, norm_d, p_c, p_d, e_c, e_d, lr, ema_w, clip=1.0, eps=1e-8):
    """The bounds of `train_reference` on one AdamW update from the same
    state on both sides, given the grads that reached the optimizer (g_c on
    the CPU, g_d on the card; clipped here by their norms): each weight within
    atol 2e-5 + rtol 1e-5 + lr * |u(g_card) - u(g_cpu)| where the signs
    agree, at most MAX_SIGN_FLIPS weights taking |u(g_card)| + |u(g_cpu)|;
    the EMA, whose last tick put weight ema_w on the new params, within
    ema_w |dp| + 2^-22 |ema|. Returns {ok, msg}."""
    import torch

    def clipped(g, norm):
        return {k: v.double() * min(1.0, clip / norm) for k, v in g.items()}

    gc, gd = clipped(g_c, norm_c), clipped(g_d, norm_d)
    u = lambda g: g.abs() / (g.abs() + eps)
    excess, worst_p, worst_e, flips, n_weights = 0.0, 0.0, 0.0, 0, 0
    for k, v in p_c.items():
        a, b = gc[k], gd[k]
        same = a * b > 0
        flips += int((~same & ((a != 0) | (b != 0))).sum())
        n_weights += v.numel()
        du = torch.where(same, eps * (a - b).abs() / (torch.minimum(a.abs(), b.abs())
                                                       + eps) ** 2, u(a) + u(b))
        d = (p_d[k] - v).abs().double()
        excess = max(excess, (d - (2e-5 + 1e-5 * v.abs().double() + lr * du)).max().item())
        worst_p = max(worst_p, d.max().item())
        de = (e_d[k] - e_c[k]).abs().double()
        worst_e = max(worst_e, (de - (ema_w * d + 2.0 ** -22 * e_c[k].abs().double()))
                      .max().item())
    msg = (f"updated params max|d| {worst_p:.3g}, largest excess over the bound {excess:.3g} "
           f"(atol 2e-5 + rtol 1e-5 + lr * |du| from the grads; must be <= 0); clipped grads "
           f"of opposite sign {flips} of {n_weights} weights (at most {MAX_SIGN_FLIPS}); EMA "
           f"largest excess over {ema_w:.3g} |dp| + 2^-22 |ema| {worst_e:.3g} (must be <= 0)")
    return {"ok": excess <= 0.0 and flips <= MAX_SIGN_FLIPS and worst_e <= 0.0, "msg": msg}


# ---------------------------------------------------------------------------
# The whole Stage-2 trainer (self-conditioning, class dropout, the
# loss-second-moment sampler, gradient accumulation, remat, validation,
# resume, warm start) and guided, self-conditioned sampling


def full_train_launches(heads, remat, n_enc=3, n_dec=3):
    """Kernel launches of one trunk training micro-step at dropout > 0: K1
    and K5 once a forward -- the main pass, its recomputation in the
    backward under remat, and the no-grad first pass when the
    self-conditioning coin falls heads -- and K3 and K5's backward once."""
    fwd = 1 + int(remat) + int(bool(heads))
    return {"fused_message_sum": (n_enc + n_dec) * fwd,
            "fused_message_edge_lnmod_drop": n_enc * fwd,
            "fused_message_sum_bwd": n_enc + n_dec, "fused_message_edge_lnmod_drop_bwd": n_enc}


class counted_steps:
    """Within the block, every train_step that make_latent_step builds
    (the trainer CLI's too) has its kernel launches counted: `record` gets
    (the self-conditioning coin, the launches, ms) of each call."""

    def __init__(self, device):
        self.device, self.record = device, []

    def __enter__(self):
        import torch
        from codlad_tpu_torch import kernels
        from codlad_tpu_torch.train import steps
        self._steps, self._real = steps, steps.make_latent_step
        cuda = torch.device(self.device).type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)

        def counted(*a, **k):
            train_step, eval_step = self._real(*a, **k)

            def step(*aa, **kk):
                sync()
                kernels.reset_launches()
                t0 = time.perf_counter()
                state, m = train_step(*aa, **kk)
                sync()
                self.record.append((m.get("self_cond"), kernels.launch_counts(),
                                    (time.perf_counter() - t0) * 1e3))
                return state, m
            return step, eval_step

        steps.make_latent_step = counted
        return self

    def __exit__(self, *exc):
        self._steps.make_latent_step = self._real


def run_train_full_cli(seed, device="cuda", n_frames=B, n_res=L, batch=B, steps=8, resume_to=12,
                       warm=2):
    """train_latent.main with the whole trainer on: --self_condition
    --class_dropout_prob 0.1 --t_sampler loss_second_moment --grad_accum 2
    --remat, validation every 4 epochs on a val feature set, bf16, dropout
    0.6, on synthetic features of n_frames x n_res: `steps` micro-steps, each
    one's launches held to full_train_launches of its coin; `best` and val
    rows written; then --resume to `resume_to` (restarting at `steps`, the
    best val loss replayed from metrics.jsonl, the optimizer's count going
    on) and a --model_ckpt warm start of `warm` micro-steps with a fresh
    optimizer. Returns the first run's micro-step ms, coins and launch
    totals, and the rows."""
    import json
    import os
    import tempfile
    import numpy as np
    import torch
    from codlad_tpu_torch.cli import train_latent as CLI
    from codlad_tpu_torch.data.cg_batch import write_synthetic_features
    from codlad_tpu_torch.data.norm import save_stats

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_features(f"{tmp}/feat", n_frames, n_res, seed=seed)
        write_synthetic_features(f"{tmp}/val", n_frames, n_res, seed=seed + 1)
        save_stats(f"{tmp}/stats", "SMOKE", np.zeros(3, np.float32), np.ones(3, np.float32))
        common = ["--feature_dir", f"{tmp}/feat", "--val_dir", f"{tmp}/val",
                  "--stats_name", "SMOKE", "--stats_dir", f"{tmp}/stats",
                  "--batch_size", str(batch), "--log_step", "1", "--save_step", "4",
                  "--warmup", "100", "--seed", str(seed), "--bf16", "--device", str(device),
                  "--self_condition", "--class_dropout_prob", "0.1", "--t_sampler",
                  "loss_second_moment", "--grad_accum", "2", "--remat",
                  "--val_every_epochs", "4"]
        exp = f"{tmp}/exp"
        t0 = time.perf_counter()
        with counted_steps(device) as counted:
            first = CLI.main(common + ["--exp", exp, "--max_steps", str(steps)])
        out["seconds"] = time.perf_counter() - t0
        cuda = torch.device(device).type == "cuda"
        failures = []
        totals = {}
        for i, (heads, got, _) in enumerate(counted.record):
            want = full_train_launches(heads, remat=True) if cuda else {}
            if got != dict(dict.fromkeys(got, 0), **want):
                failures.append(f"micro-step {i} (coin {heads}) launched {got}, expected {want}")
            totals = {k: totals.get(k, 0) + n for k, n in got.items()}
        rows = [json.loads(r) for r in open(f"{exp}/metrics.jsonl")]
        val = [r for r in rows if r["split"] == "val"]
        if (first.step != steps or first.opt_state["count"] != steps // 2 or len(counted.record)
                != steps or not os.path.exists(f"{exp}/best.pt") or not val
                or not all(math.isfinite(r["loss"]) for r in rows)):
            failures.append(f"the run: step {first.step}, optimizer count "
                            f"{first.opt_state['count']}, {len(counted.record)} micro-steps, "
                            f"best.pt {os.path.exists(f'{exp}/best.pt')}, rows {rows}")
        best = min(r["loss"] for r in val) if val else math.nan
        resumed = CLI.main(common + ["--exp", exp, "--max_steps", str(resume_to), "--resume"])
        text = open(f"{exp}/log.txt").read()
        rows2 = [json.loads(r) for r in open(f"{exp}/metrics.jsonl")]
        if (resumed.step != resume_to or resumed.opt_state["count"] != resume_to // 2
                or f"resumed at step {steps}" not in text
                or f"replayed from metrics.jsonl: {best:.5f}" not in text
                or [r["step"] for r in rows2 if r["split"] == "train"]
                != list(range(1, resume_to + 1))):
            failures.append(f"--resume: step {resumed.step}, count "
                            f"{resumed.opt_state['count']}, log {text[-600:]!r}")
        warmed = CLI.main(common + ["--exp", f"{tmp}/warm", "--model_ckpt", exp,
                                    "--max_steps", str(warm)])
        if (warmed.step != warm or warmed.opt_state["count"] != warm // 2
                or f"warm-started weights from {exp}/best" not in open(f"{tmp}/warm/log.txt").read()):
            failures.append(f"--model_ckpt: step {warmed.step}, count "
                            f"{warmed.opt_state['count']}")
        if failures:
            raise RuntimeError("the whole trainer: " + "; ".join(failures))
        out.update(ms=[ms for *_, ms in counted.record], coins=[c for c, *_ in counted.record],
                   totals=totals, val=[(r["step"], r["loss"]) for r in val], best=best,
                   train=[r["loss"] for r in rows if r["split"] == "train"])
    return out


def remat_memory(seed, device="cuda", n_frames=B, n_res=L, hidden=H, layers=3, k=K, steps=3):
    """The bf16 self-conditioned training step (coin heads, dropout 0.6) on
    one batch with and without remat: median ms of `steps` steps after a
    warm-up one, the peak memory, and each step's launches held to
    full_train_launches. Returns {remat: (ms list, peak GiB)}."""
    import torch
    from codlad_tpu_torch import kernels
    x1, extras = train_batch(n_frames, n_res, seed + 1, device)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    for remat in (False, True):
        model, state, step = build_trainer(device, seed, hidden=hidden, layers=layers, k=k,
                                           compute_dtype=torch.bfloat16, self_condition=True,
                                           remat=remat)
        step(state, x1, extras, seed, self_cond=True)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(steps):
            kernels.reset_launches()
            t0 = time.perf_counter()
            step(state, x1, extras, seed + 1 + i, self_cond=True)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            got = kernels.launch_counts()
            want = full_train_launches(True, remat, layers, layers) if cuda else {}
            if got != dict(dict.fromkeys(got, 0), **want):
                raise RuntimeError(f"remat={remat}: a step launched {got}, expected {want}")
        out[remat] = (times, torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0)
        del model, state, step
        if cuda:
            torch.cuda.empty_cache()
    return out


def train_full_reference(seed, device="cuda", hidden=H, layers=3):
    """Two f32 micro-steps at dropout 0 under gradient accumulation 2 on a
    B2 L32 K16 batch, self-conditioned (the coin heads, then tails), class
    dropout at 0.5 with the drop vectors of both passes injected, on the card
    and on the CPU from the same weights, t and noise: each micro-step's
    loss and grads as in `train_reference`, and the one AdamW update on the
    mean of the two (clipped by its own norm) and the EMA (two ticks at
    0.9999 ** (1/2)) within `check_update`'s bounds."""
    import torch
    lr, decay = 1e-3, 0.9999
    x1, extras = train_batch(2, 32, seed + 2, "cpu", jitter=0.1)
    g = torch.Generator().manual_seed(seed + 3)
    ts = [torch.randint(0, 1000, (2,), generator=g) for _ in range(2)]
    noises = [torch.randn((2, 32, 3), generator=g) for _ in range(2)]
    drops = [(torch.tensor([True, False]), torch.tensor([False, True])),
             (torch.tensor([False, True]), torch.tensor([True, True]))]
    runs = {}
    for dev in ("cpu", device):
        model, state, step = build_trainer(dev, seed, hidden=hidden, layers=layers, k=16, lr=lr,
                                           gates=True, dropout=0.0, self_condition=True,
                                           class_dropout_prob=0.5, accum=2, ema_decay=decay)
        ex = {k: v.to(dev) for k, v in extras.items()}
        micro = []
        for i, heads in enumerate((True, False)):
            state, m = step(state, x1.to(dev), ex, seed + i, t=ts[i].to(dev),
                            noise=noises[i].to(dev), self_cond=heads,
                            class_drop=tuple(d.to(dev) for d in drops[i]))
            micro.append(({k: float(m[k]) for k in ("loss", "mse")},
                          {k: v.double().cpu() for k, v in m["grads"].items()}))
        runs[str(dev)] = (micro, {k: v.cpu() for k, v in state.params.items()},
                          {k: v.cpu() for k, v in state.ema_params.items()},
                          state.opt_state["count"])
    (mc, p_c, e_c, n_c), (md, p_d, e_d, n_d) = runs["cpu"], runs[str(device)]
    rel, worst_g = 0.0, 0.0
    for (m_c, g_c), (m_d, g_d) in zip(mc, md):
        rel = max([rel] + [abs(m_d[k] - m_c[k]) / abs(m_c[k]) for k in m_c])
        worst_g = max([worst_g] + [((g_d[k] - v).abs().max() / (v.abs().max() + 1e-30)).item()
                                   for k, v in g_c.items()])
    mean = lambda micro: {k: v + (micro[1][1][k] - v) / 2 for k, v in micro[0][1].items()}
    norm = lambda gs: math.sqrt(sum(float((v ** 2).sum()) for v in gs.values()))
    a_c, a_d = mean(mc), mean(md)
    upd = check_update(a_c, a_d, norm(a_c), norm(a_d), p_c, p_d, e_c, e_d, lr,
                       1 - decay ** 0.5)
    log(f"train_full reference (card f32 kernels vs CPU plain, dropout 0, self-conditioning "
        f"heads then tails, class dropout injected, grad accumulation 2): losses "
        f"{[round(m['loss'], 6) for m, _ in md]} vs {[round(m['loss'], 6) for m, _ in mc]}, "
        f"largest rel |d| of loss and mse {rel:.3g} (rtol 1e-3); worst max|dgrad|/max|grad| "
        f"{worst_g:.3g} (tol 1e-3); optimizer count {n_d} (CPU {n_c}); {upd['msg']}")
    if not (rel <= 1e-3 and worst_g <= 1e-3 and upd["ok"] and n_c == n_d == 1):
        raise RuntimeError("the card's accumulated self-conditioned steps disagree with the CPU")


GUIDED_CFG = 1.5
# The guided phase's bf16 K1/K2 calls at random weights: the self-conditioned
# draw feeds pred_xstart (of order 100 early in the draw, as x_0 = (x_t -
# sqrt(1 - acp) eps) / sqrt(acp)) and a sample of order 100 late in it back
# into x_in, so the first encoder layer's K1 sums per-edge terms of order
# 1000. The kernel and the plain version round the chain's intermediates to
# bf16 at different points, which moves an output by a fraction of a bf16
# ulp of the terms it sums (~4 at 1000); where those terms cancel towards
# zero no per-element tolerance absorbs it. So a call is held at TOL plus
# half a bf16 ulp of its largest output (2^-9 max|ref|).
CALL_SCALE_TOL_BF16 = 2.0 ** -9


def guided_reference(seed, device="cuda", n_frames=4, n_res=64, hidden=H, layers=3,
                     respacing="ddim10"):
    """Small f32 draws (4 x 64 by default, `respacing` ancestral steps) on the
    card and on the CPU from the same weights, x_T and per-step noise, the C-
    alpha trace jittered off the exact 3.8 Å ties: guided at cfg 1.5 with a
    self-conditioned denoiser and process; the masked decoder with an
    injected decoding_randn; use_seq_in_encoder=False; final_adln=False.
    Both sides run on the CPU's conditioning (its kNN graph and edge
    features: the featurizer's self-edge rounding noise, ~3e-4 on either
    device, would otherwise set the drift, as `reference_check` shows), so
    the pair differs by the kernels' f32 arithmetic only: within 1e-4 of
    max|latent|. And on the card, cfg 1 against the unguided draw (u + 1
    (c - u) is c up to rounding) within the same bound."""
    import functools
    import torch
    x1, extras = train_batch(n_frames, n_res, seed + 4, "cpu", jitter=0.1)
    g = torch.Generator().manual_seed(seed + 5)
    noise = torch.randn(x1.shape, generator=g)
    randn = torch.randn(x1.shape[:2], generator=g)
    variants = {"cfg 1.5 + self_condition": (dict(self_condition=True), GUIDED_CFG),
                "decoder_mask": (dict(decoder_mask=True), 0.0),
                "use_seq_in_encoder=False": (dict(use_seq_in_encoder=False), 0.0),
                "final_adln=False": (dict(final_adln=False), 0.0)}
    k = min(K, x1.shape[1])
    zs = None
    msgs, ok = [], True
    for name, (kw, cfg) in variants.items():
        lats, cpu_condition = {}, None
        for dev in ("cpu", device):
            pipe = build_pipeline(dev, seed, hidden=hidden, layers=layers, k=k, codebook_size=64,
                                  respacing=respacing, cfg_scale=cfg, **kw)
            if cpu_condition is None:
                cpu_condition = pipe.condition
            else:
                pipe.condition = lambda ex, d=dev: {
                    k_: v.to(d) for k_, v in cpu_condition(
                        {k_: v.cpu() for k_, v in ex.items()}).items()}
            if zs is None:
                zs = [torch.randn(x1.shape, generator=g)
                      for _ in range(pipe.process.num_timesteps)]
            den = pipe.denoiser
            if kw.get("decoder_mask"):
                den.denoise = functools.partial(type(den).denoise, den,
                                                decoding_randn=randn.to(dev))
            ex = {k_: v.to(dev) for k_, v in extras.items()}
            lats[dev] = pipe.sample_latents(ex, noise=noise.to(dev),
                                            noises=[z.to(dev) for z in zs]).cpu()
            if name.startswith("cfg") and dev == device:
                pipe.cfg_scale = 1.0
                one = pipe.sample_latents(ex, noise=noise.to(dev), noises=[z.to(dev) for z in zs])
                pipe.cfg_scale = 0.0
                plain = pipe.sample_latents(ex, noise=noise.to(dev),
                                            noises=[z.to(dev) for z in zs])
                scale = plain.abs().max().item()
                d1 = (one - plain).abs().max().item()
                ok = ok and d1 <= 1e-4 * scale
                msgs.append(f"cfg 1 vs unguided on the card max|d| {d1:.3g} (tol {1e-4 * scale:.3g})")
        scale = lats["cpu"].abs().max().item()
        d = (lats[device] - lats["cpu"]).abs().max().item()
        ok = ok and d <= 1e-4 * scale and math.isfinite(scale)
        msgs.append(f"{name}: latents max|d| {d:.3g} (tol {1e-4 * scale:.3g} = 1e-4 * "
                    f"max|latent| {scale:.3g})")
    log(f"guided reference (f32, {n_frames} x {x1.shape[1]}, {len(zs)} ancestral steps, card vs "
        "CPU plain versions): " + "; ".join(msgs))
    if not ok:
        raise RuntimeError("a guided or masked draw on the card disagrees with the CPU")


def run_guided_cli(device="cuda", n_frames=96, steps=100, ensemble=2, protein=30):
    """cli.test --experiment latent --cfg_scale 1.5 with the converted trained
    weights (bf16, ancestral) on a shard of one val protein: the summary, its
    wall seconds and the launches (per draw chain_launches and a decode's)."""
    import json
    import os
    import tempfile
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import corpus_protein
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/shards")
        save_protein_shard(f"{tmp}/shards/prot_{protein:04d}.npz",
                           corpus_protein(protein, n_frames))
        kernels.reset_launches()
        t0 = time.perf_counter()
        CLI.main(["--experiment", "latent", "--latent_weights", str(LATENT_WEIGHTS),
                  "--vae_weights", str(WEIGHTS), "--stats_name", "CONV", "--stats_dir",
                  str(WEIGHTS.parent), "--num_sampling_steps", str(steps), "--num_ensemble",
                  str(ensemble), "--cfg_scale", str(GUIDED_CFG), "--data_dir",
                  f"{tmp}/shards", "--out_dir", f"{tmp}/eval", "--device", str(device)])
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        with open(f"{tmp}/eval/summary_stats.json") as f:
            summary = json.load(f)
    p = f"prot_{protein:04d}.npz"
    failures = []
    if set(summary[p]) != JAX_SUMMARY_KEYS[0] or not all(
            math.isfinite(v) for v in summary[p].values() if isinstance(v, float)):
        failures.append(f"summary of {p}: {summary[p]}")
    expect = {k: v * ensemble for k, v in {**chain_launches(steps), **decoder_launches()}.items()}
    try:
        check_launches(launches, expect if torch.device(device).type == "cuda" else {},
                       "the guided latent CLI")
    except RuntimeError as exc:
        failures.append(str(exc))
    if failures:
        raise RuntimeError("the guided latent CLI: " + "; ".join(failures))
    return summary[p], seconds, launches


def phase_train_stage2_full(seed, device, records, card):
    """Phase train_stage2_full: the trainer CLI with every option of the
    whole trainer (`run_train_full_cli`), remat's time and peak memory
    (`remat_memory`; remat's peak must be below the plain step's), and the
    accumulated self-conditioned step card against CPU
    (`train_full_reference`); adds train_full_launches to the K1, K3 and K5
    records."""
    t0 = time.perf_counter()
    full = run_train_full_cli(seed, device)
    for name in ("fused_message_sum", "fused_message_edge_lnmod_drop", "fused_message_sum_bwd",
                 "fused_message_edge_lnmod_drop_bwd"):
        records[name]["train_full_launches"] = full["totals"][name]
    log(f"  train_latent.main --bf16 --self_condition --class_dropout_prob 0.1 --t_sampler "
        f"loss_second_moment --grad_accum 2 --remat, B{B} L{L} K{K} H{H} dropout {P_DROP}: "
        f"{len(full['ms'])} micro-steps in {full['seconds']:.2f} s, median "
        f"{statistics.median(full['ms']):.2f} ms a micro-step (first {full['ms'][0]:.1f} ms), "
        f"coins {full['coins']}, launches each as full_train_launches (asserted), over the "
        f"run {full['totals']}; train losses {[round(x, 4) for x in full['train']]}; val "
        f"(step, loss) {[(s_, round(v, 4)) for s_, v in full['val']]}, best.pt written; "
        f"--resume restarted at step 8 with the best val {full['best']:.5f} replayed and ran "
        f"to 12; --model_ckpt warm start of 2 micro-steps with a fresh optimizer")
    mem = remat_memory(seed, device)
    (t_plain, pk_plain), (t_remat, pk_remat) = mem[False], mem[True]
    log(f"  self-conditioned bf16 step (coin heads) on one B{B} L{L} batch, {card}: without "
        f"remat median {statistics.median(t_plain):.2f} ms {[round(x, 2) for x in t_plain]}, "
        f"peak {pk_plain:.3f} GiB; with remat median {statistics.median(t_remat):.2f} ms "
        f"{[round(x, 2) for x in t_remat]}, peak {pk_remat:.3f} GiB (remat / plain: time "
        f"{statistics.median(t_remat) / statistics.median(t_plain):.3f}, peak "
        f"{pk_remat / pk_plain:.3f}); launches a step asserted")
    if not pk_remat < pk_plain:
        raise RuntimeError(f"remat's peak memory {pk_remat:.3f} GiB is not below the plain "
                           f"step's {pk_plain:.3f} GiB")
    train_full_reference(seed, device)
    log(f"phase train_stage2_full: {time.perf_counter() - t0:.2f} s")


def phase_guided_sampling(seed, device, records, card):
    """Phase guided_sampling: a full-width guided (cfg 1.5) draw of a
    self-conditioned bf16 denoiser (600 K1 and 300 K2 launches on the
    doubled batch and a decode's K8/K9, asserted), timed, its first and last
    steps' K1/K2 calls against the plain versions, one traced window; the
    small f32 card-vs-CPU draws (`guided_reference`); and the guided latent
    CLI on the trained weights (`run_guided_cli`); adds guided_launches to
    the K1 and K2 records."""
    import torch
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    gpipe = build_pipeline(device, seed, compute_dtype=torch.bfloat16, respacing="100",
                           self_condition=True, cfg_scale=GUIDED_CFG)
    if gpipe.denoiser.x_in.in_features != 6:
        raise RuntimeError("the self-conditioned denoiser's x_in does not read 6 channels")
    gbatch = to_device(synthetic_cg_batch(B, L, seed=seed), device)
    g_steps = gpipe.process.num_timesteps
    out = run_slice(gpipe, gbatch, gen)
    check_slice(out, B, L)
    # one denoise a step, over the condition-doubled batch
    expect = {**chain_launches(g_steps), **decoder_launches()}
    check_launches(out["launches"], expect, "the guided sampling path")
    for name in ("fused_message_sum", "fused_message_edge_lnmod"):
        records[name]["guided_launches"] = out["launches"][name]
    timed = run_slice(gpipe, gbatch, gen)
    calls = check_trained_calls(gpipe, gbatch, gen, scale_tol=CALL_SCALE_TOL_BF16)
    log(f"  guided draw (cfg {GUIDED_CFG}, self-conditioned, bf16, {g_steps} ancestral steps of "
        f"create_diffusion('100'), B{B} L{L} K{K}, {card}): first {out['seconds']:.3f} s, timed "
        f"{timed['seconds']:.3f} s ({g_steps / timed['seconds']:.2f} steps/s) + decode; "
        f"launches {out['launches']} (expected {expect}); first and last steps' calls against "
        f"the plain versions (bf16 K1/K2 within TOL + {CALL_SCALE_TOL_BF16:.3g} max|ref|): "
        + "; ".join(f"{k} {n} calls at {shape}, max|d| {err:.3g} (max|ref| {ref:.4g}), "
                    f"{bad} failed" for k, (n, err, bad, shape, ref) in calls.items()))
    want = {"fused_message_sum": 12, "fused_message_edge_lnmod": 6, **decoder_launches()}
    if ({k: v[0] for k, v in calls.items()} != want or any(v[2] for v in calls.values())
            or calls["fused_message_sum"][3] != (2 * B, L, K)):
        raise RuntimeError(f"the guided draw's kernel calls disagree with their plain versions, "
                           f"were not all seen or not on the doubled batch: {calls}")
    names = trace_sampling(gpipe, gbatch, seed)
    if not any("message_edge_lnmod_mma_kernel" in n for n in names) or any(
            "chain_kernel" in n for n in names):
        raise RuntimeError(f"the traced guided steps did not run K2 on its tensor-core kernel: "
                           f"{sorted(names)}")
    del gpipe, gbatch, out, timed
    guided_reference(seed, device)
    summary, sec, launches = run_guided_cli(device)
    log(f"  cli.test --experiment latent --cfg_scale {GUIDED_CFG} --num_ensemble 2 (trained "
        f"weights, bf16, 100 ancestral steps, prot_0030 x 96 frames, {card}): {sec:.2f} s wall; "
        + ", ".join(f"{k} {summary[k]:.4f}" for k in ("rmsd_aligned", "ged", "clash", "div"))
        + f"; launches {({k: v for k, v in launches.items() if v})} (asserted)")
    log(f"phase guided_sampling: {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# Stage 1: the recon path and its kernels K8, K9, K10


def stage1_batch(seed, device, n_frames=STAGE1[0], n_res=STAGE1[1]):
    """The Stage-1 bench batch: synthetic all-atom frames, featurized and
    padded to the bucket lattice (bench.py's stage-1 shape by default)."""
    from codlad_tpu_torch.data.batch import collate, quantize_spec, spec_for
    from codlad_tpu_torch.data.cg_batch import to_device
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    ex = synthetic_examples(n_frames, n_res, seed=seed)
    return to_device(collate(ex, quantize_spec(spec_for(ex))), device)


def _bits(t):
    """t's bit patterns (for bit-for-bit equality)."""
    import torch
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def _aggregate_order():
    """tests/_torch_aggregate_order.py, K9's summation order in torch (torch
    only; the CPU tests hold it against the TPU kernel)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tests" / "_torch_aggregate_order.py"
    spec = importlib.util.spec_from_file_location("_torch_aggregate_order", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_aggregate(kern, plain, csr, mask, msgs, n_nodes, reduce):
    """(ok, max|d|, limit) of one K9 call: within its limit of the plain
    version, bit for bit on a second call, and bit for bit the kernel's
    order emulated in torch (csr_order_aggregate); logs which failed."""
    import torch
    got, want, again = kern(), plain(), kern()
    emu = _aggregate_order().csr_order_aggregate(csr, mask, msgs, n_nodes, reduce)
    torch.cuda.synchronize()
    d, ref = (got.float() - want.float()).abs(), want.float().abs()
    if msgs.dtype == torch.float32:
        bound, limit = TOL["float32"][0] + TOL["float32"][1] * ref, "atol 2e-4 + rtol 2e-4"
    else:
        bound = AGG_TOL_BF16[0] * ref + AGG_TOL_BF16[1] * ref.max()
        limit = "2^-6 |ref| + 1e-4 max|ref|"
    checks = {"tolerance": bool((d <= bound).all()),
              "repeat": torch.equal(_bits(got), _bits(again)),
              "emulated order": torch.equal(_bits(got), _bits(emu))}
    if not all(checks.values()):
        log(f"  edge_aggregate F{msgs.shape[-1]} {reduce}: FAILED "
            f"{[k for k, v in checks.items() if not v]}")
    return all(checks.values()), d.max().item(), limit


def check_stage1_kernels(batch, seed):
    """K8, K9 and K10 against their plain versions at the recon path's
    shapes on `batch` (the atom graph, directed), f32 and bf16; timed with
    CUDA events beside the bound, the plain version and the nearest PyTorch
    call (the records' ms, plain_ms and library_ms, a call each as every
    record has them), the kernel and that call also by graph replay
    (`replay_ms`: the device's time alone, device_ms and library_device_ms
    in the records). Returns the f32 (the recon path's dtype) record of
    each, at the largest call of the encoder: K8 the layer-2 atom feature gather (F 36),
    K9 the layer-2 atom mean (F 48), K10 the layer-2 atom TP; and the bf16
    (the Stage-1 trainer's dtype) records of K8 at F 36 and K10 at the
    layer-2 atom edges, keyed edge_gather_bf16 and fused_tp_bf16."""
    import torch
    from codlad_tpu_torch.kernels import edge_kernels as EK
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.graph import make_directed_batched
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

    dev = batch["res_type"].device
    nb, nl = batch["res_type"].shape
    na = nl * 14
    edges, emask = make_directed_batched(batch["atom_edges"], batch["atom_edges_mask"])
    src = edges[..., 0].to(torch.int32).contiguous()
    dst = edges[..., 1].to(torch.int32).contiguous()
    maskf = emask.to(torch.float32)
    ne = src.shape[1]
    csr = EK.build_csr(src, maskf, na)
    n_valid = csr[1].numel()
    flat_src, flat_dst = EK._flat_index(src, na), EK._flat_index(dst, na)
    log(f"  stage-1 shape: B{nb} L{nl} atoms {na}, {ne} directed atom edges a frame "
        f"({n_valid} valid in all)")
    g = torch.Generator().manual_seed(seed + 11)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    ladder = irrep_ladder(12, 4)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8

        def report(name, label, err, ok, limit, kern, plain, library, nbytes, ops):
            if not ok:
                raise RuntimeError(f"{name} ({dname}, {label}) disagrees with its plain version")
            return timed_record(name, dname, label, err, limit, kern, plain, library, nbytes,
                                ops)

        # K8: the geometry gather [xyz | z] (F 4) and the layer-2 features (F 36)
        for F in (4, 36):
            nodes = rnd(nb, na, F).to(dtype)
            kern = lambda: EK.edge_gather(dst, maskf, nodes)
            plain = lambda: EK.ref_gather(dst, maskf, nodes)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            same = torch.equal(_bits(got), _bits(want))
            err = (got.float() - want.float()).abs().max().item()
            rec = report("edge_gather", f"F{F}", err, same, "bit for bit", kern, plain,
                         lambda: nodes.reshape(-1, F).index_select(0, flat_dst),
                         nb * ne * 8 + nb * na * F * es + nb * ne * F * es, nb * ne * F)
            if F == 36:
                records["edge_gather" + ("" if dtype == torch.float32 else "_bf16")] = rec

        # K9: the layer-0 atom mean (F 12), K8's backward at the layer-2
        # features (F 36, a sum) and the layer-2 atom mean (F 48); then a
        # graph with nodes of more than 32 edges. Bytes: the CSR (ptr and
        # the listed edge ids), the listed edges' masks and payload rows,
        # the output; idx is not read
        for F, reduce in ((12, "mean"), (36, "sum"), (48, "mean")):
            msgs = rnd(nb, ne, F).to(dtype)
            kern = lambda: EK.edge_aggregate(src, maskf, msgs, na, reduce, csr)
            plain = lambda: EK.ref_aggregate(src, maskf, msgs, na, reduce)
            ok, err, limit = check_aggregate(kern, plain, csr, maskf, msgs, na, reduce)
            lib = lambda: torch.zeros((nb * na, F), dtype=dtype, device=dev).index_add_(
                0, flat_src, msgs.reshape(-1, F))
            rec = report("edge_aggregate", f"F{F} {reduce} (run-to-run bit-equal, and to "
                         f"csr_order_aggregate)", err, ok, limit, kern, plain, lib,
                         (nb * na + 1 + n_valid) * 4 + n_valid * 4 + n_valid * F * es
                         + nb * na * F * es, 2 * n_valid * F)
            if F == 48:
                records["edge_aggregate" + ("" if dtype == torch.float32 else "_bf16")] = rec
            del msgs
        hub, hmask = src.clone(), maskf.clone()
        hub[:, :600:3], hmask[:, :600:3] = 7, 1.0        # atom 7 of each frame: 200+ edges
        hub[:, 1:600:3], hmask[:, 1:600:3] = 11, 1.0     # atom 11: 200+
        hcsr = EK.build_csr(hub, hmask, na)
        top = int((hcsr[0][1:] - hcsr[0][:-1]).max())
        msgs = rnd(nb, ne, 48).to(dtype)
        ok, err, limit = check_aggregate(
            lambda: EK.edge_aggregate(hub, hmask, msgs, na, "mean", hcsr),
            lambda: EK.ref_aggregate(hub, hmask, msgs, na, "mean"), hcsr, hmask, msgs, na,
            "mean")
        log(f"kernel edge_aggregate {dname} F48 mean, nodes of up to {top} edges: "
            f"max|d|={err:.3g} ({limit}), run-to-run and csr_order_aggregate bit-equal "
            f"{'ok' if ok else 'FAIL'}")
        if not ok or top <= 64:
            raise RuntimeError(f"edge_aggregate ({dname}) at high degree disagrees")
        del msgs, hub, hmask, hcsr

        # K10: the three layer signatures on the atom edges, and on the cross
        # graph's [B, L, 14, *] operands
        for layer in range(3):
            tb = fused_tp_tables(tuple(ladder[layer]), tuple(SH_IRREPS),
                                 tuple(ladder[layer + 1]))
            din, numel, R = ladder[layer].dim, tb["numel"], tb["R"]
            dout = tb["SUMR"].shape[1]
            nnz = TK.sparse_tables(tb)["nnz"]
            for where, lead in (("edges", (nb, ne)), ("cross", (nb, nl, 14))):
                x = rnd(*lead, din).to(dtype)
                sh = sh_l2(rnd(*lead, 3)).to(dtype)
                w = (rnd(*lead, numel) * din ** -0.5).to(dtype)
                kern = lambda: TK.fused_tp(x, sh, w, tb)
                plain = lambda: TK.ref_fused_tp(x, sh, w, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
                got, want = kern(), plain()
                torch.cuda.synchronize()
                d, ref = (got.float() - want.float()).abs(), want.float().abs()
                if dtype == torch.float32:
                    ok, limit = bool((d <= 2e-4 + 2e-4 * ref).all()), "atol 2e-4 + rtol 2e-4"
                else:
                    ok = bool((d <= TP_TOL_BF16 * ref.max()).all())
                    limit = f"{TP_TOL_BF16:g} max|ref| (max|ref| {ref.max().item():.3g})"
                tabs = [torch.as_tensor(tb[k], device=dev).to(dtype)
                        for k in ("CBIG_R", "EXPW", "SUMR")]
                t = torch.cat([x * sh[..., b:b + 1] for b in range(9)], dim=-1)
                lib = lambda: ((w @ tabs[1]) * (t @ tabs[0])) @ tabs[2]
                m = x.numel() // din
                rec = report("fused_tp", f"layer {layer} {where} {tuple(lead)}", d.max().item(),
                             ok, limit, kern, plain, lib, m * (din + 9 + numel + dout) * es,
                             m * (9 * din + 2 * nnz + 2 * R))
                if layer == 2 and where == "edges":
                    records["fused_tp" + ("" if dtype == torch.float32 else "_bf16")] = rec
                del x, sh, w, got, want, t
        torch.cuda.empty_cache()
    return records


def encoder_launches(n_layers=ENC_LAYERS):
    """K8/K9/K10 launches of one encoder forward: 4 geometry gathers, per
    layer 2 atom gathers, 1 atom mean, the atom TP and the CG->atom TP, and
    but for the last layer 2 CG gathers, 1 CG mean, the CG TP and the
    atom->CG TP."""
    n = n_layers
    return {"edge_gather": 4 + 2 * n + 2 * (n - 1), "edge_aggregate": n + (n - 1),
            "fused_tp": 2 * n + 2 * (n - 1)}


def decoder_launches(n_conv=DEC_LAYERS):
    """K8/K9 launches of one IC decode: 2 geometry gathers, and a gather and
    an aggregate per invariant message layer."""
    return {"edge_gather": 2 + n_conv, "edge_aggregate": n_conv}


def build_recon(device, seed, compute_dtype=None):
    """The recon pipeline at the production VQ-VAE config, random weights
    and a random N(0, 1) codebook of CODEBOOK codes from `seed`."""
    import torch
    from codlad_tpu_torch.eval.harness import SamplingPipeline
    from codlad_tpu_torch.models.vae import VAE
    gen = torch.Generator().manual_seed(seed)
    vae = VAE(gen, embed_dim=36, vqdim=3, dec_nconv=DEC_LAYERS, enc_nconv=ENC_LAYERS,
              compute_dtype=compute_dtype or torch.float32)
    codebook = torch.randn((CODEBOOK, 3), generator=gen)
    return SamplingPipeline(denoiser=None, process=None, vae=vae.to(device).eval(),
                            codebook=codebook.to(device), norm_mean=[0.0, 0.0, 0.0],
                            norm_std=[1.0, 1.0, 1.0])


def run_recon(pipe, batch):
    """Encode -> normalise -> snap -> decode -> metrics once, with the
    kernels' launches read around the encoder and around the rest:
    {latents, ic, xyz14, codes, metrics, seconds, encoder_seconds,
    decode_seconds (snap, decode, xyz14), enc_launches, dec_launches}."""
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.eval.harness import evaluate_structures
    cuda = batch["res_type"].device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    h = pipe.encode_latents(batch)
    sync()
    t_enc = time.perf_counter() - t0
    enc = kernels.launch_counts()
    kernels.reset_launches()
    ic, xyz, codes = pipe.decode(batch, pipe.normalise(h), return_codes=True)
    sync()
    t_dec = time.perf_counter() - t0 - t_enc
    metrics = {k: float(v) for k, v in evaluate_structures(batch, ic, xyz).items()}
    sync()
    return {"latents": h, "ic": ic, "xyz14": xyz, "codes": codes, "metrics": metrics,
            "seconds": time.perf_counter() - t0, "encoder_seconds": t_enc,
            "decode_seconds": t_dec, "enc_launches": enc,
            "dec_launches": kernels.launch_counts()}


def check_recon(out, batch):
    """Shapes, finite values and the launches of every kernel."""
    import torch
    nb, nl = batch["res_type"].shape
    shapes = {"latents": (nb, nl, 3), "ic": (nb, nl, 13, 3), "xyz14": (nb, nl, 14, 3)}
    for key, shape in shapes.items():
        v = out[key]
        if tuple(v.shape) != shape or not torch.isfinite(v).all():
            raise RuntimeError(f"recon {key}: shape {tuple(v.shape)} (expected {shape}) "
                               f"or not finite")
    if not all(math.isfinite(v) for v in out["metrics"].values()):
        raise RuntimeError(f"recon metrics not finite: {out['metrics']}")
    cuda = batch["res_type"].device.type == "cuda"   # on the CPU no kernel launches
    for part, want in (("enc_launches", encoder_launches()),
                       ("dec_launches", decoder_launches())):
        check_launches(out[part], want if cuda else {}, f"the recon path ({part})")


def code_gaps(codebook, z):
    """Squared distance from each z [..., D] to its second-nearest code minus
    that to its nearest: how far the snap is from a tie."""
    import torch
    d = ((z.reshape(-1, 1, z.shape[-1]) - codebook[None]) ** 2).sum(-1)
    two = torch.topk(d, 2, dim=-1, largest=False).values
    return (two[:, 1] - two[:, 0]).reshape(z.shape[:-1])


def recon_reference(seed, device="cuda"):
    """The recon path in f32 on the card (kernels) against the CPU (plain
    versions), same weights, on a small batch (2 frames of 40 residues):
    latents atol 1e-4 + rtol 1e-4 (sums in another order); VQ codes equal
    except where the CPU latent's two nearest codes are within CODE_MARGIN
    (squared distance) of a tie, and the flips are counted; the CPU's
    latents decoded on both sides (so that a flip can neither hide nor fake
    a decode difference) to xyz14 within atol 1e-3 Å."""
    import torch
    batches = {dev: stage1_batch(seed + 5, dev, 2, 40) for dev in ("cpu", device)}
    pipes = {dev: build_recon(dev, seed) for dev in ("cpu", device)}
    outs = {dev: run_recon(pipes[dev], batches[dev]) for dev in ("cpu", device)}
    cpu, card = outs["cpu"], outs[device]
    ref = cpu["latents"]
    d_lat = (card["latents"].cpu() - ref).abs()
    lat_ok = bool((d_lat <= 1e-4 + 1e-4 * ref.abs()).all())
    mask = batches["cpu"]["res_mask"].bool()
    flip = (card["codes"].cpu() != cpu["codes"]) & mask
    gaps = code_gaps(pipes["cpu"].codebook, ref)
    bad_flips = int((flip & (gaps > CODE_MARGIN)).sum())
    xyz = {dev: pipes[dev].decode(batches[dev], ref.to(dev))[1].cpu() for dev in pipes}
    d_xyz = (xyz[device] - xyz["cpu"]).abs().max().item()
    log(f"recon reference (card f32 kernels vs CPU plain versions, 2 x 40): latents "
        f"max|d|={d_lat.max().item():.3g} (atol 1e-4 + rtol 1e-4); VQ codes flipped "
        f"{int(flip.sum())} of {int(mask.sum())} residues, {bad_flips} of them not near-tied "
        f"(gap > {CODE_MARGIN:g}); xyz14 from the CPU latents max|d|={d_xyz:.3g} (atol 1e-3)")
    if not (lat_ok and bad_flips == 0 and d_xyz <= 1e-3):
        raise RuntimeError("the card's recon path disagrees with the CPU reference")


def recon_trained(device="cuda"):
    """The converted trained VQ-VAE on the fixture frames against the JAX
    outputs stored with them: VQ codes equal wherever the JAX latent's two
    nearest codes differ by more than CODE_MARGIN; per-frame rmsd_aligned
    within 1e-3 Å of JAX's. Returns the port's batch-mean metrics."""
    import numpy as np
    import torch
    from codlad_tpu_torch.cli.test import load_vae_weights
    from codlad_tpu_torch.convert.from_flax import read_flax_npz
    from codlad_tpu_torch.eval.harness import SamplingPipeline, evaluate_structures
    vae, snap, _ = load_vae_weights(str(WEIGHTS), device)
    codebook = snap["vq_state"].codebook
    mean, std = read_flax_npz(str(WEIGHTS))["stats"]
    pipe = SamplingPipeline(denoiser=None, process=None, vae=vae, codebook=codebook,
                            norm_mean=mean, norm_std=std)
    with np.load(FIXTURE) as fx:
        want = {k: fx[k] for k in fx.files}
    batch = {k[len("batch/"):]: torch.as_tensor(v, device=device) for k, v in want.items()
             if k.startswith("batch/")}
    out = run_recon(pipe, batch)
    per_frame = evaluate_structures(batch, out["ic"], out["xyz14"], per_frame=True)
    rmsd = per_frame["rmsd_aligned"].cpu().numpy()
    d_rmsd = np.abs(rmsd - want["metric/rmsd_aligned"]).max()
    jlat = torch.as_tensor(want["latents"], device=device)
    tied = code_gaps(codebook, jlat) <= CODE_MARGIN
    mask = batch["res_mask"].bool()
    differ = (out["codes"] != torch.as_tensor(want["codes"], device=device)) & mask
    d_lat = (out["latents"] - jlat).abs().max().item()
    m = out["metrics"]
    log(f"recon trained (weights/convergence_vqvae.npz, prot_0030 x {rmsd.size} frames): "
        f"latents max|d| vs JAX {d_lat:.3g}; codes differ at {int(differ.sum())} of "
        f"{int(mask.sum())} residues ({int((differ & ~tied).sum())} not near-tied, gap > "
        f"{CODE_MARGIN:g}); per-frame rmsd_aligned {np.round(rmsd, 5).tolist()} vs JAX "
        f"{np.round(want['metric/rmsd_aligned'], 5).tolist()}, max|d| {d_rmsd:.3g} Å (tol "
        f"1e-3); mean rmsd_aligned {m['rmsd_aligned']:.4f}, ged {m['ged']:.4f}, clash "
        f"{m['clash']:.4f} (FLOOR_TABLE.md recon over its 4 proteins, for context: "
        f"{FLOOR['rmsd_aligned']}, {FLOOR['ged']}, {FLOOR['clash']})")
    if int((differ & ~tied).sum()) or not d_rmsd <= 1e-3:
        raise RuntimeError("the trained VQ-VAE on the card disagrees with the JAX outputs")
    return m


def run_recon_cli(seed, device="cuda", batch_size=4, vae=None, n_res=(58, 75), n_frames=3):
    """The recon CLI's main on two proteins (n_res residues, n_frames frames)
    the port writes as shards, with the trained weights (`vae`: the CLI's
    VAE flag and its value, --vae_weights WEIGHTS by default):
    summary_stats.json with finite per-protein and global metrics."""
    import json
    import os
    import tempfile
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/shards")
        for i, n in enumerate(n_res):
            save_protein_shard(f"{tmp}/shards/prot_{i:04d}.npz",
                               synthetic_examples(n_frames, n, seed=seed + i, prot_idx=i,
                                                  structured=True))
        CLI.main(["--experiment", "recon", *(vae or ["--vae_weights", str(WEIGHTS)]),
                  "--data_dir", f"{tmp}/shards", "--out_dir", f"{tmp}/eval", "--batch_size",
                  str(batch_size), "--device", str(device)])
        with open(f"{tmp}/eval/summary_stats.json") as f:
            summary = json.load(f)
    glob = summary["__global__"]
    if set(summary) != {"prot_0000.npz", "prot_0001.npz", "__global__", "__global_stats__"} \
            or not all(math.isfinite(v) for v in glob.values()):
        raise RuntimeError(f"recon CLI summary: {summary}")
    return glob


# ---------------------------------------------------------------------------
# Stage 2 with the trained weights: the f32 fixture, the latent / prior CLI


def chain_launches(n_steps):
    """K1/K2 launches of n_steps denoise steps of the 3+3-layer trunk
    denoiser."""
    return {"fused_message_sum": 6 * n_steps, "fused_message_edge_lnmod": 3 * n_steps}


def row_sets_equal(a, b):
    """kNN indices [B, L, K] equal as a set per row (near-equal distances
    may come in either order; the decoder sums over all K)."""
    import torch
    return bool(torch.equal(torch.sort(a, -1).values, torch.sort(b, -1).values))


def trained_pipeline(device, compute_dtype=None, steps="100", sampler="ancestral"):
    """The sampling pipeline of the converted trained weights (EMA
    denoiser, VQ-VAE, stats); ancestral, as the CLI runs it, by default."""
    from codlad_tpu_torch.cli.test import load_vae_weights
    from codlad_tpu_torch.convert.from_flax import load_denoiser
    from codlad_tpu_torch.eval.harness import SamplingPipeline
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    den, _, (mean, std) = load_denoiser(str(LATENT_WEIGHTS), device)
    vae, snap, _ = load_vae_weights(str(WEIGHTS), device)
    return SamplingPipeline(denoiser=den, process=create_diffusion(steps), vae=vae,
                            codebook=snap["vq_state"].codebook, norm_mean=mean, norm_std=std,
                            compute_dtype=compute_dtype, sampler=sampler)


def trained_latent_run(device, n_frames=4, steps="100"):
    """The converted trained denoiser (EMA, f32) on the fixture frames:
    conditioning, one denoise of x_T at the fixture's t, a DDIM run at eta 0
    from x_T with the K1/K2 launches counted, snap, decode, per-frame
    rmsd_aligned. Returns numpy arrays and the launches."""
    import numpy as np
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.eval.harness import evaluate_structures
    pipe = trained_pipeline(device, steps=steps, sampler="ddim")
    with np.load(LATENT_FIXTURE) as fx:
        x_T, t_fix = fx["x_T"][:n_frames], int(fx["denoise_t"])
    with np.load(FIXTURE) as fx:
        batch = {k[len("batch/"):]: torch.as_tensor(fx[k][:n_frames], device=device)
                 for k in fx.files if k.startswith("batch/")}
    extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
              "mask": batch["res_mask"]}
    x_T = torch.as_tensor(x_T, device=device)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with torch.no_grad():
        cond = pipe.condition(extras)
        out = pipe.denoiser.denoise(x_T, torch.full((n_frames,), t_fix, device=device), cond)
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        lat = pipe.sample_latents(extras, noise=x_T)
        sync()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        ic, xyz, codes = pipe.decode(batch, lat, return_codes=True)
    rmsd = evaluate_structures(batch, ic, xyz, per_frame=True)["rmsd_aligned"]
    return {"idx": cond["idx"].cpu(), "denoise": out.cpu().numpy(),
            "latents": lat.cpu().numpy(), "codes": codes.cpu().numpy(),
            "rmsd": rmsd.cpu().numpy(), "mask": batch["res_mask"].cpu().numpy(),
            "codebook": pipe.codebook.cpu(), "launches": launches, "seconds": seconds,
            "steps": pipe.process.num_timesteps}


def latent_trained(device="cuda", n_frames=4, steps="100", cpu_check=True):
    """The trained denoiser on the card (f32) against the JAX fixture
    (weights/convergence_latent_fixture.npz: the JAX package on the CPU in
    f32 with exact gathers): the kNN indices as row sets, the denoise at the
    fixture's t within DENOISE_TOL of max|ref|, and, when the run has the
    fixture's 100 DDIM steps, the latents within LATENT_TOL of max|latent|
    (valid residues), VQ codes equal but where the JAX latent's two nearest
    codes are within CODE_MARGIN of a tie, per-frame rmsd_aligned within
    LATENT_RMSD_TOL Å. K1/K2 launched 6 and 3 times a step on the card.
    With cpu_check the same run on the CPU's plain versions gives the
    card/CPU drift beside the card/JAX one. Returns the card run."""
    import numpy as np
    import torch
    from codlad_tpu_torch.convert.from_flax import read_flax_npz
    with np.load(LATENT_FIXTURE) as fx:
        want = {k: fx[k][:n_frames] if fx[k].ndim else fx[k] for k in fx.files}
    cuda = torch.device(device).type == "cuda"
    runs = {device: trained_latent_run(device, n_frames, steps)}
    if cpu_check and cuda:
        runs["cpu"] = trained_latent_run("cpu", n_frames, steps)
    got = runs[device]
    if not row_sets_equal(got["idx"], torch.as_tensor(want["cond_idx"]).to(got["idx"].dtype)):
        raise RuntimeError("the trained denoiser's kNN graph differs from the JAX fixture's")
    d_den = np.abs(got["denoise"] - want["denoise_out"]).max()
    den_scale = np.abs(want["denoise_out"]).max()
    check_launches(got["launches"], chain_launches(got["steps"]) if cuda else {},
                   "the trained DDIM run")
    msg = (f"latent trained (weights/convergence_latent.npz, EMA, f32, prot_0030 x "
           f"{n_frames} frames): denoise at t {int(want['denoise_t'])} max|d| vs JAX "
           f"{d_den:.3g} (max|ref| {den_scale:.3g}, tol {DENOISE_TOL:g} of it); "
           f"{got['steps']} DDIM steps (eta 0) in {got['seconds']:.3f} s, launches "
           f"{ {k: v for k, v in got['launches'].items() if v} }")
    ok = d_den <= DENOISE_TOL * den_scale
    if got["steps"] == 100:
        m = got["mask"]
        scale = np.abs(want["latents"][m]).max()
        drift = {k: np.abs(r["latents"] - want["latents"])[m].max() / scale
                 for k, r in runs.items()}
        if "cpu" in runs:
            drift["card vs cpu"] = np.abs(got["latents"] - runs["cpu"]["latents"])[m].max() / scale
        mean, std = read_flax_npz(str(LATENT_WEIGHTS))["stats"]
        z = torch.as_tensor(want["latents"] * std + mean)
        tied = (code_gaps(got["codebook"], z) <= CODE_MARGIN).numpy()
        differ = (got["codes"] != want["codes"]) & m
        d_rmsd = np.abs(got["rmsd"] - want["metric/rmsd_aligned"]).max()
        msg += (f"; latents max|d| / max|latent| ({scale:.4g}): "
                + ", ".join(f"{k} {'vs JAX ' if k != 'card vs cpu' else ''}{v:.3g}"
                            for k, v in drift.items())
                + f" (tol {LATENT_TOL:g}); codes differ at {int(differ.sum())} of "
                f"{int(m.sum())} residues ({int((differ & ~tied).sum())} not near-tied); "
                f"per-frame rmsd_aligned {np.round(got['rmsd'], 5).tolist()} vs JAX "
                f"{np.round(want['metric/rmsd_aligned'], 5).tolist()}, max|d| {d_rmsd:.3g} Å "
                f"(tol {LATENT_RMSD_TOL:g})")
        ok = ok and drift[device] <= LATENT_TOL and not int((differ & ~tied).sum()) \
            and d_rmsd <= LATENT_RMSD_TOL
    log(msg)
    if not ok:
        raise RuntimeError("the trained denoiser disagrees with the JAX fixture")
    return got


def run_latent_cli(device="cuda", n_frames=96, steps=100, ensemble=10, proteins=(30, 31),
                   shard_dir=None):
    """cli.test --experiment latent, then prior, with the converted trained
    weights (bf16 denoiser, ancestral) on shards the port writes of the
    convergence study's val proteins (their first n_frames, by the study's
    recipe, `corpus_protein`), into `shard_dir` when given (where later
    phases read them), else into a temporary directory. Returns both
    summaries and the kernels' launches over the latent run."""
    import json
    import os
    import tempfile
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.data.shards import load_protein_shard, save_protein_shard
    from codlad_tpu_torch.data.synthetic import corpus_protein
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        shards = str(shard_dir or f"{tmp}/shards")
        os.makedirs(shards, exist_ok=True)
        out["shards"] = {}
        for i in proteins:
            path = f"{shards}/prot_{i:04d}.npz"
            save_protein_shard(path, corpus_protein(i, n_frames))
            out["shards"][os.path.basename(path)] = load_protein_shard(path)[1]
        out["shard_seconds"] = time.perf_counter() - t0
        args = ["--latent_weights", str(LATENT_WEIGHTS), "--vae_weights", str(WEIGHTS),
                "--stats_name", "CONV", "--stats_dir", str(WEIGHTS.parent),
                "--num_sampling_steps", str(steps), "--num_ensemble", str(ensemble),
                "--data_dir", shards, "--device", str(device)]
        for exp in ("latent", "prior"):
            kernels.reset_launches()
            CLI.main(["--experiment", exp, "--out_dir", f"{tmp}/eval_{exp}", *args])
            if exp == "latent":
                out["launches"] = kernels.launch_counts()
            with open(f"{tmp}/eval_{exp}/summary_stats.json") as f:
                out[exp] = json.load(f)
    return out


def check_latent_cli(out, steps, ensemble, cuda=True, hold=True):
    """The summaries' keys against the JAX CLI's, finite means, the latent
    run's launches (K1/K2 of steps x ensemble draws a protein and a decode a
    draw), and with `hold` each protein's latent means within EVAL_TOL of
    the JAX evaluation, on the JAX side of the port's own prior."""
    failures = []
    for exp in ("latent", "prior"):
        summary = out[exp]
        proteins = [k for k in summary if not k.startswith("__")]
        keys = (set(summary[proteins[0]]), set(summary[proteins[0]]["per_ensemble"][0]),
                set(summary["__global__"]), set(summary["__global_stats__"]))
        if keys != JAX_SUMMARY_KEYS:
            failures.append(f"{exp} summary keys {keys} are not the JAX CLI's")
        for p in proteins:
            if not all(math.isfinite(v) for v in summary[p].values() if isinstance(v, float)):
                failures.append(f"{exp} {p}: not finite")
    draws = ensemble * len([k for k in out["latent"] if not k.startswith("__")])
    expect = {k: v * draws for k, v in chain_launches(steps).items()}
    expect.update({k: v * draws for k, v in decoder_launches().items()})
    try:
        check_launches(out["launches"], expect if cuda else {}, "the latent CLI")
    except RuntimeError as exc:
        failures.append(str(exc))
    for p, ref in JAX_EVAL.items() if hold else ():
        lat, pri = out["latent"][p], out["prior"][p]
        for k, tol in EVAL_TOL.items():
            if not abs(lat[k] - ref["latent"][k]) <= tol:
                failures.append(f"{p} latent {k} {lat[k]:.4f}: JAX {ref['latent'][k]:.4f} "
                                f"+- {tol}")
        want_sign = ref["latent"]["rmsd_aligned"] - ref["prior"]["rmsd_aligned"]
        if (lat["rmsd_aligned"] - pri["rmsd_aligned"]) * want_sign <= 0:
            failures.append(f"{p}: latent rmsd_aligned {lat['rmsd_aligned']:.4f} is not on "
                            f"the JAX side of the port's prior {pri['rmsd_aligned']:.4f}")
    return failures


def check_trained_calls(pipe, batch, generator, scale_tol=0.0):
    """One draw of the trained pipeline on a shard batch as the CLI gives it
    (padded rows included), with every K1/K2 call of its first and last
    denoise step and every K8/K9 call of its decode held against the plain
    version on the very inputs the path gave the kernel: K1/K2 within
    TOL of their inputs' dtype (bf16 in the CLI's pipeline), K8 equal, K9
    within TOL (f32) or AGG_TOL_BF16; a bf16 K1/K2 call's limit takes
    scale_tol * its max|ref| on top (CALL_SCALE_TOL_BF16). Returns {name:
    [calls, max|d|, failed calls, shape, max|ref|]} (max|ref| the largest
    plain output, the scale max|d| is read against); on the CPU both sides
    are the plain version."""
    import torch
    from codlad_tpu_torch.kernels import edge_kernels as EK
    from codlad_tpu_torch.kernels import mpnn_kernels as MK
    from codlad_tpu_torch.nn import graph, mpnn

    seen, on = {}, {"chain": False, "edge": False}

    def note(name, got, want, bound, shape):
        d = (got.float() - want.float()).abs()
        row = seen.setdefault(name, [0, 0.0, 0, shape, 0.0])
        row[0] += 1
        row[1] = max(row[1], d.max().item())
        row[2] += int(not bool((d <= bound(want.float().abs())).all()))
        row[4] = max(row[4], want.float().abs().max().item())

    def chain_bound(dtype):
        dname = str(dtype).split(".")[-1]
        atol, rtol = TOL[dname]
        c = scale_tol if dname == "bfloat16" else 0.0
        return lambda ref: atol + rtol * ref + c * ref.max()

    def k1(*a):
        out = MK.fused_message_sum(*a)
        if on["chain"]:
            note("fused_message_sum", out, MK.ref_message_sum(*a), chain_bound(a[1].dtype),
                 tuple(a[1].shape[:3]))
        return out

    def k2(*a):
        out = MK.fused_message_edge_lnmod(*a)
        if on["chain"]:
            note("fused_message_edge_lnmod", out, MK.ref_message_edge_lnmod(*a),
                 chain_bound(a[1].dtype), tuple(a[1].shape[:3]))
        return out

    def k8(idx, mask, nodes, csr=None):
        out = EK.edge_gather(idx, mask, nodes, csr)
        if on["edge"]:
            note("edge_gather", out, EK.ref_gather(idx, mask, nodes), lambda ref: 0.0,
                 tuple(nodes.shape))
        return out

    def k9(idx, mask, msgs, n_nodes, reduce="sum", csr=None):
        out = EK.edge_aggregate(idx, mask, msgs, n_nodes, reduce, csr)
        if on["edge"]:
            bound = (chain_bound(msgs.dtype) if msgs.dtype == torch.float32 else
                     lambda ref: AGG_TOL_BF16[0] * ref + AGG_TOL_BF16[1] * ref.max())
            note("edge_aggregate", out, EK.ref_aggregate(idx, mask, msgs, n_nodes, reduce),
                 bound, tuple(msgs.shape))
        return out

    extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
              "mask": batch["res_mask"]}
    last = pipe.process.num_timesteps - 1
    saved = (mpnn.fused_message_sum, mpnn.fused_message_edge_lnmod, graph.edge_gather,
             graph.edge_aggregate)
    mpnn.fused_message_sum, mpnn.fused_message_edge_lnmod = k1, k2
    graph.edge_gather, graph.edge_aggregate = k8, k9
    try:
        lat = pipe.sample_latents(extras, generator=generator,
                                  step_hook=lambda i: on.update(chain=i in (0, last)))
        on.update(chain=False, edge=True)
        pipe.decode(batch, lat)
    finally:
        (mpnn.fused_message_sum, mpnn.fused_message_edge_lnmod, graph.edge_gather,
         graph.edge_aggregate) = saved
    return seen


# ---------------------------------------------------------------------------
# Stage 1 training: K11 and the K8/K9 backwards, the trainer's step, its CLI


def tp_bwd_cost(m, din, numel, dout, R, nnz, es, dsh=9):
    """(bytes, operations) of K11 over m rows: x, sh, w and dct read once,
    dx, dsh and dw written once; 4 nnz + 5 R + 5 dsh din operations a row
    (TR, dTR and dwR, the two transposed products, dx and dsh)."""
    return (m * ((din + dsh + numel + dout) + (din + dsh + numel)) * es,
            m * (4 * nnz + 5 * R + 5 * dsh * din))


def check_stage1_bwd_kernels(batch, seed):
    """K11 against autograd of the plain K10 (float64 for the f32 kernel,
    bf16 for the bf16 one) at K10's six shapes of the Stage-1 bench batch,
    dx, dsh and dw, timed beside its bound, the plain backward and the dense
    form's backward as cuBLAS products; then the K8 / K9 backwards (K9 over
    the dst CSR for the layer-2 atom feature gather, F 36; K8 of the
    cotangent over the valid degree for the layer-2 atom mean, F 48)
    against autograd of their plain versions. Returns the bf16 (the
    trainer's dtype) record of K11 at the layer-2 atom edges."""
    import torch
    from codlad_tpu_torch.kernels import edge_kernels as EK
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.graph import make_directed_batched
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

    dev = batch["res_type"].device
    nb, nl = batch["res_type"].shape
    na = nl * 14
    edges, emask = make_directed_batched(batch["atom_edges"], batch["atom_edges_mask"])
    src = edges[..., 0].to(torch.int32).contiguous()
    dst = edges[..., 1].to(torch.int32).contiguous()
    maskf = emask.to(torch.float32)
    ne = src.shape[1]
    g = torch.Generator().manual_seed(seed + 13)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    ladder = irrep_ladder(12, 4)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8
        ref_dt = torch.float64 if dtype == torch.float32 else dtype
        for layer in range(3):
            tb = fused_tp_tables(tuple(ladder[layer]), tuple(SH_IRREPS),
                                 tuple(ladder[layer + 1]))
            din, numel, R = ladder[layer].dim, tb["numel"], tb["R"]
            dout = tb["SUMR"].shape[1]
            nnz = TK.sparse_tables(tb)["nnz"]
            for where, lead in (("edges", (nb, ne)), ("cross", (nb, nl, 14))):
                x = rnd(*lead, din).to(dtype)
                sh = sh_l2(rnd(*lead, 3)).to(dtype)
                w = (rnd(*lead, numel) * din ** -0.5).to(dtype)
                ct = rnd(*lead, dout).to(dtype)
                got = TK.fused_tp_bwd(x, sh, w, ct, tb)
                leaves = [t.to(ref_dt).requires_grad_(True) for t in (x, sh, w)]
                out = TK.ref_fused_tp(*leaves, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
                want = torch.autograd.grad(out, leaves, ct.to(ref_dt))
                torch.cuda.synchronize()
                errs, ok = {}, True
                for name, a, b in zip(("dx", "dsh", "dw"), got, want):
                    d, ref = (a.double() - b.double()).abs(), b.double().abs()
                    if dtype == torch.float32:
                        bound = TOL[dname][0] + TOL[dname][1] * ref + GRAD_SCALE_TOL_F32 * ref.max()
                    else:
                        bound = TP_TOL_BF16 * ref.max()
                    ok = ok and bool((d <= bound).all())
                    errs[name] = (d.max().item(), ref.max().item())
                del out, want, leaves
                limit = ("atol 2e-4 + rtol 2e-4 + 2e-6 max|ref|, ref in float64"
                         if dtype == torch.float32 else f"{TP_TOL_BF16:g} max|ref|")
                pl = [t.detach().requires_grad_(True) for t in (x, sh, w)]
                pout = TK.ref_fused_tp(*pl, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
                plain = lambda: torch.autograd.grad(pout, pl, ct, retain_graph=True)
                tabs = [torch.as_tensor(tb[k], device=dev).to(dtype)
                        for k in ("CBIG_R", "EXPW", "SUMR")]

                def library():   # the dense form's backward as cuBLAS products
                    t = torch.cat([x * sh[..., b:b + 1] for b in range(9)], dim=-1)
                    dprod = ct @ tabs[2].T
                    dw = (dprod * (t @ tabs[0])) @ tabs[1].T
                    db = ((dprod * (w @ tabs[1])) @ tabs[0].T).unflatten(-1, (9, din))
                    return (db * sh[..., :, None]).sum(-2), (db * x[..., None, :]).sum(-1), dw

                kern = lambda: TK.fused_tp_bwd(x, sh, w, ct, tb)
                ms, plain_ms, lib_ms = time_calls(kern, plain, library)
                dev_ms, lib_dev_ms = replay_ms(kern, library)
                m = x.numel() // din
                nbytes, ops = tp_bwd_cost(m, din, numel, dout, R, nnz, es)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS[dname] * 1e3
                err = max(e for e, _ in errs.values())
                log(f"kernel fused_tp_bwd {dname} layer {layer} {where} {tuple(lead)}: "
                    f"max|d|/max|ref| "
                    f"{', '.join(f'{n} {e:.3g}/{r:.3g}' for n, (e, r) in errs.items())} "
                    f"({limit}) {'ok' if ok else 'FAIL'}; "
                    f"a call (events) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                    f"{lib_ms:.4f} ms; device (graph replay) kernel {dev_ms:.4f} ms, library "
                    f"{lib_dev_ms:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms "
                    f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G ops)")
                if not ok:
                    raise RuntimeError(f"fused_tp_bwd ({dname}, layer {layer} {where}) "
                                       "disagrees with plain autograd")
                if layer == 2 and where == "edges" and dtype == torch.bfloat16:
                    records["fused_tp_bwd"] = dict(
                        record("fused_tp_bwd", dname, err, ms, plain_ms, t_bytes, t_ops, lib_ms),
                        device_ms=dev_ms, library_device_ms=lib_dev_ms)
                del x, sh, w, ct, got, pl, pout
                torch.cuda.empty_cache()

        # K8's backward (K9 over the dst CSR) and K9's (K8 of ct / degree)
        csr_dst = EK.build_csr(dst, maskf, na)
        csr_src = EK.build_csr(src, maskf, na)
        nodes = rnd(nb, na, 36).to(dtype).requires_grad_(True)
        ct_e = rnd(nb, ne, 36).to(dtype)
        (got,) = torch.autograd.grad(EK.edge_gather(dst, maskf, nodes, csr_dst), nodes, ct_e)
        rl = nodes.detach().to(torch.float64 if dtype == torch.float32 else torch.float32)
        rl.requires_grad_(True)
        (want,) = torch.autograd.grad(EK.ref_gather(dst, maskf, rl), rl, ct_e.to(rl.dtype))
        d, ref = (got.double() - want.double()).abs(), want.double().abs()
        bound = (1e-5 + 1e-5 * ref) if dtype == torch.float32 else (
            2.0 ** -8 * ref + 1e-5 * ref.max())
        ok_g = bool((d <= bound).all())
        msgs = rnd(nb, ne, 48).to(dtype).requires_grad_(True)
        ct_n = rnd(nb, na, 48).to(dtype)
        (got_a,) = torch.autograd.grad(EK.edge_aggregate(src, maskf, msgs, na, "mean", csr_src),
                                       msgs, ct_n)
        rm = msgs.detach().requires_grad_(True)
        (want_a,) = torch.autograd.grad(EK.ref_aggregate(src, maskf, rm, na, "mean"), rm, ct_n)
        torch.cuda.synchronize()
        ok_a = torch.equal(got_a, want_a)
        log(f"kernel backwards {dname}: d nodes of K8 (K9 over the dst CSR, F 36) max|d| "
            f"{d.max().item():.3g} of max|ref| {ref.max().item():.3g} "
            f"({'atol 1e-5 + rtol 1e-5, ref float64' if dtype == torch.float32 else '2^-8 |ref| + 1e-5 max|ref|, ref float32'}) "
            f"{'ok' if ok_g else 'FAIL'}; d msgs of K9 mean (K8 of ct / degree, F 48) "
            f"{'bit for bit' if ok_a else 'DIFFERS'}")
        if not (ok_g and ok_a):
            raise RuntimeError(f"the K8/K9 backwards ({dname}) disagree with plain autograd")
        del nodes, msgs, got, want, got_a, want_a, rl, rm
        torch.cuda.empty_cache()
    return records


STAGE1_TRAIN_STEPS = 10


def stage1_train_launches(n_enc=ENC_LAYERS, n_dec=DEC_LAYERS):
    """K8-K11 launches of one Stage-1 training step: the encoder forward and
    the decode, and their backwards: every gather whose input needs a grad
    (all but the encoder's 4 and the decoder's 2 geometry gathers) costs a
    K9, every aggregate a K8, every K10 a K11."""
    enc, dec = encoder_launches(n_enc), decoder_launches(n_dec)
    grad_gathers = (enc["edge_gather"] - 4) + (dec["edge_gather"] - 2)
    aggregates = enc["edge_aggregate"] + dec["edge_aggregate"]
    return {"edge_gather": enc["edge_gather"] + dec["edge_gather"] + aggregates,
            "edge_aggregate": aggregates + grad_gathers,
            "fused_tp": enc["fused_tp"], "fused_tp_bwd": enc["fused_tp"]}


def build_stage1_trainer(device, seed, compute_dtype=None, n_codes=CODEBOOK,
                         enc=ENC_LAYERS, dec=DEC_LAYERS):
    """(VAE, TrainState, train_step) of the Stage-1 trainer
    (cli/train_vqvae.py `build_trainer`) at the trained config (embed 36,
    vqdim 3), random weights and a vq_init codebook from `seed`."""
    import torch
    from codlad_tpu_torch.cli import train_vqvae
    args = train_vqvae.build_parser().parse_args(
        ["-seed", str(seed), "-vqdim", "3", "-codebook_size", str(n_codes), "-enc_nconv",
         str(enc), "-dec_nconv", str(dec)] + (["-bf16"] if compute_dtype == torch.bfloat16
                                              else []))
    vae, state, step, _, _ = train_vqvae.build_trainer(args, device)
    return vae, state, step


def stage1_weights():
    """LossWeights(zeta=5, omega=3).dynamic(2), as bench.py's Stage-1 step."""
    from codlad_tpu_torch.train.losses import LossWeights
    from codlad_tpu_torch.train.steps import weights_to_array
    return weights_to_array(LossWeights(zeta=5.0, omega=3.0).dynamic(2))


def run_stage1_train(state, step, batch, n_steps, expect, traced=0):
    """n_steps Stage-1 training steps, each step's launches counted and held
    to `expect`, the loss finite and no step skipped; the last `traced`
    steps under torch.profiler (summary logged). Returns (ms of the
    untraced steps, the last metrics, the host-read ms of each step)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from codlad_tpu_torch import kernels
    cuda = batch["res_type"].device.type == "cuda"
    w = stage1_weights()
    p0 = {k: v.clone() for k, v in state.params.items()}
    times, syncs = [], []
    with contextlib.ExitStack() as stack:
        for i in range(n_steps):
            if i == n_steps - traced:
                prof = stack.enter_context(profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            if cuda:
                torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, w)
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = kernels.launch_counts()
            want = dict(dict.fromkeys(got, 0), **expect)
            if got != want:
                raise RuntimeError(f"Stage-1 training step {i} launched {got}, expected {want}")
            loss = float(metrics["loss"])
            if not math.isfinite(loss) or float(metrics["skipped"]) != 0.0:
                raise RuntimeError(f"Stage-1 training step {i}: loss {loss}, skipped "
                                   f"{float(metrics['skipped'])}")
            syncs.append(float(metrics["sync_ms"]))
    if traced:
        trace_summary(prof, sum(times[n_steps - traced:]), traced, mine=STAGE1_KERNELS,
                      label="K8-K11")
    if not any(not torch.equal(state.params[k], v) for k, v in p0.items()):
        raise RuntimeError("the Stage-1 params did not move")
    return times[:n_steps - traced], metrics, syncs


def stage1_train_reference(seed, device="cuda"):
    """One f32 Stage-1 training step on the card (kernels) and on the CPU
    (plain versions) from the same weights, VQ state and batch (2 frames of
    40 residues, 3 + 4 layers): loss within rel 1e-5, each parameter's grad
    within 1e-3 max|grad|, the VQ state (codebook, cluster_size, embed_avg)
    within 1e-5 + 1e-5 |ref|, the VQ codes equal."""
    import torch
    runs = {}
    for dev in ("cpu", device):
        _, state, step = build_stage1_trainer(dev, seed)
        batch = stage1_batch(seed + 7, dev, 2, 40)
        state, m = step(state, batch, stage1_weights(), return_grads=True)
        runs[str(dev)] = (float(m["loss"]), {k: v.cpu() for k, v in m["grads"].items()},
                          {k: v.cpu() for k, v in state.vq_state.tensors().items()},
                          float(m["skipped"]))
    (l_c, g_c, v_c, s_c), (l_d, g_d, v_d, s_d) = runs["cpu"], runs[str(device)]
    rel = abs(l_d - l_c) / abs(l_c)
    worst_g = max(((g_d[k] - v).abs().max() / (v.abs().max() + 1e-30)).item()
                  for k, v in g_c.items())
    worst_v = max(((v_d[k] - v).abs() - 1e-5 * v.abs()).max().item() for k, v in v_c.items())
    log(f"train_stage1 reference (card f32 kernels vs CPU plain, 2 x 40): loss {l_d:.7g} vs "
        f"{l_c:.7g} (rel {rel:.3g}, tol 1e-5); worst max|dgrad|/max|grad| over {len(g_c)} "
        f"params {worst_g:.3g} (tol 1e-3); VQ state largest |d| - 1e-5 |ref| {worst_v:.3g} "
        f"(must be <= 1e-5); skipped {s_d:g} / {s_c:g}")
    if not (rel <= 1e-5 and worst_g <= 1e-3 and worst_v <= 1e-5 and s_c == s_d == 0.0):
        raise RuntimeError("the card's Stage-1 training step disagrees with the CPU reference")


def run_stage1_cli(seed, device="cuda", n_res=(58, 75), n_frames=4, batch=2, enc=ENC_LAYERS,
                   dec=DEC_LAYERS, codes=CODEBOOK):
    """The Stage-1 chain through its entry points on two synthetic proteins:
    train_vqvae (-bf16, 2 epochs, then -resume for a third), extract_features
    on its checkpoint, 2 steps of train_latent on those features, and the
    recon CLI on the checkpoint. Returns {name: summary} of each step."""
    import json
    import os
    import tempfile
    from codlad_tpu_torch.cli import extract_features, train_latent, train_vqvae
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/shards")
        for i, n in enumerate(n_res):
            save_protein_shard(f"{tmp}/shards/prot_{i:04d}.npz",
                               synthetic_examples(n_frames, n, seed=seed + i, prot_idx=i,
                                                  structured=True))
        common = ["-data_dir", f"{tmp}/shards", "-logdir", f"{tmp}/vq", "-batch_size",
                  str(batch), "-vqdim", "3", "-codebook_size", str(codes), "-enc_nconv",
                  str(enc), "-dec_nconv", str(dec), "-bf16", "-seed", str(seed),
                  "--device", str(device)]
        t0 = time.perf_counter()
        first = train_vqvae.main(common + ["-nepochs", "2"])
        t1 = time.perf_counter()
        resumed = train_vqvae.main(common + ["-nepochs", "3", "-resume"])
        t2 = time.perf_counter()
        with open(f"{tmp}/vq/train_log.csv") as f:
            rows = f.read().splitlines()[1:]
        epochs = [r.split(",")[0] for r in rows]
        losses = [float(r.split(",")[1]) for r in rows]
        if epochs != ["0", "1", "2"] or not all(math.isfinite(v) for v in losses) or \
                resumed.step != first.step * 3 // 2:
            raise RuntimeError(f"train_vqvae log {rows}, steps {first.step} -> {resumed.step}")
        out["train_vqvae"] = {"epochs": epochs, "train_loss": losses,
                              "steps": resumed.step, "seconds": (t1 - t0, t2 - t1)}
        usage = extract_features.main(["--ckpt", f"{tmp}/vq", "--data_dir", f"{tmp}/shards",
                                       "--out_dir", f"{tmp}/feat", "--stats_name", "S1",
                                       "--stats_dir", f"{tmp}/stats", "--batch_size",
                                       str(batch), "--device", str(device)])
        out["extract_features"] = {"codes_active": int((usage > 0).sum()),
                                   "residues": int(usage.sum())}
        state = train_latent.main(["--feature_dir", f"{tmp}/feat", "--exp", f"{tmp}/latent",
                                   "--stats_name", "S1", "--stats_dir", f"{tmp}/stats",
                                   "--batch_size", str(batch), "--max_steps", "2",
                                   "--log_step", "1", "--save_step", "2", "--bf16",
                                   "--seed", str(seed), "--device", str(device)])
        with open(f"{tmp}/latent/metrics.jsonl") as f:
            lat = [r for r in map(json.loads, f) if r["split"] == "train"]
        if state.step != 2 or not all(math.isfinite(r["loss"]) for r in lat):
            raise RuntimeError(f"train_latent on the extracted features: {lat}")
        out["train_latent"] = {"losses": [r["loss"] for r in lat]}
        summary = CLI.main(["--experiment", "recon", "--vae_ckpt", f"{tmp}/vq", "--data_dir",
                            f"{tmp}/shards", "--out_dir", f"{tmp}/eval", "--batch_size",
                            str(n_frames), "--device", str(device)])
        glob = summary["__global__"]
        if not all(math.isfinite(v) for v in glob.values()):
            raise RuntimeError(f"recon CLI on the trained checkpoint: {glob}")
        out["test_recon"] = glob
    return out


# ---------------------------------------------------------------------------
# The rest of Stage 1: the angle VQ-VAE of the PDB / Atlas recipes, GenZProt
# and its CG prior, every quantizer, the fgae / fgvae / cgvae modes

VARIANT_STEPS = 3
# the card-vs-CPU steps' grads: each within 1e-3 max|grad| of its parameter
# plus this share of the step's largest grad (see variant_reference)
STEP_GRAD_SCALE_TOL = 1e-5
# the K3 / K4 recipe's widths (embed 36, vqdim 3, 4096 codes, 3 encoder and 4
# decoder layers); the angle decoder adds -predict_angle
RECIPE = ["-vqdim", "3", "-codebook_size", "4096", "-enc_nconv", str(ENC_LAYERS),
          "-dec_nconv", str(DEC_LAYERS)]
# every kind of models/vq.Quantizer -> (vqdim, its extra flags)
QUANTIZER_KINDS = {"vqvae": ("3", []), "cosine": ("3", []), "orthogonal": ("3", []),
                   "expire": ("3", []), "fsq": ("5", []), "rvq": ("3", []),
                   "multihead": ("3", ["-vq_heads", "3"]), "gumbel": ("3", [])}


def cgprior_launches(n_layers=ENC_LAYERS, train=False):
    """K8-K11 launches of one CGPrior forward: a gather a side of the
    [xyz | res_type] payload, per layer the full dst gather, the src
    scalars' gather, the TP and the mean; with `train` also its backward's:
    every feature gather a K9, every mean a K8, every K10 a K11."""
    n = n_layers
    if not train:
        return {"edge_gather": 2 + 2 * n, "edge_aggregate": n, "fused_tp": n}
    return {"edge_gather": 2 + 2 * n + n, "edge_aggregate": n + 2 * n, "fused_tp": n,
            "fused_tp_bwd": n}


class ModuleLaunches:
    """The kernel launches made on behalf of one submodule, counted in the
    runs that drive it: its forward's (between a forward pre-hook and a
    forward hook) and its backward's (around each autograd node that its
    forward made, by the node's pre-hook and hook: the engine runs one node
    of a device at a time). Every node reachable from the module's outputs
    that the inputs' history does not hold is its own. `counts` sums the
    launches while the context is open."""

    def __init__(self, module):
        self.module, self.counts, self._handles = module, {}, []

    def _add(self, before):
        from codlad_tpu_torch import kernels
        for k, v in kernels.launch_counts().items():
            if v != before.get(k, 0):
                self.counts[k] = self.counts.get(k, 0) + v - before.get(k, 0)

    @staticmethod
    def _nodes(tree):
        import torch
        if isinstance(tree, torch.Tensor):
            return [tree.grad_fn] if tree.grad_fn is not None else []
        items = tree.values() if isinstance(tree, dict) else (
            tree if isinstance(tree, (list, tuple)) else ())
        return [n for v in items for n in ModuleLaunches._nodes(v)]

    def __enter__(self):
        from codlad_tpu_torch import kernels
        snaps = {}

        def pre(module, args):
            snaps["forward"] = (kernels.launch_counts(), args)

        def post(module, args, out):
            before, args = snaps.pop("forward")
            self._add(before)
            theirs, todo = set(), self._nodes(args)
            while todo:
                node = todo.pop()
                if node not in theirs:
                    theirs.add(node)
                    todo.extend(n for n, _ in node.next_functions if n is not None)
            mine, todo = set(), self._nodes(out)
            while todo:
                node = todo.pop()
                if node in mine or node in theirs or type(node).__name__ == "AccumulateGrad":
                    continue
                mine.add(node)
                node.register_prehook(
                    lambda g, node=node: snaps.__setitem__(node, kernels.launch_counts()))
                node.register_hook(lambda gi, go, node=node: self._add(snaps.pop(node)))
                todo.extend(n for n, _ in node.next_functions if n is not None)

        self._handles = [self.module.register_forward_pre_hook(pre),
                         self.module.register_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()


def add_launches(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def build_variant_trainer(device, seed, extra):
    """(model, TrainState, train_step) of cli/train_vqvae.py `build_trainer`
    for the flags `extra`, random weights and quantizer state from `seed`."""
    from codlad_tpu_torch.cli import train_vqvae
    args = train_vqvae.build_parser().parse_args(["-seed", str(seed), *extra])
    model, state, step, _, _ = train_vqvae.build_trainer(args, device)
    return model, state, step


def timed_record(name, dname, label, err, limit, kern, plain, library, nbytes, ops):
    """Time a checked kernel call beside its plain version and the nearest
    PyTorch call (CUDA events; the kernel and that call also by graph
    replay), log it and return its record."""
    ms, plain_ms, lib_ms = time_calls(kern, plain, library)
    dev_ms, lib_dev_ms = replay_ms(kern, library)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dname] * 1e3
    log(f"kernel {name} {dname} {label}: max|d|={err:.3g} ({limit}) ok; a call (events) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms; device "
        f"(graph replay) kernel {dev_ms:.4f} ms, library {lib_dev_ms:.4f} ms; bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} G ops)")
    return dict(record(name, dname, err, ms, plain_ms, t_bytes, t_ops, lib_ms),
                device_ms=dev_ms, library_device_ms=lib_dev_ms, shape=label)


def check_cgprior_kernels(batch, seed):
    """K8-K11 at CGPrior's shapes on `batch`'s CG radius graph (directed),
    f32 (GenZProt's and the cgvae mode's dtype: CGPrior has no compute
    dtype, in JAX either) and bf16, against their plain versions: K8 of the
    F 4 payload and the F 12 / 24 / 36 features bit for bit; K9's means of
    the three TP outputs (F 24, 36, 48) and the sums of K8's backward over
    the dst CSR (F 12, 24, 36) within their limits, twice bit for bit and
    bit for bit csr_order_aggregate; K10 and K11 (dx, dsh, dw against
    autograd of the plain K10, float64 for f32) at the three layer
    signatures. The f32 calls of the last layer are timed and returned as
    records keyed cgprior_*; every other call is logged."""
    import torch
    from codlad_tpu_torch.kernels import edge_kernels as EK
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.graph import make_directed_batched
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

    dev = batch["res_type"].device
    nb, nl = batch["res_type"].shape
    edges, emask = make_directed_batched(batch["cg_edges"], batch["cg_edges_mask"])
    src = edges[..., 0].to(torch.int32).contiguous()
    dst = edges[..., 1].to(torch.int32).contiguous()
    maskf = emask.to(torch.float32)
    ne = src.shape[1]
    csr_src, csr_dst = EK.build_csr(src, maskf, nl), EK.build_csr(dst, maskf, nl)
    n_valid = csr_src[1].numel()
    flat_src, flat_dst = EK._flat_index(src, nl), EK._flat_index(dst, nl)
    log(f"  CGPrior's shapes: B{nb} L{nl}, {ne} directed CG edges a frame ({n_valid} valid "
        f"in all, at the batch's CG cutoff)")
    g = torch.Generator().manual_seed(seed + 17)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)
    ladder = irrep_ladder(12, 4)
    records, seen = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        es = torch.finfo(dtype).bits // 8
        timed = dtype == torch.float32
        for F in (4, 12, 24, 36):
            nodes = rnd(nb, nl, F).to(dtype)
            kern = lambda: EK.edge_gather(dst, maskf, nodes)
            plain = lambda: EK.ref_gather(dst, maskf, nodes)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.equal(_bits(got), _bits(want)):
                raise RuntimeError(f"edge_gather ({dname}, CG F{F}) is not bit for bit its "
                                   "plain version")
            seen.append(f"K8 {dname} F{F} bit for bit")
            if timed and F == 36:
                records["cgprior_edge_gather"] = timed_record(
                    "edge_gather", dname, f"CG graph F{F}", 0.0, "bit for bit", kern, plain,
                    lambda: nodes.reshape(-1, F).index_select(0, flat_dst),
                    nb * ne * 8 + nb * nl * F * es + nb * ne * F * es, nb * ne * F)
        for F, reduce, idx, csr in ((24, "mean", src, csr_src), (36, "mean", src, csr_src),
                                    (48, "mean", src, csr_src), (12, "sum", dst, csr_dst),
                                    (24, "sum", dst, csr_dst), (36, "sum", dst, csr_dst)):
            msgs = rnd(nb, ne, F).to(dtype)
            kern = lambda: EK.edge_aggregate(idx, maskf, msgs, nl, reduce, csr)
            plain = lambda: EK.ref_aggregate(idx, maskf, msgs, nl, reduce)
            ok, err, limit = check_aggregate(kern, plain, csr, maskf, msgs, nl, reduce)
            if not ok:
                raise RuntimeError(f"edge_aggregate ({dname}, CG F{F} {reduce}) disagrees")
            seen.append(f"K9 {dname} F{F} {reduce} {err:.3g}")
            if timed and F == 48:
                flat = flat_src
                records["cgprior_edge_aggregate"] = timed_record(
                    "edge_aggregate", dname, f"CG graph F{F} {reduce}", err, limit, kern, plain,
                    lambda: torch.zeros((nb * nl, F), dtype=dtype, device=dev).index_add_(
                        0, flat, msgs.reshape(-1, F)),
                    (nb * nl + 1 + n_valid) * 4 + n_valid * 4 + n_valid * F * es
                    + nb * nl * F * es, 2 * n_valid * F)
        ref_dt = torch.float64 if dtype == torch.float32 else dtype
        for layer in range(3):
            tb = fused_tp_tables(tuple(ladder[layer]), tuple(SH_IRREPS),
                                 tuple(ladder[layer + 1]))
            din, numel, R = ladder[layer].dim, tb["numel"], tb["R"]
            dout = tb["SUMR"].shape[1]
            nnz = TK.sparse_tables(tb)["nnz"]
            x = rnd(nb, ne, din).to(dtype)
            sh = sh_l2(rnd(nb, ne, 3)).to(dtype)
            w = (rnd(nb, ne, numel) * din ** -0.5).to(dtype)
            ct = rnd(nb, ne, dout).to(dtype)
            kern = lambda: TK.fused_tp(x, sh, w, tb)
            plain = lambda: TK.ref_fused_tp(x, sh, w, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
            got, want = kern(), plain()
            torch.cuda.synchronize()
            d, ref = (got.float() - want.float()).abs(), want.float().abs()
            if dtype == torch.float32:
                ok, limit = bool((d <= 2e-4 + 2e-4 * ref).all()), "atol 2e-4 + rtol 2e-4"
            else:
                ok, limit = bool((d <= TP_TOL_BF16 * ref.max()).all()), "2e-2 max|ref|"
            if not ok:
                raise RuntimeError(f"fused_tp ({dname}, CG layer {layer}) disagrees")
            seen.append(f"K10 {dname} layer {layer} {d.max().item():.3g}")
            tabs = [torch.as_tensor(tb[k], device=dev).to(dtype) for k in
                    ("CBIG_R", "EXPW", "SUMR")]

            def dense_tp():
                t = torch.cat([x * sh[..., b:b + 1] for b in range(9)], dim=-1)
                return ((w @ tabs[1]) * (t @ tabs[0])) @ tabs[2]

            m = nb * ne
            if timed and layer == 2:
                records["cgprior_fused_tp"] = timed_record(
                    "fused_tp", dname, f"CG layer {layer} {(nb, ne)}", d.max().item(), limit,
                    kern, plain, dense_tp, m * (din + 9 + numel + dout) * es,
                    m * (9 * din + 2 * nnz + 2 * R))
            bgot = TK.fused_tp_bwd(x, sh, w, ct, tb)
            leaves = [v.to(ref_dt).requires_grad_(True) for v in (x, sh, w)]
            bwant = torch.autograd.grad(TK.ref_fused_tp(*leaves, tb["CBIG_R"], tb["EXPW"],
                                                        tb["SUMR"]), leaves, ct.to(ref_dt))
            torch.cuda.synchronize()
            err = 0.0
            for name, a, b in zip(("dx", "dsh", "dw"), bgot, bwant):
                d, ref = (a.double() - b.double()).abs(), b.double().abs()
                bound = (TOL["float32"][0] + TOL["float32"][1] * ref
                         + GRAD_SCALE_TOL_F32 * ref.max()) if dtype == torch.float32 else (
                    TP_TOL_BF16 * ref.max())
                if not bool((d <= bound).all()):
                    raise RuntimeError(f"fused_tp_bwd ({dname}, CG layer {layer}) {name} "
                                       "disagrees with plain autograd")
                err = max(err, d.max().item())
            seen.append(f"K11 {dname} layer {layer} {err:.3g}")
            if timed and layer == 2:
                pl = [v.detach().requires_grad_(True) for v in (x, sh, w)]
                pout = TK.ref_fused_tp(*pl, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])

                def dense_bwd():
                    t = torch.cat([x * sh[..., b:b + 1] for b in range(9)], dim=-1)
                    dprod = ct @ tabs[2].T
                    dw = (dprod * (t @ tabs[0])) @ tabs[1].T
                    db = ((dprod * (w @ tabs[1])) @ tabs[0].T).unflatten(-1, (9, din))
                    return (db * sh[..., :, None]).sum(-2), (db * x[..., None, :]).sum(-1), dw

                nbytes, ops = tp_bwd_cost(m, din, numel, dout, R, nnz, es)
                records["cgprior_fused_tp_bwd"] = timed_record(
                    "fused_tp_bwd", dname, f"CG layer {layer} {(nb, ne)}", err,
                    "atol 2e-4 + rtol 2e-4 + 2e-6 max|ref|, ref in float64",
                    lambda: TK.fused_tp_bwd(x, sh, w, ct, tb),
                    lambda: torch.autograd.grad(pout, pl, ct, retain_graph=True), dense_bwd,
                    nbytes, ops)
            del x, sh, w, ct, got, want, bgot, bwant, leaves
        torch.cuda.empty_cache()
    log("  CGPrior's kernel calls held: " + "; ".join(seen))
    return records


def _variant_step(dev, seed, extra, n_frames, n_res, eps, dtype=None):
    """(loss, grads on the CPU, VQ state tensors on the CPU, skipped) of one
    training step of the trainer of `extra` on `dev`; dtype float64 runs the
    CPU's plain versions in float64 from end to end (params, VQ state and
    batch cast, and the encoder's compute dtype)."""
    import torch
    model, state, step = build_variant_trainer(dev, seed, extra)
    batch = stage1_batch(seed + 7, dev, n_frames, n_res)
    if dtype is not None:
        model.to(dtype)
        model.encoder.compute_dtype = dtype
        state.params = {k: v.to(dtype) for k, v in state.params.items()}
        if state.vq_state is not None:
            state.vq_state = type(state.vq_state)(**{k: v.to(dtype) for k, v in
                                                     state.vq_state.tensors().items()})
        batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    state, m = step(state, batch, stage1_weights(), return_grads=True,
                    draws={"eps": eps.to(dev, dtype or torch.float32)})
    vq = state.vq_state.tensors() if state.vq_state is not None else {}
    return (float(m["loss"]), {k: v.cpu() for k, v in m["grads"].items()},
            {k: v.cpu() for k, v in vq.items()}, float(m["skipped"]))


def variant_reference(seed, device="cuda", n_frames=2, n_res=40, enc=ENC_LAYERS, dec=DEC_LAYERS):
    """One f32 training step card vs CPU (kernels vs plain versions) from the
    same weights, batch and draws (the reparametrisation's eps drawn on the
    CPU) for GenZProt, the angle VQ-VAE (K3/K4 widths) and the fgvae VAE:
    loss within rel 1e-5; the VQ state within 1e-5 + 1e-5 |ref|; each
    parameter's grad within 1e-3 of its max|grad| plus STEP_GRAD_SCALE_TOL
    times the step's largest grad, or else, where the f32 step itself is
    that far from exact (random weights decode to degenerate geometry, where
    the IC-to-xyz chain is ill-conditioned in f32), no further from a
    float64 step on the CPU than twice the CPU's f32 grad is (+ 1e-6 of the
    step's largest grad). Returns {section: (card loss, CPU loss, worst
    grad)}."""
    import torch
    out = {}
    recipe = RECIPE[:4] + ["-enc_nconv", str(enc), "-dec_nconv", str(dec)]
    for label, extra in (("ivae", recipe + ["-train_section", "ivae"]),
                         ("angle vqvae", recipe + ["-predict_angle"]),
                         ("fgvae", recipe[2:] + ["-train_section", "fgvae", "-vqdim", "36"])):
        eps = torch.randn((n_frames, stage1_batch(seed + 7, "cpu", n_frames, n_res)[
            "res_type"].shape[1], 36), generator=torch.Generator().manual_seed(seed + 8))
        l_c, g_c, v_c, s_c = _variant_step("cpu", seed, extra, n_frames, n_res, eps)
        l_d, g_d, v_d, s_d = _variant_step(device, seed, extra, n_frames, n_res, eps)
        rel = abs(l_d - l_c) / abs(l_c)
        # a parameter whose grad is a cancelling sum over the edges (an edge
        # embedding's bias) keeps the f32 order error of its terms, which
        # its own max can be far below: hence the step-scale term
        scale = max(v.abs().max().item() for v in g_c.values())
        errs = sorted((((g_d[k] - v).abs().max().item() - STEP_GRAD_SCALE_TOL * scale)
                       / (v.abs().max().item() + 1e-30), k, v.abs().max().item())
                      for k, v in g_c.items())
        worst_g = errs[-1][0]
        refereed = ""
        if worst_g > 1e-3:
            l_64, g_64, _, _ = _variant_step("cpu", seed, extra, n_frames, n_res, eps,
                                             torch.float64)
            far = [k for e, k, _ in errs if e > 1e-3]
            ratios = {k: ((g_d[k].double() - g_64[k]).abs().max().item() - 1e-6 * scale)
                      / max((g_c[k].double() - g_64[k]).abs().max().item(), 1e-30)
                      for k in far}
            top = sorted(ratios.items(), key=lambda kv: kv[1])[-3:]
            refereed = (f"; against a float64 CPU step (loss {l_64:.7g}), the card's "
                        f"distance / the CPU f32's over the {len(far)} params outside it, "
                        f"largest {[(k, round(v, 3)) for k, v in top]} (tol 2)")
            if abs(l_64 - l_c) > 1e-4 * abs(l_c) or max(ratios.values()) > 2.0:
                worst_g = float("inf")
            else:
                worst_g = max([e for e, k, _ in errs if k not in far] or [0.0])
        worst_v = max([((v_d[k] - v).abs() - 1e-5 * v.abs()).max().item()
                       for k, v in v_c.items()] or [0.0])
        log(f"  {label} step card vs CPU (f32, {n_frames} x {n_res}): loss {l_d:.7g} vs "
            f"{l_c:.7g} (rel {rel:.3g}, tol 1e-5); worst (max|dgrad| - "
            f"{STEP_GRAD_SCALE_TOL:g} x {scale:.3g}, the step's largest grad) / max|grad| over "
            f"{len(g_c)} params {errs[-1][0]:.3g} (tol 1e-3; the three worst "
            f"{[(k, f'{e:.3g}', f'max|grad| {m:.3g}') for e, k, m in errs[-3:]]}){refereed}; "
            f"VQ state largest |d| - 1e-5 |ref| {worst_v:.3g} (<= 1e-5); skipped {s_d:g} / "
            f"{s_c:g}")
        if not (rel <= 1e-5 and worst_g <= 1e-3 and worst_v <= 1e-5 and s_c == s_d == 0.0):
            raise RuntimeError(f"the card's {label} training step disagrees with the CPU")
        out[label] = (l_d, l_c, errs[-1][0])
    return out


def run_quantizer_kinds(seed, device="cuda", n_frames=2, n_res=40):
    """One f32 training step of each quantizer kind on the card and on the
    CPU (1 + 1 layers, 64 codes), the same weights, batch and draws (the
    Gumbel noise or the expiry rows drawn on the CPU): the card's K8-K11
    launches asserted, the loss finite, no skip, within rel 1e-4 of the
    CPU's, the codes' perplexity within rel 1e-5 (the same histogram, its
    entropy summed in another order), and the updated VQ state (each
    stage's or head's codebook, cluster sizes and sums) within 1e-5 +
    1e-5 |ref| of the CPU's. Returns {kind: (loss, perplexity, rel, largest
    |d| - 1e-5 |ref| of the state, worst grad)}, the worst grad being
    variant_reference's (max|dgrad| - STEP_GRAD_SCALE_TOL x the step's
    largest grad) / max|grad| over the params, logged and not held."""
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.models.vq import gumbel_noise, state_tree
    cuda = torch.device(device).type == "cuda"
    out = {}
    for kind, (vqdim, extra) in QUANTIZER_KINDS.items():
        flags = ["-quantize_type", kind, "-vqdim", vqdim, "-codebook_size", "64",
                 "-enc_nconv", "1", "-dec_nconv", "1", *extra]
        runs, draws = {}, {}
        n_rows = n_frames * stage1_batch(seed + 9, "cpu", n_frames, n_res)["res_type"].shape[1]
        g = torch.Generator().manual_seed(seed + 10)
        if kind == "gumbel":
            draws["quantizer"] = gumbel_noise((n_rows, 64), g)
        elif kind == "expire":
            draws["quantizer"] = torch.randint(0, n_rows, (64,), generator=g)
        for dev in ("cpu", device):
            _, state, step = build_variant_trainer(dev, seed, flags)
            batch = stage1_batch(seed + 9, dev, n_frames, n_res)
            kernels.reset_launches()
            state, m = step(state, batch, stage1_weights(), return_grads=True,
                            draws={k: v.to(dev) for k, v in draws.items()})
            got = kernels.launch_counts()
            if str(dev) != "cpu" and cuda:
                want = dict(dict.fromkeys(got, 0), **stage1_train_launches(1, 1))
                if got != want:
                    raise RuntimeError(f"the {kind} step launched {got}, expected {want}")
            tree = state_tree(state.vq_state)
            tree = [] if tree is None else tree if isinstance(tree, list) else [tree]
            vq = {f"{i}.{k}": v.cpu() for i, t in enumerate(tree) for k, v in t.items()}
            runs[str(dev)] = (float(m["loss"]), float(m["vq_perplexity"]), float(m["skipped"]),
                              vq, {k: v.cpu() for k, v in m["grads"].items()})
        (l_c, p_c, s_c, v_c, g_c), (l_d, p_d, s_d, v_d, g_d) = runs["cpu"], runs[str(device)]
        rel = abs(l_d - l_c) / abs(l_c)
        worst_v = max([((v_d[k] - v).abs() - 1e-5 * v.abs()).max().item()
                       for k, v in v_c.items()] or [0.0])
        scale = max(v.abs().max().item() for v in g_c.values())
        worst_g = max(((g_d[k] - v).abs().max().item() - STEP_GRAD_SCALE_TOL * scale)
                      / (v.abs().max().item() + 1e-30) for k, v in g_c.items())
        if not (math.isfinite(l_d) and s_c == s_d == 0.0 and rel <= 1e-4
                and abs(p_d - p_c) <= 1e-5 * p_c and worst_v <= 1e-5
                and v_c.keys() == v_d.keys()):
            raise RuntimeError(f"the {kind} step on the card: loss {l_d} vs CPU {l_c}, "
                               f"perplexity {p_d} vs {p_c}, VQ state largest |d| - 1e-5 |ref| "
                               f"{worst_v} (<= 1e-5), skipped {s_d} / {s_c}")
        out[kind] = (l_d, p_d, rel, worst_v, worst_g)
    return out


def run_variant_cli(seed, device="cuda", n_res=(58, 75), n_frames=4, batch=2,
                    enc=ENC_LAYERS, dec=DEC_LAYERS, codes=4096, members=2):
    """The rest of Stage 1 through its entry points on two synthetic
    proteins, an epoch each: train_vqvae -train_section ivae then cli.test
    --experiment genzprot (`members` draws a protein, the K8-K11 launches
    of each draw asserted: the CG prior's forward and a decode);
    train_vqvae -predict_angle -quantize_type fsq_5 -bf16 (vqdim 5) then
    extract_features and cli.test --experiment recon; train_vqvae
    -train_section fgvae then extract_features --learn_sigma. Returns
    {name: summary}."""
    import os
    import tempfile
    import numpy as np
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.cli import extract_features, train_vqvae
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    cuda = torch.device(device).type == "cuda"
    out = {}

    def train(tmp, name, extra):
        t0 = time.perf_counter()
        state = train_vqvae.main(["-data_dir", f"{tmp}/shards", "-logdir", f"{tmp}/{name}",
                                  "-batch_size", str(batch), "-nepochs", "1", "-seed", str(seed),
                                  "-enc_nconv", str(enc), "-dec_nconv", str(dec),
                                  "-codebook_size", str(codes), "--device", str(device),
                                  *extra])
        with open(f"{tmp}/{name}/train_log.csv") as f:
            row = f.read().splitlines()[1].split(",")
        losses = [float(row[1]), float(row[2])]
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"train_vqvae {extra}: train / val loss {losses}")
        return {"train_loss": losses[0], "val_loss": losses[1], "steps": state.step,
                "seconds": time.perf_counter() - t0}

    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/shards")
        for i, n in enumerate(n_res):
            save_protein_shard(f"{tmp}/shards/prot_{i:04d}.npz",
                               synthetic_examples(n_frames, n, seed=seed + i, prot_idx=i,
                                                  structured=True))
        out["train_ivae"] = train(tmp, "ivae", ["-train_section", "ivae"])
        kernels.reset_launches()
        genz = CLI.main(["--experiment", "genzprot", "--vae_ckpt", f"{tmp}/ivae", "--data_dir",
                         f"{tmp}/shards", "--out_dir", f"{tmp}/eval_genz", "--num_ensemble",
                         str(members), "--batch_size", str(n_frames), "--device", str(device)])
        got = {k: v for k, v in kernels.launch_counts().items() if v}
        draws = members * len(n_res)
        want = {k: draws * v for k, v in add_launches(cgprior_launches(enc),
                                                      decoder_launches(dec)).items()}
        if cuda and got != want:
            raise RuntimeError(f"cli.test --experiment genzprot launched {got}, expected {want}")
        glob = genz["__global__"]
        if not all(math.isfinite(v) for v in glob.values()):
            raise RuntimeError(f"the genzprot CLI: {glob}")
        out["test_genzprot"] = dict(glob, launches=got)

        out["train_angle_fsq"] = train(tmp, "angle", ["-predict_angle", "-quantize_type",
                                                      "fsq_5", "-vqdim", "5", "-bf16"])
        usage = extract_features.main(["--ckpt", f"{tmp}/angle", "--data_dir", f"{tmp}/shards",
                                       "--out_dir", f"{tmp}/feat_angle", "--stats_name", "A",
                                       "--stats_dir", f"{tmp}/stats", "--batch_size",
                                       str(batch), "--device", str(device)])
        lat = np.load(f"{tmp}/feat_angle/prot_0000.npz")["latents"]
        if usage.sum() != 0 or lat.shape[-1] != 5 or not np.isfinite(lat).all():
            raise RuntimeError(f"extract_features on the angle / fsq run: usage {usage.sum()}, "
                               f"latents {lat.shape}")
        recon = CLI.main(["--experiment", "recon", "--vae_ckpt", f"{tmp}/angle", "--data_dir",
                          f"{tmp}/shards", "--out_dir", f"{tmp}/eval_angle", "--stats_name",
                          "A", "--stats_dir", f"{tmp}/stats", "--batch_size", str(n_frames),
                          "--device", str(device)])["__global__"]
        if not all(math.isfinite(v) for v in recon.values()):
            raise RuntimeError(f"the recon CLI on the angle / fsq run: {recon}")
        out["test_recon_angle"] = recon

        out["train_fgvae"] = train(tmp, "fgvae", ["-train_section", "fgvae", "-vqdim", "36"])
        extract_features.main(["--ckpt", f"{tmp}/fgvae", "--data_dir", f"{tmp}/shards",
                               "--out_dir", f"{tmp}/feat_fgvae", "--learn_sigma",
                               "--batch_size", str(batch), "--device", str(device)])
        z = np.load(f"{tmp}/feat_fgvae/prot_0001.npz")
        sig = z["latents"][..., 36:][z["res_mask"].astype(bool)]
        if z["latents"].shape[-1] != 72 or "mu" in z or not (sig > 0).all():
            raise RuntimeError(f"extract_features --learn_sigma: {z['latents'].shape}")
        out["extract_learn_sigma"] = {"width": int(z["latents"].shape[-1]),
                                      "sigma_mean": float(sig.mean())}
    return out


def phase_stage1_variants(seed, device, records, card):
    """The rest of Stage 1 on the card, at the K3/K4 recipe's widths: CGPrior's
    kernel calls; VARIANT_STEPS bf16 steps of the angle VQ-VAE and f32 steps
    of GenZProt at the Stage-1 bench batch, launches asserted every step;
    one f32 step of GenZProt, the angle VQ-VAE and the fgvae VAE card vs
    CPU; one step of each quantizer kind card vs CPU; the entry chain
    (run_variant_cli). Records CGPrior's own launches in the GenZProt steps,
    counted by ModuleLaunches and held to cgprior_launches."""
    import contextlib
    import torch
    t0 = time.perf_counter()
    s1 = stage1_batch(seed, device)
    records.update(check_cgprior_kernels(s1, seed))
    t_kern = time.perf_counter() - t0
    nb, nl = s1["res_type"].shape
    plain = stage1_train_launches()
    runs = {}
    for label, extra, expect in (
            ("angle VQ-VAE bf16", RECIPE + ["-predict_angle", "-bf16"], plain),
            ("GenZProt f32", RECIPE + ["-train_section", "ivae"],
             add_launches(plain, cgprior_launches(train=True)))):
        model, state, step = build_variant_trainer(device, seed, extra)
        torch.cuda.reset_peak_memory_stats()
        genz = hasattr(model, "prior_net")
        with ModuleLaunches(model.prior_net) if genz else contextlib.nullcontext() as counter:
            times, metrics, _ = run_stage1_train(state, step, s1, VARIANT_STEPS, expect)
        if genz:
            prior = counter
        runs[label] = (times, metrics, torch.cuda.max_memory_allocated() / 2 ** 30, expect)
        del model, state, step
    # CGPrior's own launches in the GenZProt steps, forward and backward
    want = {k: v * VARIANT_STEPS for k, v in cgprior_launches(train=True).items()}
    if prior.counts != want:
        raise RuntimeError(f"CGPrior launched {prior.counts} in {VARIANT_STEPS} GenZProt "
                           f"steps, expected {want}")
    for key, name in (("cgprior_edge_gather", "edge_gather"),
                      ("cgprior_edge_aggregate", "edge_aggregate"),
                      ("cgprior_fused_tp", "fused_tp"), ("cgprior_fused_tp_bwd", "fused_tp_bwd")):
        records[key]["launches"] = prior.counts[name]
    log(f"  CGPrior's own launches in the {VARIANT_STEPS} GenZProt steps (counted around its "
        f"forward and its backward's nodes): {prior.counts} (asserted)")
    for label, (times, metrics, peak, expect) in runs.items():
        log(f"  {label}: {VARIANT_STEPS} steps at {nb}x{nl} (embed 36, vqdim 3, 4096 codes, "
            f"3 + 4 layers), median {statistics.median(times[1:] or times):.2f} ms/step "
            f"(first {times[0]:.1f} ms), peak memory {peak:.2f} GiB; launches a step {expect} "
            f"(asserted); last loss {float(metrics['loss']):.5g}, recon "
            f"{float(metrics['recon']):.5g}, kl {float(metrics['kl']):.4g}")
    del s1
    ref = variant_reference(seed, device)
    kinds = run_quantizer_kinds(seed, device)
    log("  one step of each quantizer kind card vs CPU (2 x 40, 1 + 1 layers, 64 codes): "
        + "; ".join(f"{k} loss {l:.6g} (rel {r:.2g}), perplexity {p:.4g}, VQ state "
                    f"|d| - 1e-5 |ref| {v:.3g} (<= 1e-5), worst grad {g:.3g} (logged)"
                    for k, (l, p, r, v, g) in kinds.items()))
    chain = run_variant_cli(seed, device)
    genz = chain["test_genzprot"]
    log(f"  entry chain: train_vqvae -train_section ivae {chain['train_ivae']}; cli.test "
        f"--experiment genzprot (2 members): rmsd_aligned {genz['rmsd_aligned']:.4f}, ged "
        f"{genz['ged']:.4f}, div {genz['div']:.4f}, launches {genz['launches']} (asserted: a "
        f"draw {add_launches(cgprior_launches(), decoder_launches())}); train_vqvae "
        f"-predict_angle -quantize_type fsq_5 -bf16 {chain['train_angle_fsq']}, "
        f"extract_features, cli.test --experiment recon rmsd_aligned "
        f"{chain['test_recon_angle']['rmsd_aligned']:.4f}; train_vqvae -train_section fgvae "
        f"{chain['train_fgvae']}, extract_features --learn_sigma {chain['extract_learn_sigma']}")
    log(f"phase stage1_variants: {time.perf_counter() - t0:.2f} s (CGPrior's kernels "
        f"{t_kern:.2f} s; card vs CPU losses "
        f"{ {k: round(v[0], 6) for k, v in ref.items()} }); {card}")


# ---------------------------------------------------------------------------
# Flow matching (ROADMAP queue 1 item 8) and the data I/O it stands on (item 7)

# each fixed-step method at 100 denoiser evaluations a draw
FLOW_STEPS = {"euler": 100, "midpoint": 50, "rk4": 25}
FLOW_DOPRI5_STEPS = 25          # a budget of 100 attempts
FLOW_TOL = 1e-5                 # dopri5's rtol = atol; card-vs-CPU f32 draws, of max|latent|
FLOW_TRAIN_STEPS = 10
FLOW_KINDS = ("otcfm", "sbcfm")


def native_checks(seed, n_points=2000):
    """The port's native host library is loaded (not the fallbacks), its LAP
    equals scipy's and its radius graph the dense numpy form on random
    inputs, and an XTC the port writes reads back within the codec's
    precision. Returns a log line."""
    import tempfile
    import numpy as np
    from scipy.optimize import linear_sum_assignment
    from codlad_tpu_torch import native
    from codlad_tpu_torch.data.xtc import read_xtc, write_xtc
    if not native.loaded():
        raise RuntimeError(f"the native host library did not load: {native.load_error()}")
    rng = np.random.default_rng(seed)
    cost = rng.random((B, B))
    t0 = time.perf_counter()
    col = native.lap_solve(cost)
    lap_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(col, linear_sum_assignment(cost)[1]):
        raise RuntimeError("the native LAP disagrees with scipy's")
    xyz, valid = rng.uniform(0, 40, (n_points, 3)), rng.random(n_points) > 0.1
    pairs = native.radius_graph(xyz, valid, 9.0)
    if not np.array_equal(pairs, native.radius_graph_dense(xyz, valid, 9.0)):
        raise RuntimeError("the native radius graph disagrees with its dense form")
    frames = np.cumsum(rng.normal(0, 0.05, (4, 1000, 3)), 1).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        write_xtc(f"{tmp}/t.xtc", frames)
        back = read_xtc(f"{tmp}/t.xtc")["xyz"]
    err, tol = float(np.abs(back - frames).max()), 0.5 / 1000.0 + 1e-5
    if not (back.shape == frames.shape and err <= tol):
        raise RuntimeError(f"the XTC round trip: {back.shape}, max|d| {err} (tol {tol})")
    return (f"native library {native.library_path().name} loaded; LAP {B}x{B} equal to "
            f"scipy's ({lap_ms:.3f} ms); radius graph of {n_points} points, {len(pairs)} "
            f"pairs, equal to the dense form in value and order; XTC 4 x 1000 atoms round "
            f"trip max|d| {err:.3g} nm (tol {tol:.3g})")


def build_flow_pipeline(device, seed, method="euler", steps=100, kind="otcfm", **kw):
    """The production sampling pipeline (build_pipeline: 3+3 layers, hidden
    128, gates open) with a flow denoiser (C output channels) integrating by
    `method`."""
    pipe = build_pipeline(device, seed, learn_sigma=False, **kw)
    pipe.process, pipe.process_kind = None, kind
    pipe.ode_method, pipe.ode_steps = method, steps
    return pipe


def flow_launches(nfe, decode=True):
    """K1/K2 launches of nfe evaluations of the 3+3-layer denoiser, and a
    decode's K8/K9."""
    return {**chain_launches(nfe), **(decoder_launches() if decode else {})}


def flow_reference(seed, device="cuda", n_frames=4, n_res=64, hidden=H, layers=3,
                   steps=(("euler", 20), ("dopri5", 10))):
    """f32 flow draws card (kernels) against CPU (plain versions) from the
    same weights and noise, each method: the card's draw on the CPU's
    conditioning (the featurizer's self-edge quaternions carry ~3e-4 of f32
    rounding on either device, which the reference phase covers), held to
    FLOW_TOL of max|latent|, dopri5's nfe equal; the card's draw on its own
    conditioning logged beside. Returns {method: (max|d|, scale, nfe, own
    max|d|)}."""
    import torch
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    pipes = {dev: build_flow_pipeline(dev, seed, hidden=hidden, layers=layers,
                                      k=min(K, n_res)) for dev in ("cpu", device)}
    nb = synthetic_cg_batch(n_frames, n_res, seed=seed + 5)
    noise = torch.randn((n_frames, n_res, 3), generator=torch.Generator().manual_seed(seed))
    ex = {dev: {"res_type": b["res_type"], "cg_xyz": b["cg_xyz_og"][:, 1:-1],
                "mask": b["res_mask"]} for dev, b in
          ((d, to_device(nb, d)) for d in pipes)}
    with torch.no_grad():
        cond = pipes["cpu"].condition(ex["cpu"])
    out = {}
    for method, n in steps:
        lat, nfe = {}, {}
        for dev, pipe in pipes.items():
            pipe.ode_method, pipe.ode_steps = method, n
            pipe.condition = lambda e, d=dev: {k: v.to(d) for k, v in cond.items()}
            lat[dev] = pipe.sample_latents(ex[dev], noise=noise.to(dev)).cpu()
            nfe[dev] = pipe.last_ode["nfe"]
        del pipes[device].condition          # the card's own conditioning
        own = pipes[device].sample_latents(ex[device], noise=noise.to(device)).cpu()
        scale = lat["cpu"].abs().max().item()
        d = (lat[device] - lat["cpu"]).abs().max().item()
        d_own = (own - lat["cpu"]).abs().max().item()
        out[method] = (d, scale, nfe[device], d_own)
        log(f"  flow reference {method} (f32, {n_frames} x {n_res}, {n} steps): card vs CPU "
            f"max|d| {d:.3g} (tol {FLOW_TOL:g} x max|latent| {scale:.4g}); nfe card "
            f"{nfe[device]}, CPU {nfe['cpu']}; on the card's own conditioning max|d| "
            f"{d_own:.3g} (logged)")
        if not (d <= FLOW_TOL * scale and nfe[device] == nfe["cpu"]):
            raise RuntimeError(f"the card's f32 {method} flow draw disagrees with the CPU's")
    return out


def build_flow_trainer(device, seed, kind, hidden=H, layers=3, k=K, dropout=P_DROP,
                       compute_dtype=None, lr=3e-4, gates=False):
    """(model, TrainState, train_step) of the production denoiser trained by
    the flow matcher `kind` (sbcfm: 2C output channels)."""
    import torch
    from codlad_tpu_torch.gen.flow import FLOW_MATCHERS
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    from codlad_tpu_torch.train.state import TrainState, warmup_linear_schedule
    from codlad_tpu_torch.train.steps import make_latent_step

    gen = torch.Generator().manual_seed(seed)
    model = MPNNDenoiser(gen, hidden_dim=hidden, edge_features=hidden,
                         num_encoder_layers=layers, num_decoder_layers=layers, k_neighbors=k,
                         dropout=dropout, learn_sigma=kind == "sbcfm")
    if gates:
        open_gates(model, gen)
    model.to(device)
    state = TrainState(dict(model.named_parameters()), warmup_linear_schedule(lr, 0),
                       grad_clip=1.0)
    step, _ = make_latent_step(model, FLOW_MATCHERS[kind](), process_kind=kind,
                               dropout=dropout > 0, compute_dtype=compute_dtype)
    return model, state, step


def flow_train_reference(seed, kind, device="cuda", hidden=H, layers=3):
    """One f32 flow training step at dropout 0 on a B2 L32 K16 batch, card
    (kernels) against CPU (plain versions), the same weights and injected
    draws (x0, t, eps); the OT coupling computed on each side. The loss
    within rtol 1e-6 (measured 9e-8 to 1.3e-7 on an H100), each grad within
    1e-3 of its max|grad|, train_reference's f32 limit. Returns (loss card,
    loss CPU, rel, worst grad)."""
    import torch
    x1, extras = train_batch(2, 32, seed + 2, "cpu", jitter=0.1)
    g = torch.Generator().manual_seed(seed + 3)
    draws = {"x0": torch.randn(x1.shape, generator=g),
             "t": 0.05 + 0.9 * torch.rand((2,), generator=g),
             "eps": torch.randn(x1.shape, generator=g)}
    runs = {}
    for dev in ("cpu", device):
        _, state, step = build_flow_trainer(dev, seed, kind, hidden=hidden, layers=layers, k=16,
                                            dropout=0.0, gates=True, lr=1e-3)
        state, m = step(state, x1.to(dev), {k: v.to(dev) for k, v in extras.items()}, seed,
                        draws={k: v.to(dev) for k, v in draws.items()})
        runs[str(dev)] = (float(m["loss"]), {k: v.cpu() for k, v in m["grads"].items()})
    (l_c, g_c), (l_d, g_d) = runs["cpu"], runs[str(device)]
    rel = abs(l_d - l_c) / abs(l_c)
    worst = max(((g_d[k] - v).abs().max() / (v.abs().max() + 1e-30)).item()
                for k, v in g_c.items())
    log(f"  flow train reference {kind} (f32, dropout 0, card vs CPU): loss {l_d:.8g} vs "
        f"{l_c:.8g}, rel {rel:.3g} (rtol 1e-6); worst max|dgrad|/max|grad| over {len(g_c)} "
        f"params {worst:.3g} (tol 1e-3)")
    if not (rel <= 1e-6 and worst <= 1e-3):
        raise RuntimeError(f"the card's {kind} training step disagrees with the CPU's")
    return l_d, l_c, rel, worst


def run_flow_user_path(seed, device="cuda", n_res=(60, 90), n_frames=8, batch=8,
                       train_steps=5, steps=20, members=2):
    """The user's path on synthetic proteins written by the port's write_pdb
    and write_xtc: `cli.preprocess --pdb_dir --xtc_dir` -> feature files (the
    committed VQ-VAE's encoder latents of every frame) -> `train_latent
    --model otcfm --bf16` for train_steps -> `cli.test --experiment latent
    --model otcfm --method euler --save_pdb --save_xtc` with that VQ-VAE.
    The PDB and XTC it writes are parsed back (one MODEL / frame a member).
    Returns the summary, the test run's launches and the seconds of each
    stage."""
    import json
    import os
    import tempfile
    import numpy as np
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.cli import preprocess, train_latent
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.data.batch import to_device
    from codlad_tpu_torch.data.pdb import parse_pdb
    from codlad_tpu_torch.data.shards import load_protein_shard
    from codlad_tpu_torch.data.synthetic import write_structure_files
    from codlad_tpu_torch.data.xtc import read_xtc
    out, sec = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        names = [f"prot_{i}" for i in range(len(n_res))]
        for i, (name, n) in enumerate(zip(names, n_res)):
            write_structure_files(tmp, name, n, n_frames, seed=seed + i, pdb_dir=f"{tmp}/pdb",
                                  xtc_dir=f"{tmp}/xtc")
        got = preprocess.main(["--pdb_dir", f"{tmp}/pdb", "--xtc_dir", f"{tmp}/xtc",
                               "--stride", "1", "--out_dir", f"{tmp}/shards"])
        if got["success"] != names or got["failed"]:
            raise RuntimeError(f"cli.preprocess: {got}")
        sec["preprocess"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vae = CLI.load_vae_weights(str(WEIGHTS), device)[0]
        os.makedirs(f"{tmp}/features")
        for name in names:
            _, shard = load_protein_shard(f"{tmp}/shards/{name}.npz")
            if shard["res_type"].shape[0] != n_frames:
                raise RuntimeError(f"{name}: {shard['res_type'].shape[0]} frames in its shard")
            with torch.no_grad():
                h = vae.encode(to_device(shard, device)).float().cpu().numpy()
            np.savez(f"{tmp}/features/{name}.npz", latents=h, res_type=shard["res_type"],
                     cg_xyz_og=shard["cg_xyz_og"], res_mask=shard["res_mask"])
        sec["features"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_latent.main(["--feature_dir", f"{tmp}/features", "--exp", f"{tmp}/exp",
                           "--model", "otcfm", "--bf16", "--batch_size", str(batch),
                           "--max_steps", str(train_steps), "--log_step", "1", "--warmup",
                           "10", "--device", str(device)])
        with open(f"{tmp}/exp/config.json") as f:
            if json.load(f)["model"] != "otcfm":
                raise RuntimeError("train_latent's config does not name the model it trained")
        with open(f"{tmp}/exp/metrics.jsonl") as f:
            out["losses"] = [r["loss"] for r in map(json.loads, f) if r["split"] == "train"]
        sec["train_latent"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kernels.reset_launches()
        out["summary"] = CLI.main(
            ["--experiment", "latent", "--model", "otcfm", "--method", "euler",
             "--vae_weights", str(WEIGHTS), "--latent_ckpt", f"{tmp}/exp", "--data_dir",
             f"{tmp}/shards", "--out_dir", f"{tmp}/eval", "--num_sampling_steps", str(steps),
             "--num_ensemble", str(members), "--save_pdb", "--save_xtc",
             "--device", str(device)])
        out["launches"] = kernels.launch_counts()
        sec["test"] = time.perf_counter() - t0
        for name, n in zip(names, n_res):
            models = parse_pdb(f"{tmp}/eval/{name}_gen.pdb")["xyz14"]
            traj = read_xtc(f"{tmp}/eval/{name}_gen.xtc")["xyz"]
            # the export writes the n - 2 modeled residues; their parse models n - 4
            if models.shape[:2] != (members, n - 4) or traj.shape[0] != members:
                raise RuntimeError(f"{name}: the exports hold {models.shape} models and "
                                   f"{traj.shape} frames, expected {members} of {n - 4}")
    g = out["summary"]["__global__"]
    if not (len(out["losses"]) == train_steps and all(map(math.isfinite, out["losses"]))
            and all(math.isfinite(v) for v in g.values())):
        raise RuntimeError(f"the flow user path: losses {out['losses']}, summary {g}")
    out["seconds"] = sec
    out["draws"] = members * len(n_res)
    return out


def phase_flows(seed, device, records, card, diffusion_rate=None):
    """Phase flows: the native host helpers, full-width flow draws by every
    solver (launches asserted; euler timed beside the diffusion timing
    phase's rate, traced), the f32 card-vs-CPU draws, bf16 otcfm / sbcfm
    training steps (launches asserted, the LAP's host ms), the f32
    card-vs-CPU steps and the user path preprocess -> train_latent ->
    cli.test. Adds flow_launches to K1, K2, K8, K9 and flow_train_launches
    to K1-K5."""
    import torch
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    from codlad_tpu_torch.gen import ot
    from codlad_tpu_torch.gen.solvers import NFE_PER_STEP
    t0 = time.perf_counter()
    log("  " + native_checks(seed))
    batch = to_device(synthetic_cg_batch(B, L, seed=seed), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pipe = build_flow_pipeline(device, seed, compute_dtype=torch.bfloat16)
    rates = {}
    for method, steps in FLOW_STEPS.items():
        pipe.ode_method, pipe.ode_steps = method, steps
        out = run_slice(pipe, batch, gen)
        check_slice(out, B, L)
        expect = flow_launches(steps * NFE_PER_STEP[method])
        check_launches(out["launches"], expect, f"the {method} flow draw")
        timed = run_slice(pipe, batch, gen)
        rates[method] = (steps, timed["seconds"])
        if method == "euler":
            for name in ("fused_message_sum", "fused_message_edge_lnmod", "edge_gather",
                         "edge_aggregate"):
                records[name]["flow_launches"] = out["launches"][name]
        log(f"  flow draw {method}, {steps} steps (bf16, B{B} L{L} K{K}, {card}): first "
            f"{out['seconds']:.3f} s, timed {timed['seconds']:.3f} s a draw + decode "
            f"({steps / timed['seconds']:.2f} steps/s, "
            f"{steps * NFE_PER_STEP[method] / timed['seconds']:.2f} evaluations/s); launches "
            f"{out['launches']} (expected {expect})")
    pipe.ode_method, pipe.ode_steps = "euler", FLOW_STEPS["euler"]
    names = trace_sampling(pipe, batch, seed)
    if not any("message_edge_lnmod_mma_kernel" in n for n in names) or any(
            "chain_kernel" in n for n in names):
        raise RuntimeError(f"the traced flow steps did not run K2 on its tensor-core kernel: "
                           f"{sorted(names)}")
    steps, sec = rates["euler"]
    log(f"  euler flow {steps / sec:.2f} steps/s, {sec:.3f} s a draw; the diffusion timing "
        f"phase's {diffusion_rate if diffusion_rate is None else round(diffusion_rate, 2)} "
        f"steps/s (100 ddim100 steps + decode) in this run")
    pipe.ode_method, pipe.ode_steps = "dopri5", FLOW_DOPRI5_STEPS
    pipe.ode_rtol = pipe.ode_atol = FLOW_TOL
    out = run_slice(pipe, batch, gen)
    check_slice(out, B, L)
    ode = pipe.last_ode
    check_launches(out["launches"], flow_launches(ode["nfe"]), "the dopri5 flow draw")
    log(f"  flow draw dopri5 (rtol = atol = {FLOW_TOL:g}, budget {4 * FLOW_DOPRI5_STEPS} "
        f"attempts): nfe {ode['nfe']}, accepted {ode['accepted']}, rejected "
        f"{ode['rejected']}, host syncs {ode['host_syncs']}, reached t {ode['t']:.4f}, "
        f"{out['seconds']:.3f} s a draw + "
        f"decode; launches {out['launches']} (asserted: 6 K1 and 3 K2 an evaluation)")
    del pipe, out
    flow_reference(seed, device)
    t_sample = time.perf_counter() - t0

    x1, extras = train_batch(B, L, seed + 1, device)
    per_step = train_launches(3, 3, P_DROP)
    totals = dict.fromkeys(per_step, 0)
    for kind in FLOW_KINDS:
        _, state, step = build_flow_trainer(device, seed, kind, compute_dtype=torch.bfloat16)
        ot.reset_lap_stats()
        times, metrics, tot = run_train(state, step, x1, extras, seed, FLOW_TRAIN_STEPS,
                                        per_step)
        lap = dict(ot.LAP_STATS)
        totals = {k: totals[k] + tot[k] for k in totals}
        log(f"  flow train {kind}: {FLOW_TRAIN_STEPS} steps B{B} L{L} K{K} H{H} bf16 dropout "
            f"{P_DROP}: median {statistics.median(times[1:]):.2f} ms/step (first "
            f"{times[0]:.1f} ms); the exact OT's host LAP {lap['ms'] / lap['calls']:.3f} ms a "
            f"step ({lap['calls']} calls, the copy to the host included); launches a step "
            f"{per_step} (asserted); last loss {float(metrics['loss']):.5g}"
            + (f", score {float(metrics['score']):.5g}" if "score" in metrics else ""))
        del state, step
    _, state, step = build_flow_trainer(device, seed, "otcfm", dropout=0.0,
                                        compute_dtype=torch.bfloat16)
    p0 = train_launches(3, 3, 0.0)
    times, _, tot0 = run_train(state, step, x1, extras, seed, 2, p0)
    for name in set(totals) | set(p0):
        records[name]["flow_train_launches"] = totals.get(name, 0) + tot0[name]
    log(f"  flow train otcfm at dropout 0: {statistics.median(times):.2f} ms/step; launches a "
        f"step {p0} (asserted)")
    del state, step, x1, extras
    for kind in FLOW_KINDS:
        flow_train_reference(seed, kind, device)
    t_train = time.perf_counter() - t0 - t_sample

    user = run_flow_user_path(seed, device)
    expect = {k: v * user["draws"] for k, v in flow_launches(20).items()}
    check_launches(user["launches"], expect, "the flow user path's cli.test")
    g = user["summary"]["__global__"]
    log(f"  user path: preprocess (PDB + XTC, 2 proteins x 8 frames) -> features -> "
        f"train_latent --model otcfm --bf16 (losses {[round(x, 4) for x in user['losses']]}) "
        f"-> cli.test --model otcfm --method euler --save_pdb --save_xtc: rmsd_aligned "
        f"{g['rmsd_aligned']:.4f}, ged {g['ged']:.4f}, div {g['div']:.4f}; launches "
        f"{({k: v for k, v in user['launches'].items() if v})} (asserted); PDB and XTC parsed "
        f"back; seconds {({k: round(v, 2) for k, v in user['seconds'].items()})}")
    log(f"phase flows: {time.perf_counter() - t0:.2f} s (sampling {t_sample:.2f} s, training "
        f"{t_train:.2f} s); {card}")


# ---------------------------------------------------------------------------
# Progressive distillation (cli/distill.py, train/steps.py make_distill_step)

DISTILL_STEPS = 20
DISTILL_ROUND_STEPS = 60         # cli.distill's one round on the trained teacher
DISTILL_MEMBERS = 2


def distill_launches(n_enc=3, n_dec=3):
    """Launches of one distillation step (dropout 0): two teacher
    evaluations and the student's forward, each K1 for every node update
    and K2 for every encoder edge update, and the student's backward."""
    return {"fused_message_sum": 3 * (n_enc + n_dec), "fused_message_edge_lnmod": 3 * n_enc,
            "fused_message_sum_bwd": n_enc + n_dec, "fused_message_edge_lnmod_bwd": n_enc}


def build_distill_trainer(device, seed, hidden=H, layers=3, k=K, compute_dtype=None, lr=1e-4,
                          teacher_steps=STEPS):
    """(model, TrainState, teacher params, train_step, eval_step) of
    make_distill_step: the production denoiser (dropout 0, adaLN heads drawn
    small so every layer reaches the output), the student starting as the
    teacher (as cli.distill starts it) on the halved grid of teacher_steps."""
    import torch
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.gen.distill import halve
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser
    from codlad_tpu_torch.train.state import TrainState, warmup_linear_schedule
    from codlad_tpu_torch.train.steps import make_distill_step
    gen = torch.Generator().manual_seed(seed)
    model = MPNNDenoiser(gen, hidden_dim=hidden, edge_features=hidden,
                         num_encoder_layers=layers, num_decoder_layers=layers, k_neighbors=k,
                         dropout=0.0)
    open_gates(model, gen)
    model.to(device)
    teacher = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState(teacher, warmup_linear_schedule(lr, 0), grad_clip=1.0)
    tp = create_diffusion(teacher_steps, diffusion_steps=1000)
    step, eval_step = make_distill_step(model, tp, halve(tp), compute_dtype=compute_dtype)
    return model, state, teacher, step, eval_step


def distill_reference(seed, device="cuda", hidden=H, layers=3):
    """One f32 distillation step on a B2 L32 K16 batch on the card (kernels)
    and on the CPU (plain versions), from the same weights, student indices
    and noise, held as `train_reference` holds a training step."""
    import torch
    lr = 1e-3
    x1, extras = train_batch(2, 32, seed + 2, "cpu", jitter=0.1)
    g = torch.Generator().manual_seed(seed + 3)
    i_s = torch.tensor([0, 37])
    noise = torch.randn((2, 32, 3), generator=g)
    runs = {}
    for dev in ("cpu", device):
        _, state, teacher, step, _ = build_distill_trainer(dev, seed, hidden=hidden,
                                                           layers=layers, k=16, lr=lr)
        ex = {k: v.to(dev) for k, v in extras.items()}
        state, m = step(state, teacher, x1.to(dev), ex, seed, i_s=i_s.to(dev),
                        noise=noise.to(dev))
        runs[str(dev)] = ({k: float(m[k]) for k in ("loss", "mse", "grad_norm")},
                          {k: v.cpu() for k, v in m["grads"].items()},
                          {k: v.cpu() for k, v in state.params.items()},
                          {k: v.cpu() for k, v in state.ema_params.items()})
    (m_c, g_c, p_c, e_c), (m_d, g_d, p_d, e_d) = runs["cpu"], runs[str(device)]
    worst_g = max(((g_d[k] - v).abs().max() / (v.abs().max() + 1e-30)).item()
                  for k, v in g_c.items())
    upd = check_update(g_c, g_d, m_c["grad_norm"], m_d["grad_norm"], p_c, p_d, e_c, e_d, lr,
                       1e-4)
    rel = {k: abs(m_d[k] - m_c[k]) / abs(m_c[k]) for k in m_c}
    log(f"distill reference (card f32 kernels vs CPU plain): loss {m_d['loss']:.6g} vs "
        f"{m_c['loss']:.6g}, grad_norm {m_d['grad_norm']:.6g} vs {m_c['grad_norm']:.6g}; rel "
        f"|d| {', '.join(f'{k} {v:.3g}' for k, v in rel.items())} (rtol 1e-3); worst "
        f"max|dgrad|/max|grad| over {len(g_c)} params {worst_g:.3g} (tol 1e-3); {upd['msg']}")
    if not (all(v <= 1e-3 for v in rel.values()) and worst_g <= 1e-3 and upd["ok"]):
        raise RuntimeError("the card's distillation step disagrees with the CPU reference")


def run_distill_user_path(seed, device="cuda", shard_dir=None, n_frames=96, batch=B,
                          round_steps=DISTILL_ROUND_STEPS, members=DISTILL_MEMBERS,
                          proteins=(30, 31), start_steps=100):
    """The user path of distillation with the trained weights: features of the
    convergence study's val proteins (shards in `shard_dir`, else written
    here) by the trained VQ-VAE (cli.extract_features --vae_weights), one
    round of cli.distill (start_steps -> start_steps / 2) from the trained
    denoiser (--teacher_weights, bf16), the distillation loss of a fixed held
    batch before and after the round (the student's raw weights), then
    cli.test --latent_ckpt on the student (the DDIM sampler on its own grid,
    launches counted) and cli.test --latent_weights on the teacher with DDIM
    at start_steps. Returns both summaries, the student's launches, the held
    losses and the seconds of each part."""
    import os
    import tempfile
    import numpy as np
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.cli import distill, extract_features
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.convert.from_flax import load_denoiser
    from codlad_tpu_torch.data.norm import load_stats, normalize
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import corpus_protein
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.gen.distill import halve
    from codlad_tpu_torch.train.state import TrainState
    from codlad_tpu_torch.train.steps import make_distill_step
    out, sec = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if shard_dir is None:
            shard_dir = f"{tmp}/shards"
            os.makedirs(shard_dir)
            for i in proteins:
                save_protein_shard(f"{shard_dir}/prot_{i:04d}.npz", corpus_protein(i, n_frames))
        extract_features.main(["--vae_weights", str(WEIGHTS), "--data_dir", str(shard_dir),
                               "--out_dir", f"{tmp}/feats", "--batch_size", str(batch),
                               "--device", str(device)])
        sec["extract_features"] = time.perf_counter() - t0

        # the held batch: the first `batch` frames of the first protein
        mean, std = load_stats(str(WEIGHTS.parent), "CONV")
        z = np.load(f"{tmp}/feats/prot_{proteins[0]:04d}.npz")
        held_x = torch.as_tensor(normalize(z["latents"][:batch], mean, std).astype(np.float32),
                                 device=device)
        held = {"res_type": torch.as_tensor(z["res_type"][:batch], device=device),
                "cg_xyz": torch.as_tensor(z["cg_xyz_og"][:batch, 1:-1], device=device),
                "mask": torch.as_tensor(z["res_mask"][:batch], device=device)}
        model, _, _ = load_denoiser(str(LATENT_WEIGHTS), device)
        teacher = {n: p.detach().clone() for n, p in model.named_parameters()}
        tp = create_diffusion(f"ddim{start_steps}", diffusion_steps=1000)
        _, held_eval = make_distill_step(model, tp, halve(tp), compute_dtype=torch.bfloat16)

        def held_loss(params):
            st = TrainState(params, lambda s: 0.0, ema=False)
            return float(held_eval(st, teacher, held_x, held, seed + 99)["loss"])

        out["held_start"] = held_loss(teacher)
        t0 = time.perf_counter()
        distill.main(["--teacher_weights", str(LATENT_WEIGHTS), "--feature_dir",
                      f"{tmp}/feats", "--exp", f"{tmp}/distill", "--stats_name", "CONV",
                      "--stats_dir", str(WEIGHTS.parent), "--start_steps", str(start_steps),
                      "--rounds", "1", "--steps_per_round", str(round_steps), "--batch_size",
                      str(batch), "--warmup", "5", "--lr", "1e-4", "--ema_decay", "0.99",
                      "--log_step", str(max(round_steps // 3, 1)), "--bf16", "--device",
                      str(device)])
        sec["distill"] = time.perf_counter() - t0
        sd = torch.load(f"{tmp}/distill/last.pt", map_location="cpu", weights_only=True)
        out["held_end"] = held_loss({k: v.to(device) for k, v in sd["params"].items()})
        with open(f"{tmp}/distill/config.json") as f:
            out["config"] = json.load(f)
        args = ["--vae_weights", str(WEIGHTS), "--stats_name", "CONV", "--stats_dir",
                str(WEIGHTS.parent), "--num_sampling_steps", str(start_steps), "--num_ensemble",
                str(members), "--data_dir", str(shard_dir), "--device", str(device),
                "--experiment", "latent"]
        t0 = time.perf_counter()
        kernels.reset_launches()
        out["student"] = CLI.main(["--latent_ckpt", f"{tmp}/distill", "--out_dir",
                                   f"{tmp}/eval_student", *args])
        out["launches"] = kernels.launch_counts()
        sec["student_test"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["teacher"] = CLI.main(["--latent_weights", str(LATENT_WEIGHTS), "--sampler",
                                   "ddim", "--out_dir", f"{tmp}/eval_teacher", *args])
        sec["teacher_test"] = time.perf_counter() - t0
    out["seconds"] = sec
    return out


def phase_distill(seed, device, records, card, shard_dir=None):
    """Phase distill: 20 bf16 distillation steps at full width with launches
    asserted every step, ms/step and peak memory, the last traced (K1-K4
    must run on their tensor-core kernels); one f32 step card vs CPU; the
    user path with the trained weights (`run_distill_user_path`): the held
    batch's loss must fall and the student's CLI draws launch 300 K1 and 150
    K2 a draw. Adds distill_launches to K1-K4 and distill_cli_launches to
    K1 and K2."""
    import torch
    t0 = time.perf_counter()
    x1, extras = train_batch(B, L, seed + 1, device)
    _, state, teacher, step, _ = build_distill_trainer(device, seed,
                                                       compute_dtype=torch.bfloat16)
    per_step = distill_launches()
    torch.cuda.reset_peak_memory_stats()
    ran = set()
    times, metrics, totals = run_train(
        state, lambda st, x, e, s: step(st, teacher, x, e, s), x1, extras, seed,
        DISTILL_STEPS, per_step, traced=1, names=ran)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    need = ("message_sum_mma_kernel", "message_edge_lnmod_mma_kernel",
            "message_sum_bwd_mma_kernel", "message_edge_lnmod_bwd_mma_kernel<0>")
    if not all(any(k in n for n in ran) for k in need) or any(
            "chain_kernel" in n or "chain_bwd_kernel" in n for n in ran):
        raise RuntimeError(f"the traced distillation step did not run K1-K4 on their "
                           f"tensor-core kernels {need}: {sorted(ran)}")
    for name, n in totals.items():
        if n:
            records[name]["distill_launches"] = n
    log(f"  distill: {DISTILL_STEPS} bf16 steps of make_distill_step at B{B} L{L} K{K} H{H} "
        f"(3 + 3 layers, ddim100 -> 50), {card}: median of the {len(times)} untraced "
        f"{statistics.median(times):.2f} ms/step (first {times[0]:.1f} ms), "
        f"{1e3 / statistics.median(times):.2f} steps/s, peak memory {peak:.2f} GiB; launches "
        f"a step {per_step} (asserted); the traced step ran {', '.join(need)}; last loss "
        f"{float(metrics['loss']):.5g}, mse {float(metrics['mse']):.5g}, grad_norm "
        f"{float(metrics['grad_norm']):.5g}")
    del state, teacher, step, x1, extras
    distill_reference(seed, device)

    user = run_distill_user_path(seed, device, shard_dir)
    cfg = user["config"]
    n_grid = len(cfg["distill_tmap"])
    draws = DISTILL_MEMBERS * len([k for k in user["student"] if not k.startswith("__")])
    expect = {k: v * draws for k, v in chain_launches(n_grid).items()}
    expect.update({k: v * draws for k, v in decoder_launches().items()})
    check_launches(user["launches"], expect, "the distilled student's cli.test")
    for name in ("fused_message_sum", "fused_message_edge_lnmod"):
        records[name]["distill_cli_launches"] = user["launches"][name]
    for who in ("student", "teacher"):
        for p, agg in user[who].items():
            if not p.startswith("__") and not all(
                    math.isfinite(v) for v in agg.values() if isinstance(v, float)):
                raise RuntimeError(f"the distilled {who}'s summary of {p} is not finite")
    for p in sorted(k for k in user["student"] if not k.startswith("__")):
        s, t = user["student"][p], user["teacher"][p]
        log(f"  {p}: student ({n_grid} DDIM steps) "
            + ", ".join(f"{k} {s[k]:.4f}" for k in EVAL_TOL)
            + f", {s['wallclock_sec']:.2f} s; teacher (100 DDIM steps) "
            + ", ".join(f"{k} {t[k]:.4f}" for k in EVAL_TOL) + f", {t['wallclock_sec']:.2f} s")
    log(f"  distill user path: cli.extract_features --vae_weights -> cli.distill (1 round, "
        f"100 -> {n_grid}, {DISTILL_ROUND_STEPS} bf16 steps of batch {B}) -> cli.test "
        f"--latent_ckpt (sampler ddim on the student's grid, launches {expect} asserted); "
        f"held batch distillation loss {user['held_start']:.6g} at the start, "
        f"{user['held_end']:.6g} after the round; seconds "
        f"{ {k: round(v, 2) for k, v in user['seconds'].items()} }")
    if not user["held_end"] < user["held_start"]:
        raise RuntimeError("the distillation loss of the held batch did not fall")
    log(f"phase distill: {time.perf_counter() - t0:.2f} s; {card}")


# ---------------------------------------------------------------------------
# Data and sequence parallelism over torch.distributed (train/mesh.py,
# parallel/sequence.py, parallel/dryrun.py)

SEQ_ROWS = 64                    # the K1-K4 records at N != L: 64 local rows of N = 128


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world_of_one(device):
    """Join a process group of this one process through torchrun's
    environment variables (NCCL on a card, gloo on the CPU)."""
    import os
    from codlad_tpu_torch.train.mesh import maybe_init_distributed
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    return maybe_init_distributed(device)


def leave_world():
    import os
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        os.environ.pop(k, None)


def run_parallel_trainers(seed, device="cuda", n_frames=B, n_res=L, batch=B, steps=3,
                          s1_res=(58, 75), s1_frames=4, s1_batch=2, enc=ENC_LAYERS,
                          dec=DEC_LAYERS):
    """cli.train_latent (bf16, `steps` steps) and cli.train_vqvae -dp (-bf16, one
    epoch) on synthetic data in this process as it stands (in a process
    group or not): their logged train losses."""
    import os
    import tempfile
    from codlad_tpu_torch.cli import train_latent, train_vqvae
    from codlad_tpu_torch.data.cg_batch import write_synthetic_features
    from codlad_tpu_torch.data.shards import save_protein_shard
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_features(f"{tmp}/feats", n_frames, n_res, seed=seed)
        train_latent.main(["--feature_dir", f"{tmp}/feats", "--exp", f"{tmp}/lat",
                           "--batch_size", str(batch), "--max_steps", str(steps),
                           "--log_step", "1", "--bf16", "--seed", str(seed), "--device",
                           str(device)])
        with open(f"{tmp}/lat/metrics.jsonl") as f:
            out["train_latent"] = [json.loads(r)["loss"] for r in f
                                   if json.loads(r)["split"] == "train"]
        os.makedirs(f"{tmp}/shards")
        for i, n in enumerate(s1_res):
            save_protein_shard(f"{tmp}/shards/p{i}.npz",
                               synthetic_examples(s1_frames, n, seed=seed + i))
        train_vqvae.main(["-data_dir", f"{tmp}/shards", "-logdir", f"{tmp}/vq", "-dp",
                          "-batch_size", str(s1_batch), "-nepochs", "1", "-enc_nconv",
                          str(enc), "-dec_nconv", str(dec), "-vqdim", "3", "-codebook_size",
                          str(CODEBOOK), "-bf16", "-seed", str(seed), "--device", str(device)])
        with open(f"{tmp}/vq/metrics.jsonl") as f:
            out["train_vqvae"] = [json.loads(r)["loss"] for r in f
                                  if json.loads(r)["split"] == "train"]
    return out


def seq_mode_checks(seed, device="cuda", n_frames=8, n_res=L, hidden=H, layers=3, k=K,
                    train_frames=B):
    """On one rank of a process group: ring_knn against the dense featurizer's
    kNN (E_idx equal, distances within 1e-6 of max), the seq-mode denoiser's
    f32 forward against the dense one (within 1e-5 of max|out|), an f32
    seq-mode training step at dropout 0 against the dense step (loss rtol
    1e-5, params within 1e-5 of max|param|), then one bf16 seq-mode step at
    train_frames x n_res. Returns the launches of the f32 forward and step
    and of the bf16 step."""
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.parallel.sequence import ring_knn
    from codlad_tpu_torch.train.mesh import make_mesh
    from codlad_tpu_torch.train.state import TrainState
    from codlad_tpu_torch.train.steps import make_latent_step
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    mesh = make_mesh(1, seq_mode=True)
    seq = mesh.seq_ctx()
    x1, extras = train_batch(n_frames, n_res, seed + 5, device, jitter=0.1)
    model, _, _ = build_trainer(device, seed, hidden=hidden, layers=layers, k=k, dropout=0.0,
                                gates=True)
    maskf = extras["mask"].float()
    d_ref, i_ref = model.features._dist(extras["cg_xyz"], maskf)
    d_ring, i_ring = ring_knn(extras["cg_xyz"], maskf, i_ref.shape[-1], seq)
    if not torch.equal(i_ring, i_ref) or (d_ring - d_ref).abs().max() > 1e-6 * d_ref.abs().max():
        raise RuntimeError("ring_knn disagrees with the dense kNN")
    t = torch.randint(0, 1000, (n_frames,), generator=torch.Generator().manual_seed(seed)
                      ).to(device)
    kernels.reset_launches()
    with torch.no_grad():
        dense = model(x1, t, extras["res_type"], extras["cg_xyz"], extras["mask"])
        kernels.reset_launches()
        sharded = model(x1, t, extras["res_type"], extras["cg_xyz"], extras["mask"], seq=seq)
    launches = {"forward_f32": kernels.launch_counts()}
    err = (sharded - dense).abs().max().item()
    if not err <= 1e-5 * dense.abs().max().item():
        raise RuntimeError(f"the seq-mode forward disagrees with the dense one: {err}")
    runs = {}
    for name, m in (("dense", None), ("seq", mesh)):
        st = TrainState(dict(model.named_parameters()), lambda s: 1e-3, grad_clip=1.0)
        step, _ = make_latent_step(model, create_diffusion(None), dropout=False, mesh=m)
        kernels.reset_launches()
        st, met = step(st, x1, extras, seed)
        runs[name] = (float(met["loss"]), st.params, kernels.launch_counts())
    launches["step_f32"] = runs["seq"][2]
    pmax = max(v.abs().max().item() for v in runs["dense"][1].values())
    dp = max((runs["seq"][1][k] - v).abs().max().item() for k, v in runs["dense"][1].items())
    if not (abs(runs["seq"][0] - runs["dense"][0]) <= 1e-5 * abs(runs["dense"][0])
            and dp <= 1e-5 * pmax):
        raise RuntimeError(f"the seq-mode step disagrees with the dense one: loss "
                           f"{runs['seq'][0]} vs {runs['dense'][0]}, max|dparam| {dp}")
    xb, eb = train_batch(train_frames, n_res, seed + 6, device)
    st = TrainState(dict(model.named_parameters()), lambda s: 1e-3, grad_clip=1.0)
    step, _ = make_latent_step(model, create_diffusion(None), dropout=False,
                               compute_dtype=torch.bfloat16, mesh=mesh)
    kernels.reset_launches()
    st, met = step(st, xb, eb, seed)
    launches["step_bf16"] = kernels.launch_counts()
    if not math.isfinite(float(met["loss"])):
        raise RuntimeError("the bf16 seq-mode step's loss is not finite")
    return {"forward_err": err, "forward_scale": dense.abs().max().item(),
            "loss": runs["seq"][0], "dense_loss": runs["dense"][0], "param_err": dp,
            "launches": launches}


def ddp_step_times(seed, device="cuda", n_frames=B, n_res=L, rounds=5, **kw):
    """Median ms of a bf16 Stage-2 training step (dropout 0.6) without a
    mesh and with the Mesh of the process group (one rank: its gradient
    all-reduce and reductions run), timed in turns (plain, mesh, mesh,
    plain, ...) after one warm-up step each."""
    import torch
    from codlad_tpu_torch.train.mesh import make_mesh
    from codlad_tpu_torch.train.steps import make_latent_step
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    x1, extras = train_batch(n_frames, n_res, seed + 1, device)
    model, state, step = build_trainer(device, seed, compute_dtype=torch.bfloat16, **kw)
    mesh_step, _ = make_latent_step(model, create_diffusion(None, diffusion_steps=1000),
                                    compute_dtype=torch.bfloat16, mesh=make_mesh(1))
    times = {"plain": [], "mesh": []}
    cuda = torch.device(device).type == "cuda"
    for i in range(2 * rounds + 2):
        name = "plain" if i % 4 in (0, 3) else "mesh"
        fn = step if name == "plain" else mesh_step
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = fn(state, x1, extras, seed + i)
        if cuda:
            torch.cuda.synchronize()
        if i >= 2:                      # the first of each is a warm-up
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def _two_card_rank(rank, world, port):
    import os
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    from codlad_tpu_torch.parallel.dryrun import main as dryrun_main
    dryrun_main(["--device", "cuda"])


def phase_parallel(seed, device, records, card):
    """Phase parallel: K1-K4 at the sequence-sharded shape (B96, 64 local
    rows, N 128, K 64) in both dtypes against their plain versions (records
    *_seq); the trainers with and without a process group (one rank, NCCL):
    equal losses; on that rank the seq-mode checks (`seq_mode_checks`),
    whose launches the *_seq records carry (one rank: N = L there), and the
    dryrun twin; with two or more cards the dryrun twin on two NCCL ranks."""
    import torch
    t0 = time.perf_counter()
    dims = (B, SEQ_ROWS, K)
    recs = check_kernels(device, seed, dims, n_nodes=L, f32_records=True)
    bwd = check_bwd_kernels(device, seed, dims, n_nodes=L, f32_records=True)
    recs.update({k: v for k, v in bwd.items() if "drop" not in k})
    t_kern = time.perf_counter() - t0

    plain = run_parallel_trainers(seed, device)
    init_world_of_one(device)
    try:
        ddp = run_parallel_trainers(seed, device)
        # within rtol 1e-3: the bf16 K3's dGn sums by f32 atomics, in an order
        # that varies run to run, so steps after the first may move apart
        if ddp.keys() != plain.keys() or not all(
                len(ddp[k]) == len(plain[k]) and all(
                    abs(u - v) <= 1e-3 * abs(v) for u, v in zip(ddp[k], plain[k]))
                for k in plain):
            raise RuntimeError(f"the trainers under a process group of one rank (NCCL) "
                               f"disagree with the plain ones: {ddp} vs {plain}")
        seq = seq_mode_checks(seed, device)
        from codlad_tpu_torch.parallel.dryrun import dryrun_multichip
        dry = dryrun_multichip(device)
        tp = tensor_step_check(seed, device)
        rates = ddp_step_times(seed, device)
    finally:
        leave_world()
    for key, rec in recs.items():
        base = key.removesuffix("_f32")
        src = seq["launches"]["step_bf16" if rec["dtype"] == "bfloat16" else "step_f32"]
        rec["launches"] = src.get(base, 0)
        records[f"{key}_seq"] = rec
    log(f"  parallel: train_latent (3 bf16 steps at B{B} L{L}) and train_vqvae -dp (one "
        f"epoch) in a process group of one rank (NCCL): losses "
        f"{ {k: [round(v, 6) for v in vs] for k, vs in ddp.items()} }, the plain runs' "
        f"{ {k: [round(v, 6) for v in vs] for k, vs in plain.items()} } (rtol 1e-3)")
    log(f"  seq mode on one rank (CUDA): ring_knn equals the dense kNN; forward max|d| "
        f"{seq['forward_err']:.3g} (max|out| {seq['forward_scale']:.4g}); f32 step loss "
        f"{seq['loss']:.6g} vs dense {seq['dense_loss']:.6g}, max|dparam| "
        f"{seq['param_err']:.3g}; launches {seq['launches']}")
    log(f"  dryrun twin on one NCCL rank: {dry}")
    log(f"  dp x tp (parallel/tensor.py, a model axis of 1) bf16 step at B{B} L{L} K{K}, "
        f"dropout 0: loss {tp['loss']:.6g} vs the plain step's {tp['plain_loss']:.6g}, "
        f"{tp['ms']:.2f} ms (the second step), launches {tp['launches']} (asserted), "
        f"{tp['sharded']} sharded params, {tp['bytes']:,} bytes of them with moments and EMA")
    log(f"  a bf16 training step at B{B} L{L} K{K} (dropout {P_DROP}), in turns: plain "
        f"{rates['plain']:.2f} ms, with the one-rank NCCL mesh {rates['mesh']:.2f} ms "
        f"(ratio {rates['mesh'] / rates['plain']:.4f}); {card}")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        torch.multiprocessing.spawn(_two_card_rank, args=(2, free_port()), nprocs=2)
        log("  two cards: the dryrun twin on two NCCL ranks (the 2-rank DDP step against "
            "one rank, the seq forward and train step against dense, Stage-1 DP) passed")
    else:
        log(f"  {n_cards} card: the 2-rank DDP step and the 2-rank seq forward were not run")
    log(f"phase parallel: {time.perf_counter() - t0:.2f} s (kernels {t_kern:.2f} s); {card}")


def tensor_step_check(seed, device="cuda", n_frames=B, n_res=L, **widths):
    """On one rank of a process group: a bf16 dp x tp training step
    (parallel/tensor.py, a model axis of 1) at dropout 0 against the plain
    step on the same weights and batch (loss rtol 1e-3: the bf16 K3's dGn
    sums by f32 atomics), its launches (6 K1, 3 K2, 6 K3, 3 K4 asserted on
    a card) and ms (the second step). `widths`: build_trainer's hidden,
    layers, k."""
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.parallel.tensor import ShardedTrainState, make_tensor_mesh, shard_plan
    from codlad_tpu_torch.train.steps import make_latent_step
    x1, extras = train_batch(n_frames, n_res, seed + 7, device)
    model, state, step = build_trainer(device, seed, dropout=0.0, gates=True,
                                       compute_dtype=torch.bfloat16, **widths)
    tmesh = make_tensor_mesh(1)
    tp_state = ShardedTrainState(dict(model.named_parameters()), shard_plan(model, 1), tmesh,
                                 lambda s: 3e-4, grad_clip=1.0)
    tp_step, _ = make_latent_step(model, create_diffusion(None, diffusion_steps=1000),
                                  dropout=False, compute_dtype=torch.bfloat16,
                                  mesh=tmesh.data_mesh)
    _, m = step(state, x1, extras, seed)
    plain = float(m["loss"])
    losses, ms, launches = [], [], []
    for _ in range(2):                  # the first from the plain step's weights
        kernels.reset_launches()
        t0 = time.perf_counter()
        tp_state, mt = tp_step(tp_state, x1, extras, seed)
        losses.append(float(mt["loss"]))   # a host read: the step has ended
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(kernels.launch_counts())
    if torch.device(device).type == "cuda":
        for got in launches:
            check_launches(got, train_launches(3, 3, 0.0), "the dp x tp step")
    if not abs(losses[0] - plain) <= 1e-3 * abs(plain):
        raise RuntimeError(f"the dp x tp step's loss {losses[0]} differs from the plain {plain}")
    return {"loss": losses[0], "plain_loss": plain, "ms": ms[1], "launches": launches[0],
            "sharded": len(tp_state.plan), "bytes": tp_state.local_bytes()}


# ---------------------------------------------------------------------------
# The reference's own checkpoints; the autoregressive ProteinMPNN

N6_REFERENCE = WEIGHTS.with_name("convergence_vqvae_n6layout.pt")
IMPORT_TOL = 1e-4               # the CLI's metrics, --vae_ckpt vs --vae_weights (rtol)
MPNN_TOL = 1e-4                 # f32 log-probs and probs, card vs CPU
MPNN_TIE = 1e-4                 # a draw may differ only where its top two scores tie


def angle_layout_state_dict(n6, seed):
    """A reference K3 / K4 (IC_Decoder_angle) state dict at the trained
    widths, in memory: the N6 file's encoder, map_in / map_out and codebook,
    and the angle decoder of a port VAE drawn from `seed`, under the
    reference's IC_Decoder_angle names (vae_model.py:318-415; a torch Linear
    keeps its [out, in] layout). -> (state dict, that port decoder)."""
    import torch
    from codlad_tpu_torch.models.vae import VAE
    dec = VAE(torch.Generator().manual_seed(seed), embed_dim=36, vqdim=3, predict_angle=True,
              dec_nconv=DEC_LAYERS, enc_nconv=ENC_LAYERS).decoder
    nc = DEC_LAYERS
    names = {"Embed_0": "backbone_dist", "Embed_1": "sidechain_dist", "Embed_2": "res_embed"}
    mlps = {nc: "backbone_angle", nc + 1: "backbone_torsion", nc + 2: "sidechain_angle",
            2 * nc + 3: "final_torsion"}
    for i in range(nc):
        im, mb = f"InvariantMessage_{i}", f"message_blocks.{i}"
        names.update({f"{im}.Dense_0": f"{mb}.inv_dense.0", f"{im}.Dense_1": f"{mb}.inv_dense.1",
                      f"{im}.DistanceEmbed_0.Dense_0": f"{mb}.dist_embed.block.1"})
        mlps.update({i: f"dense_blocks.{i}", nc + 3 + i: f"sidechain_torsion_blocks.{i}"})
    for j, ref in mlps.items():
        names.update({f"_MLP2_{j}.Dense_0": f"{ref}.1", f"_MLP2_{j}.Dense_1": f"{ref}.3"})
    sd = {k: v for k, v in n6.items() if not k.startswith("module.equivaraintconv.")}
    for name, v in dec.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        sd[f"module.equivaraintconv.{names[mod]}.{leaf}"] = v.detach().clone()
    return sd, dec


def run_import(seed, device="cuda", fixture_frames=4, cli_res=(58, 75), cli_frames=3):
    """Phase import: cli.import_checkpoint on weights/convergence_vqvae_n6layout.pt
    (the trained VQ-VAE in the reference's N6 layout) into a port logdir;
    `load_vae_ckpt` of it and `load_vae_weights` of the converted npz on the
    fixture frames (every VQ code equal; latents and xyz14 differences
    reported) and against the JAX outputs at recon_trained's limits;
    `cli.test --experiment recon --vae_ckpt` on two proteins against the
    `--vae_weights` run (metrics within IMPORT_TOL), its K8 / K9 / K10
    launches counted; a K3 / K4 angle-layout file at the trained widths
    (written to the temporary directory only) through a run directory and
    --modelnum 999: the layout detected, its decoder loaded, its recon's
    codes those of the N6 import (the same encoder and codebook).
    fixture_frames, cli_res, cli_frames: the sizes (smaller to rehearse)."""
    import json
    import os
    import numpy as np
    import torch
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.cli import import_checkpoint as IC
    from codlad_tpu_torch.cli import test as CLI
    from codlad_tpu_torch.convert.from_flax import read_flax_npz
    from codlad_tpu_torch.eval.harness import SamplingPipeline, evaluate_structures
    mean, std = read_flax_npz(str(WEIGHTS))["stats"]
    with np.load(FIXTURE) as fx:
        want = {k: fx[k] for k in fx.files}
    want = {k: v[:fixture_frames] for k, v in want.items()}
    batch = {k[len("batch/"):]: torch.as_tensor(v, device=device) for k, v in want.items()
             if k.startswith("batch/")}
    mask = batch["res_mask"].bool()
    cli = dict(n_res=cli_res, n_frames=cli_frames)

    def recon(vae, snap):
        pipe = SamplingPipeline(denoiser=None, process=None, vae=vae,
                                codebook=snap["vq_state"].codebook, norm_mean=mean,
                                norm_std=std)
        return run_recon(pipe, batch), snap["vq_state"].codebook

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        IC.main(["--torch_ckpt", str(N6_REFERENCE), "--kind", "vqvae", "--out", f"{tmp}/n6"])
        out["import_s"] = time.perf_counter() - t0
        got, codebook = recon(*CLI.load_vae_ckpt(f"{tmp}/n6", device)[:2])
        ref, _ = recon(*CLI.load_vae_weights(str(WEIGHTS), device)[:2])
        if not torch.equal(got["codes"][mask], ref["codes"][mask]):
            raise RuntimeError("the imported VQ-VAE's codes differ from the converted weights'")
        out["d_latents"] = (got["latents"] - ref["latents"]).abs().max().item()
        out["d_xyz"] = (got["xyz14"] - ref["xyz14"]).abs().max().item()
        rmsd = evaluate_structures(batch, got["ic"], got["xyz14"],
                                   per_frame=True)["rmsd_aligned"].cpu().numpy()
        out["d_rmsd_jax"] = float(np.abs(rmsd - want["metric/rmsd_aligned"]).max())
        tied = code_gaps(codebook, torch.as_tensor(want["latents"], device=device)) <= CODE_MARGIN
        differ = (got["codes"] != torch.as_tensor(want["codes"], device=device)) & mask
        out["codes_vs_jax"] = (int(differ.sum()), int((differ & ~tied).sum()), int(mask.sum()))
        if out["codes_vs_jax"][1] or not out["d_rmsd_jax"] <= 1e-3:
            raise RuntimeError(f"the imported VQ-VAE disagrees with the JAX outputs: {out}")
        out["enc_launches"], out["dec_launches"] = got["enc_launches"], got["dec_launches"]

        kernels.reset_launches()
        t0 = time.perf_counter()
        via_ckpt = run_recon_cli(seed, device, vae=["--vae_ckpt", f"{tmp}/n6"], **cli)
        out["cli_s"] = time.perf_counter() - t0
        out["cli_launches"] = kernels.launch_counts()
        via_weights = run_recon_cli(seed, device, **cli)
        if torch.device(device).type == "cuda" and any(
                not out["cli_launches"].get(k) for k in ("edge_gather", "edge_aggregate",
                                                         "fused_tp")):
            raise RuntimeError(f"the recon CLI did not launch K8 / K9 / K10: "
                               f"{out['cli_launches']}")
        bad = {k: (v, via_weights[k]) for k, v in via_ckpt.items() if not k.endswith("_sec")
               and not abs(v - via_weights[k]) <= IMPORT_TOL * max(abs(via_weights[k]), 1e-2)}
        if bad:
            raise RuntimeError(f"cli.test --vae_ckpt (imported) differs from --vae_weights: {bad}")
        out["cli"], out["cli_weights"] = via_ckpt, via_weights

        sd, dec = angle_layout_state_dict(torch.load(N6_REFERENCE, weights_only=True), seed)
        os.makedirs(f"{tmp}/Vae_vqvaeangle_PDB_ns36_vq3_vq4096")
        torch.save(sd, f"{tmp}/Vae_vqvaeangle_PDB_ns36_vq3_vq4096/best_model.pt")
        IC.main(["--torch_ckpt", f"{tmp}/Vae_vqvaeangle_PDB_ns36_vq3_vq4096", "--modelnum",
                 "999", "--kind", "vqvae", "--out", f"{tmp}/k3"])
        with open(f"{tmp}/k3/config.json") as f:
            cfg = json.load(f)
        vae, snap, _ = CLI.load_vae_ckpt(f"{tmp}/k3", device)
        want_dec = dict(dec.named_parameters())
        same = all(torch.equal(v.cpu(), want_dec[k]) for k, v in vae.decoder.named_parameters())
        angle, _ = recon(vae, snap)
        if not (cfg["predict_angle"] is True and cfg["codebook_size"] == CODEBOOK and same
                and torch.equal(angle["codes"][mask], got["codes"][mask])
                and bool(torch.isfinite(angle["xyz14"]).all())):
            raise RuntimeError(f"the K3 / K4 angle-layout import failed: config {cfg}, "
                               f"decoder loaded {same}")
        out["angle_metrics"] = angle["metrics"]
    return out


def mpnn_inputs(seed, device, n_chains=4, n_res=L):
    """Inputs of the ProteinMPNN phase: random C-alpha walks, the last chain
    with a masked tail of 16, the first with 8 fixed positions, two chain
    labels in the second; a decoding-order randn."""
    import numpy as np
    import torch
    from codlad_tpu_torch.data.synthetic import random_ca_trace
    rng = np.random.default_rng(seed)
    X = np.stack([random_ca_trace(rng, n_res) for _ in range(n_chains)]).astype(np.float32)
    mask = np.ones((n_chains, n_res), np.float32)
    mask[-1, -16:] = 0.0
    chain_M = np.ones((n_chains, n_res), np.float32)
    chain_M[0, :8] = 0.0
    chains = np.zeros((n_chains, n_res), np.int64)
    chains[1, n_res // 2:] = 1
    host = {"X": X, "mask": mask, "chain_M": chain_M, "chains": chains,
            "S": rng.integers(0, 21, (n_chains, n_res)),
            "residue_idx": np.broadcast_to(np.arange(n_res), (n_chains, n_res)).copy(),
            "randn": rng.normal(size=(n_chains, n_res)).astype(np.float32)}
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


def compare_draws(label, card, cpu, noise, step_of):
    """Hold a card draw against the CPU's with the same noise: the sequences
    equal and the probs within MPNN_TOL, or, where a letter differs, the
    CPU's top two scores (log p + g) at the first differing step within
    MPNN_TIE (a tie f32 rounding may break either way; logged). step_of(b,
    pos): the step (noise row) that drew position pos of chain b. -> the
    largest probs difference (None where a draw differs)."""
    import torch
    S_c, S_p = card["S"].cpu(), cpu["S"]
    if torch.equal(S_c, S_p):
        d = (card["probs"].cpu() - cpu["probs"]).abs().max().item()
        if not d <= MPNN_TOL:
            raise RuntimeError(f"{label}: probs card vs CPU {d} > {MPNN_TOL}")
        return d
    b = int((S_c != S_p).any(1).nonzero()[0])
    order = cpu["decoding_order"][b].tolist()
    pos = next(p for p in order if S_c[b, p] != S_p[b, p])
    score = torch.log(cpu["probs"][b, pos]) + noise[step_of(b, pos), b].cpu()
    top = torch.topk(score, 2).values
    gap = float(top[0] - top[1])
    log(f"  {label}: chain {b} differs first at position {pos} (step "
        f"{step_of(b, pos)}): the CPU's top-two gap {gap:.3g} (tie limit {MPNN_TIE:g})")
    if not gap <= MPNN_TIE:
        raise RuntimeError(f"{label}: the card's draw differs from the CPU's at a clear choice")
    return None


def mpnn_reference(seed, device="cuda", n_chains=4, n_res=L, **widths):
    """Phase protein_mpnn: the ProteinMPNN at the JAX class's default widths
    (hidden 128, 3 + 3 layers, K 64, 21 letters; `widths` to shrink it), f32,
    random weights from `seed`, on the card and on the CPU: teacher-forced
    log-probs and unconditional_probs within MPNN_TOL; conditional_probs in
    both modes on the card against the CPU's teacher-forced forward at four
    positions; sample and tied_sample (positions i and i + n_res / 2 tied,
    every fourth) with the same Gumbel noise (`compare_draws`); the card's
    seconds a draw. Returns the differences and times."""
    import copy
    import torch
    from codlad_tpu_torch.models import protein_mpnn as PM
    model = PM.ProteinMPNN(torch.Generator().manual_seed(seed), **widths).eval()
    nets = {"cpu": copy.deepcopy(model), "card": model.to(device)}
    ins = {"cpu": mpnn_inputs(seed, "cpu", n_chains, n_res),
           "card": mpnn_inputs(seed, device, n_chains, n_res)}
    args = lambda w, *ks: [ins[w][k] for k in ks]
    sync = (lambda: torch.cuda.synchronize(device)) if torch.device(device).type == "cuda" \
        else (lambda: None)
    out = {}
    with torch.no_grad():
        fwd = {w: nets[w](*args(w, "X", "S", "mask", "chain_M", "residue_idx", "chains", "randn"))
               for w in nets}
        unc = {w: nets[w].unconditional_probs(*args(w, "X", "mask", "residue_idx", "chains"))
               for w in nets}
    out["forward"] = (fwd["card"].cpu() - fwd["cpu"]).abs().max().item()
    out["unconditional"] = (unc["card"].cpu() - unc["cpu"]).abs().max().item()
    positions = (0, n_res // 3, 2 * n_res // 3, n_res - 1)
    for backbone_only in (False, True):
        t0 = time.perf_counter()
        cond = PM.conditional_probs(nets["card"], *args("card", "X", "S", "mask", "chain_M",
                                                        "residue_idx", "chains", "randn"),
                                    backbone_only=backbone_only)
        sync()
        out[f"conditional_s_{backbone_only}"] = time.perf_counter() - t0
        d = 0.0
        cm = (ins["cpu"]["chain_M"] * ins["cpu"]["mask"])[..., None]
        for idx in positions:
            onehot = torch.zeros(n_res)
            onehot[idx] = 1.0
            prio = ((1.0 - onehot) if backbone_only else onehot).expand(n_chains, n_res)
            order = PM.decoding_order_from_noise(prio, ins["cpu"]["randn"])
            with torch.no_grad():
                lp = nets["cpu"](*args("cpu", "X", "S", "mask", "chain_M", "residue_idx",
                                       "chains", "randn"), use_input_decoding_order=True,
                                 decoding_order=order)
            d = max(d, ((cond[:, idx].cpu() - lp[:, idx]) * cm[:, idx]).abs().max().item())
        out[f"conditional_{'backbone' if backbone_only else 'all'}"] = d
    for k in ("forward", "unconditional", "conditional_all", "conditional_backbone"):
        if not out[k] <= MPNN_TOL:
            raise RuntimeError(f"ProteinMPNN {k} card vs CPU {out[k]} > {MPNN_TOL}")

    V = model.num_letters
    keys = ("X", "randn", "S", "chain_M", "chains", "residue_idx", "mask")
    noise = PM.gumbel((n_res, n_chains, V), torch.Generator().manual_seed(seed + 1), "cpu")
    draws = {w: PM.sample(nets[w], *args(w, *keys), noise=noise) for w in ("cpu", "card")}
    sync()
    t0 = time.perf_counter()
    PM.sample(nets["card"], *args("card", *keys), noise=noise)
    sync()
    out["sample_s"] = time.perf_counter() - t0
    rank = lambda d: {(b, p): s for b in range(n_chains)
                      for s, p in enumerate(d["decoding_order"][b].tolist())}
    steps = rank(draws["cpu"])
    out["sample"] = compare_draws("sample", draws["card"], draws["cpu"], noise,
                                  lambda b, p: steps[(b, p)])
    tied = [[i, i + n_res // 2] for i in range(0, n_res // 2, 4)]
    n_groups = n_res - len(tied)
    noise = PM.gumbel((n_groups, n_chains, V), torch.Generator().manual_seed(seed + 2), "cpu")
    ties = {w: PM.tied_sample(nets[w], *args(w, *keys), tied_pos=tied, noise=noise)
            for w in ("cpu", "card")}
    sync()
    t0 = time.perf_counter()
    PM.tied_sample(nets["card"], *args("card", *keys), tied_pos=tied, noise=noise)
    sync()
    out["tied_s"] = time.perf_counter() - t0
    groups, _ = PM.build_tied_groups(ties["cpu"]["decoding_order"][0].numpy(), tied, n_res)
    group_of = {int(p): g for g, grp in enumerate(groups) for p in grp if p >= 0}
    out["tied"] = compare_draws("tied_sample", ties["card"], ties["cpu"], noise,
                                lambda b, p: group_of[p])
    S = ties["card"]["S"].cpu()
    cm = (ins["cpu"]["chain_M"] * ins["cpu"]["mask"]) > 0
    if not all(bool((S[:, i] == S[:, j])[cm[:, i] & cm[:, j]].all()) for i, j in tied):
        raise RuntimeError("tied_sample on the card: tied positions differ")
    return out


def phase_import_and_mpnn(seed, device, card):
    """Phases import and protein_mpnn (after `build.timed_build()`)."""
    t0 = time.perf_counter()
    imp = run_import(seed, device)
    cli, cw = imp["cli"], imp["cli_weights"]
    log(f"  import: cli.import_checkpoint of {N6_REFERENCE.name} {imp['import_s']:.2f} s; on "
        f"the fixture frames (prot_0030 x 4) every code equal to --vae_weights', latents "
        f"max|d| {imp['d_latents']:.3g}, xyz14 max|d| {imp['d_xyz']:.3g} Å; against the JAX "
        f"outputs codes differ at {imp['codes_vs_jax'][0]} of {imp['codes_vs_jax'][2]} "
        f"({imp['codes_vs_jax'][1]} not near-tied), per-frame rmsd_aligned max|d| "
        f"{imp['d_rmsd_jax']:.3g} Å (tol 1e-3); launches an encoder forward "
        f"{imp['enc_launches']}, a decode {imp['dec_launches']}")
    log(f"  import: cli.test --experiment recon --vae_ckpt (imported logdir, 2 proteins x 3 "
        f"frames) {imp['cli_s']:.2f} s, launches {imp['cli_launches']}; rmsd_aligned "
        f"{cli['rmsd_aligned']:.6f} vs --vae_weights {cw['rmsd_aligned']:.6f}, ged "
        f"{cli['ged']:.6f} vs {cw['ged']:.6f} (every metric rtol {IMPORT_TOL:g}); the K3 / K4 "
        f"angle layout (--modelnum 999): detected, its decoder loaded, codes equal to N6's, "
        f"rmsd_aligned {imp['angle_metrics']['rmsd_aligned']:.4f} (a random decoder)")
    log(f"phase import: {time.perf_counter() - t0:.2f} s; {card}")
    t0 = time.perf_counter()
    mp = mpnn_reference(seed, device)
    log(f"  protein_mpnn (hidden 128, 3 + 3 layers, K 64, 21 letters, 4 chains x {L}, f32) "
        f"card vs CPU: log-probs max|d| {mp['forward']:.3g}, unconditional "
        f"{mp['unconditional']:.3g}, conditional (4 positions against the teacher-forced "
        f"forward) {mp['conditional_all']:.3g} / backbone-only "
        f"{mp['conditional_backbone']:.3g} (tol {MPNN_TOL:g}); sample probs max|d| "
        f"{mp['sample']}, tied_sample {mp['tied']} (None: a near-tie draw, logged above)")
    log(f"  protein_mpnn on the card: a draw of 4 x {L} {mp['sample_s']:.3f} s, a tied draw "
        f"{mp['tied_s']:.3f} s, conditional_probs {mp['conditional_s_False']:.3f} s / "
        f"backbone-only {mp['conditional_s_True']:.3f} s; {card}")
    log(f"phase protein_mpnn: {time.perf_counter() - t0:.2f} s")


def f32_kernel_names(pipe, batch, device, seed):
    """The device kernels of one f32 denoise call of `pipe` (f32) traced by
    torch.profiler, unfused and with fuse_pairs: (names unfused, names fused).
    Raises unless K1 and K2 ran as their f32 tensor-core kernels, K7 (fused)
    as its own, and no chain_kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    extras = {"res_type": batch["res_type"], "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
              "mask": batch["res_mask"]}
    shape = tuple(batch["res_type"].shape) + (pipe.latent_size,)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    tt = torch.full(shape[:1], 500, dtype=torch.long, device=device)
    names = []
    with torch.no_grad():
        cond = pipe.condition(extras)
        for fuse in (False, True):
            pipe._denoise_model.denoise(x, tt, cond, fuse_pairs=fuse)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pipe._denoise_model.denoise(x, tt, cond, fuse_pairs=fuse)
                torch.cuda.synchronize()
            names.append({e.name for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA})
    want = [("message_sum_f32_mma_kernel", "message_edge_lnmod_f32_mma_kernel"),
            ("message_sum_f32_mma_kernel", "edge_then_sum_f32_mma_kernel")]
    for got, need in zip(names, want):
        if not got:
            log("  f32 kernel names: the trace holds no device events (not checked)")
            return names
        if not all(any(k in n for n in got) for k in need) or any("chain_kernel" in n
                                                                   for n in got):
            raise RuntimeError(f"the f32 denoiser did not run {need} (or ran chain_kernel): "
                               f"{sorted(got)}")
    return names


def phase_f32_chain(seed, device, records, batch):
    """Phase 7b: the f32 denoiser's sampling path (K1, K2 and K7 on the
    tensor cores in 3xTF32) and an f32 training step. Fills the launches
    of the f32 K1, K2, K7 records (bench shape and L = 48) and returns
    {steps_per_s, steps_per_s_k48, fused, train_ms}."""
    import torch
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    pipe = build_pipeline(device, seed)   # f32: no compute dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    steps = pipe.process.num_timesteps
    n_enc, n_dec = len(pipe.denoiser.enc_layers), len(pipe.denoiser.dec_layers)
    expect = {"fused_message_sum": steps * (n_enc + n_dec),
              "fused_message_edge_lnmod": steps * n_enc, **decoder_launches()}
    out = run_slice(pipe, batch, gen)
    check_slice(out, B, L)
    check_launches(out["launches"], expect, "the f32 sampling path")
    for name in ("fused_message_sum", "fused_message_edge_lnmod"):
        records[f"{name}_f32"]["launches"] = out["launches"][name]
    timed = run_slice(pipe, batch, gen)      # warm: the 100 steps and the decode
    check_slice(timed, B, L)
    b48, l48, _ = K48
    small = to_device(synthetic_cg_batch(b48, l48, seed=seed + 3), device)
    out48 = run_slice(pipe, small, gen)
    check_slice(out48, b48, l48)
    check_launches(out48["launches"], expect, "the f32 sampling path at L = 48")
    for name in ("fused_message_sum", "fused_message_edge_lnmod"):
        records[f"{name}_f32_k48"]["launches"] = out48["launches"][name]
    f32_kernel_names(pipe, batch, device, seed)
    fs = fused_scans(pipe, batch, seed, rounds=1)
    expect_fused = {"fused_edge_then_sum": steps * n_enc, "fused_message_sum": steps * n_dec}
    check_launches(fs["launches"], expect_fused, "the f32 pair-fused scan")
    if not (fs["first_equal"] and fs["latents_equal"]):
        raise RuntimeError("the f32 pair-fused scan is not bit for bit the unfused one")
    records["fused_edge_then_sum_f32"]["launches"] = fs["launches"]["fused_edge_then_sum"]
    fs48 = fused_scans(pipe, small, seed, rounds=1)
    check_launches(fs48["launches"], expect_fused, "the f32 pair-fused scan at L = 48")
    if not (fs48["first_equal"] and fs48["latents_equal"]):
        raise RuntimeError("the f32 pair-fused scan at L = 48 is not bit for bit the unfused one")
    records["fused_edge_then_sum_f32_k48"]["launches"] = fs48["launches"]["fused_edge_then_sum"]
    del pipe
    torch.cuda.empty_cache()
    x1, extras = train_batch(B, L, seed + 1, device)
    model, state, step = build_trainer(device, seed)   # f32, dropout 0.6
    per_step = train_launches(len(model.enc_layers), len(model.dec_layers), P_DROP)
    ran = set()
    times, metrics, _ = run_train(state, step, x1, extras, seed, 6, per_step, traced=1,
                                  names=ran)
    times = times[1:]                                   # the first step is cold
    if ran and not any("message_sum_f32_mma_kernel" in n for n in ran):
        raise RuntimeError(f"the f32 training step did not run K1 on its tensor-core kernel: "
                           f"{sorted(ran)}")
    del model, state, step, x1, extras
    torch.cuda.empty_cache()
    return {"steps_per_s": steps / timed["seconds"], "seconds": timed["seconds"],
            "steps_per_s_k48": steps / out48["seconds"], "fused": fs,
            "train_ms": statistics.median(times), "train_times": times,
            "loss": float(metrics["loss"])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch, to_device
    from codlad_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    seconds, logs = build.timed_build()
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")) or (
                    "error" in line.lower()):
                log(f"  {name}: {line.strip()}")
    log(f"phase build: {seconds:.2f} s")

    t0 = time.perf_counter()
    records = check_kernels(device, args.seed, f32_records=True)
    records.update(check_bwd_kernels(device, args.seed))
    # K1's record at the L = 48 bucket beside the bench shape's (K2's bf16 is
    # logged), and the f32 K1's and K2's
    k48 = check_kernels(device, args.seed, K48, f32_records=True)
    records["fused_message_sum_k48"] = k48["fused_message_sum"]
    for name in ("fused_message_sum", "fused_message_edge_lnmod"):
        records[f"{name}_f32_k48"] = k48[f"{name}_f32"]
    check_bwd_kernels(device, args.seed, K48)
    s1_batch = stage1_batch(args.seed, device)
    records.update(check_stage1_kernels(s1_batch, args.seed))
    records.update(check_stage1_bwd_kernels(s1_batch, args.seed))
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    records.update(check_k6_kernels(device, args.seed))
    check_k6_kernels(device, args.seed, K48)     # logged; the records keep the bench shape
    log(f"phase kernels_k6: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    records.update(check_k7_kernels(device, args.seed))
    records["fused_edge_then_sum_f32_k48"] = check_k7_kernels(device, args.seed,
                                                              K48)["fused_edge_then_sum_f32"]
    check_k7_kernels(device, args.seed, (B, SEQ_ROWS, K), n_nodes=L, dtypes=(torch.float32,))
    log(f"phase kernels_k7: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    batch = to_device(synthetic_cg_batch(B, L, seed=args.seed), device)
    pipe = build_pipeline(device, args.seed, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    log(f"phase setup: {time.perf_counter() - t0:.2f} s (batch {B}x{L}, weights)")

    t0 = time.perf_counter()
    out = run_slice(pipe, batch, gen)
    check_slice(out, B, L)
    steps = pipe.process.num_timesteps
    n_enc = len(pipe.denoiser.enc_layers)
    expect = {"fused_message_sum": steps * (n_enc + len(pipe.denoiser.dec_layers)),
              "fused_message_edge_lnmod": steps * n_enc, **decoder_launches()}
    log(f"phase slice: {time.perf_counter() - t0:.2f} s; launches {out['launches']} "
        f"(expected {expect}); xyz14 {tuple(out['xyz14'].shape)} finite")
    check_launches(out["launches"], expect, "the sampling path")
    for name in ("fused_message_sum", "fused_message_edge_lnmod"):
        records[name]["launches"] = out["launches"][name]

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ic, xyz = pipe.sample_and_decode(batch, generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(xyz).all():
        raise RuntimeError("timed run produced non-finite xyz14")
    diffusion_rate = steps / dt
    log(f"phase timing: {dt:.3f} s for {steps} denoise steps + decode "
        f"({steps / dt:.2f} steps/s, batch {B}x{L}, bf16 denoiser)")
    b48, l48, k48 = K48
    out = run_slice(pipe, to_device(synthetic_cg_batch(b48, l48, seed=args.seed + 3), device),
                    gen)
    check_slice(out, b48, l48)
    check_launches(out["launches"], expect, "the sampling path at L = 48")
    records["fused_message_sum_k48"]["launches"] = out["launches"]["fused_message_sum"]
    log(f"  one draw at the L = 48 bucket ({b48}x{l48}, K {k48}): {out['seconds']:.3f} s "
        f"({steps / out['seconds']:.2f} steps/s); launches as expected; xyz14 finite")

    t0 = time.perf_counter()
    fs = fused_scans(pipe, batch, args.seed)
    n_steps = fs["steps"]
    expect_fused = {"fused_edge_then_sum": n_steps * n_enc,
                    "fused_message_sum": n_steps * len(pipe.denoiser.dec_layers)}
    check_launches(fs["launches"], expect_fused, "the pair-fused sampling scan")
    records["fused_edge_then_sum"]["launches"] = fs["launches"]["fused_edge_then_sum"]
    rate_f = n_steps / statistics.median(fs["fused_s"])
    rate_u = n_steps / statistics.median(fs["unfused_s"])
    log(f"phase fused_sampling: {time.perf_counter() - t0:.2f} s; {n_steps} bf16 steps at "
        f"B{B} L{L} K{K}, fuse_pairs=True {rate_f:.2f} steps/s, False {rate_u:.2f} steps/s "
        f"(median of {len(fs['fused_s'])} scans each, timed in turns: fused "
        f"{[round(x, 4) for x in fs['fused_s']]} s, unfused "
        f"{[round(x, 4) for x in fs['unfused_s']]} s); fused / unfused rate "
        f"{rate_f / rate_u:.4f}; launches of a fused scan {fs['launches']} (expected "
        f"{expect_fused}); first-step denoiser output max|d|={fs['first_d']:.3g} (max|ref| "
        f"{fs['first_scale']:.3g}), final latents max|d|={fs['latents_d']:.3g} (max|latent| "
        f"{fs['latents_scale']:.3g}); tolerance {FUSE_TOL:g} of each max|ref|")
    if not (fs["first_d"] <= FUSE_TOL * fs["first_scale"]
            and fs["latents_d"] <= FUSE_TOL * fs["latents_scale"]):
        raise RuntimeError("the pair-fused scan disagrees with the unfused one")
    log(f"  fused against unfused, bit for bit: first-step output "
        f"{'equal' if fs['first_equal'] else 'DIFFERS'}, final latents "
        f"{'equal' if fs['latents_equal'] else 'DIFFERS'}")
    if not (fs["first_equal"] and fs["latents_equal"]):
        raise RuntimeError("the pair-fused scan is not bit for bit the unfused one")

    t0 = time.perf_counter()
    f32 = phase_f32_chain(args.seed, device, records, batch)
    fs32 = f32["fused"]
    log(f"phase f32_chain: {time.perf_counter() - t0:.2f} s; f32 denoiser (K1, K2, K7 on the "
        f"tensor cores, 3xTF32): a {steps}-step draw + decode at B{B} L{L} K{K} "
        f"{f32['seconds']:.3f} s ({f32['steps_per_s']:.2f} steps/s; launches 600 K1, 300 K2 "
        f"as expected); at B{K48[0]} L{K48[1]} K{K48[2]} {f32['steps_per_s_k48']:.2f} steps/s; "
        f"one denoise call traced: K1 message_sum_f32_mma_kernel, K2 "
        f"message_edge_lnmod_f32_mma_kernel, fused K7 edge_then_sum_f32_mma_kernel, no "
        f"chain_kernel; f32 fused scan against the unfused one bit for bit equal (first-step "
        f"output and final latents; {fs32['launches']}), rates fused "
        f"{steps / statistics.median(fs32['fused_s']):.2f} / unfused "
        f"{steps / statistics.median(fs32['unfused_s']):.2f} steps/s; f32 training at dropout "
        f"{P_DROP}, B{B} L{L}: median {f32['train_ms']:.2f} ms/step over "
        f"{[round(x, 2) for x in f32['train_times']]} (last loss {f32['loss']:.5g})")

    t0 = time.perf_counter()
    reference_check(args.seed)
    log(f"phase reference: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    rpipe = build_pipeline(device, args.seed, compute_dtype=torch.bfloat16,
                           adaln_mode="residual")
    out = run_slice(rpipe, batch, gen)
    check_slice(out, B, L)
    expect_res = {"fused_message_sum": steps * (n_enc + len(rpipe.denoiser.dec_layers)),
                  "fused_message_edge": steps * n_enc, **decoder_launches()}
    check_launches(out["launches"], expect_res, "the residual sampling path")
    records["fused_message_edge"]["launches"] = out["launches"]["fused_message_edge"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ic, xyz = rpipe.sample_and_decode(batch, generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    if not torch.isfinite(xyz).all():
        raise RuntimeError("the residual sampling run produced non-finite xyz14")
    reference_check(args.seed, adaln_mode="residual")
    log(f"phase residual_sampling: {time.perf_counter() - t0:.2f} s; adaLN residual, gates "
        f"open, bf16, B{B} L{L} K{K}: {dt:.3f} s for {steps} denoise steps + decode "
        f"({steps / dt:.2f} steps/s; first draw {out['seconds']:.3f} s); launches "
        f"{out['launches']} (expected {expect_res}); xyz14 finite")
    del rpipe, out, ic, xyz

    # after every sampling phase, so that they all run before the first
    # profiler session, as the phases of earlier versions of this script did
    # (run right after the timing phase, the session was followed by slower
    # host-bound draws)
    t0 = time.perf_counter()
    for (b, l, k), seed in (((B, L, K), args.seed), (K48, args.seed + 3)):
        log(f"  sampling at B{b} L{l} K{k}:")
        names = trace_sampling(pipe, to_device(synthetic_cg_batch(b, l, seed=seed), device),
                               args.seed)
        # bf16 K2 runs on the tensor cores: no CUDA-core chain kernel in a step
        if not any("message_edge_lnmod_mma_kernel" in n for n in names) or any(
                "chain_kernel" in n for n in names):
            raise RuntimeError("the traced sampling steps did not run K2 on its tensor-core "
                               f"kernel: {sorted(names)}")
    log(f"phase trace_sampling: {time.perf_counter() - t0:.2f} s; 3 bf16 sampling steps at "
        f"B{B} L{L} K{K} and at B{K48[0]} L{K48[1]} K{K48[2]} traced; K2 ran as "
        f"message_edge_lnmod_mma_kernel, no chain_kernel")
    del pipe

    t0 = time.perf_counter()
    x1, extras = train_batch(B, L, args.seed + 1, device)
    model, state, step = build_trainer(device, args.seed, compute_dtype=torch.bfloat16)
    per_step = train_launches(len(model.enc_layers), len(model.dec_layers), P_DROP)
    torch.cuda.reset_peak_memory_stats()
    ran = set()
    times, metrics, totals = run_train(state, step, x1, extras, args.seed, TRAIN_STEPS,
                                       per_step, traced=TRACED_STEPS, names=ran)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # bf16 K5's forward, K3, K5's backward and every weight-grad pass run on
    # the tensor cores
    if not all(any(k in n for n in ran) for k in ("message_edge_lnmod_mma_kernel",
                                                  "message_sum_bwd_mma_kernel",
                                                  "message_edge_lnmod_bwd_mma_kernel",
                                                  "wgrad_mma_kernel")) or any(
            "wgrad_kernel<" in n or "chain_bwd_kernel" in n or "chain_kernel" in n
            for n in ran):
        raise RuntimeError("the traced training steps did not run K5's forward, K3, K5's "
                           "backward and the weight grads on their tensor-core kernels: "
                           f"{sorted(ran)}")
    for name in ("fused_message_sum_bwd", "fused_message_edge_lnmod_drop",
                 "fused_message_edge_lnmod_drop_bwd"):  # K1's count is the sampling path's
        records[name]["launches"] = totals[name]
    log(f"phase train: {time.perf_counter() - t0:.2f} s; {TRAIN_STEPS} steps B{B} L{L} K{K} "
        f"H{H} bf16 dropout {P_DROP}: median of the {len(times)} untraced "
        f"{statistics.median(times):.2f} ms/step "
        f"(first {times[0]:.1f} ms), {1e3 / statistics.median(times):.2f} steps/s, peak "
        f"memory {peak:.2f} GiB; launches a step {per_step}; K5's forward ran as "
        f"message_edge_lnmod_mma_kernel, K3 as message_sum_bwd_mma_kernel, K5's backward "
        f"as message_edge_lnmod_bwd_mma_kernel, the weight grads as wgrad_mma_kernel, no "
        f"chain_kernel or chain_bwd_kernel; last loss "
        f"{float(metrics['loss']):.5g}, grad_norm {float(metrics['grad_norm']):.5g}")
    del model, state, step

    t0 = time.perf_counter()
    model, state, step = build_trainer(device, args.seed, dropout=0.0,
                                       compute_dtype=torch.bfloat16)
    per_step = train_launches(len(model.enc_layers), len(model.dec_layers), 0.0)
    times, metrics, totals = run_train(state, step, x1, extras, args.seed, 2, per_step)
    records["fused_message_edge_lnmod_bwd"]["launches"] = totals["fused_message_edge_lnmod_bwd"]
    log(f"phase train_p0: {time.perf_counter() - t0:.2f} s; 2 steps at dropout 0: "
        f"{statistics.median(times):.2f} ms/step; launches a step {per_step}")
    del model, state, step, x1, extras

    t0 = time.perf_counter()
    rows = run_train_cli(args.seed, device)
    log(f"phase train_entry: {time.perf_counter() - t0:.2f} s; train_latent.main "
        f"--bf16 --batch_size {B} --max_steps {len(rows)}: losses "
        f"{[round(r['loss'], 4) for r in rows]}, last {rows[-1]['steps_per_sec']:.2f} "
        f"steps/s; `last` restores")

    t0 = time.perf_counter()
    train_reference(args.seed, device)
    log(f"phase train_reference: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    x1, extras = train_batch(B, L, args.seed + 1, device)
    model, state, step = build_trainer(device, args.seed, compute_dtype=torch.bfloat16,
                                       gates=True, adaln_mode="residual")
    per_step = train_launches(len(model.enc_layers), len(model.dec_layers), P_DROP,
                              "residual")
    torch.cuda.reset_peak_memory_stats()
    ran = set()
    times, metrics, totals = run_train(state, step, x1, extras, args.seed, RESID_TRAIN_STEPS,
                                       per_step, traced=1, names=ran)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # bf16 K6 and its backward run on the tensor cores: no CUDA-core chain
    # kernel in the step
    if not all(any(k in n for n in ran) for k in ("message_edge_mma_kernel",
                                                  "message_edge_bwd_mma_kernel")) or any(
            "chain_kernel" in n or "chain_bwd_kernel" in n for n in ran):
        raise RuntimeError("the traced residual training step did not run K6 and its "
                           f"backward on their tensor-core kernels: {sorted(ran)}")
    records["fused_message_edge_bwd"]["launches"] = totals["fused_message_edge_bwd"]
    log(f"  residual train: {RESID_TRAIN_STEPS} steps B{B} L{L} K{K} H{H} bf16 dropout "
        f"{P_DROP}, gates open: median of the {len(times)} untraced "
        f"{statistics.median(times):.2f} ms/step (first {times[0]:.1f} ms), "
        f"{1e3 / statistics.median(times):.2f} steps/s, peak memory {peak:.2f} GiB; launches "
        f"a step {per_step} (asserted); K6 ran as message_edge_mma_kernel, its backward as "
        f"message_edge_bwd_mma_kernel, no chain_kernel or chain_bwd_kernel; "
        f"last loss {float(metrics['loss']):.5g}, grad_norm {float(metrics['grad_norm']):.5g}")
    del model, state, step, x1, extras
    train_reference(args.seed, device, dropout=0.0, adaln_mode="residual")
    rows = run_train_cli(args.seed, device, steps=3, adaln_mode="residual")
    log(f"  train_latent.main --adaln_mode residual --bf16 --batch_size {B} --max_steps "
        f"{len(rows)}: losses {[round(r['loss'], 4) for r in rows]}; `last` restores")
    log(f"phase residual_train: {time.perf_counter() - t0:.2f} s")

    phase_train_stage2_full(args.seed, device, records, card)

    t0 = time.perf_counter()
    pipe = build_recon(device, args.seed)
    run_recon(pipe, s1_batch)                   # first use: tables to the card
    torch.cuda.reset_peak_memory_stats()
    out = run_recon(pipe, s1_batch)
    check_recon(out, s1_batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("edge_gather", "edge_aggregate", "fused_tp"):
        records[name]["launches"] = out["enc_launches"][name] + out["dec_launches"][name]
    nb, nl = s1_batch["res_type"].shape
    sec = out["seconds"]
    log(f"phase recon: {time.perf_counter() - t0:.2f} s; batch {nb}x{nl} f32: "
        f"{sec * 1e3:.2f} ms a batch: encoder {out['encoder_seconds'] * 1e3:.2f} ms "
        f"({out['encoder_seconds'] / sec:.3f}), snap + decode + xyz14 "
        f"{out['decode_seconds'] * 1e3:.2f} ms ({out['decode_seconds'] / sec:.3f}), metrics "
        f"{(sec - out['encoder_seconds'] - out['decode_seconds']) * 1e3:.2f} ms; peak memory "
        f"{peak:.2f} GiB; "
        f"launches per encoder forward {out['enc_launches']}, per decode "
        f"{out['dec_launches']}; metrics (random weights) "
        f"{ {k: round(v, 4) for k, v in out['metrics'].items()} }")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = run_recon(pipe, s1_batch)
    trace_summary(prof, traced["seconds"] * 1e3, 1, mine=STAGE1_KERNELS,
                  label="K8/K9/K10", unit="batch")
    recon_reference(args.seed, device)
    pipe = build_recon(device, args.seed, compute_dtype=torch.bfloat16)
    pipe.encode_latents(s1_batch)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h = pipe.encode_latents(s1_batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    if not torch.isfinite(h).all():
        raise RuntimeError("the bf16 encoder gave non-finite latents")
    log(f"  bf16 encoder forward at {nb}x{nl}: median {statistics.median(times):.2f} ms of 3 "
        f"(f32 {out['encoder_seconds'] * 1e3:.2f} ms)")
    log(f"phase recon total: {time.perf_counter() - t0:.2f} s")
    del pipe, out, s1_batch

    t0 = time.perf_counter()
    recon_trained(device)
    log(f"phase recon_trained: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    glob = run_recon_cli(args.seed, device)
    log(f"phase recon_entry: {time.perf_counter() - t0:.2f} s; cli.test --experiment recon "
        f"on 2 shards: global rmsd_aligned {glob['rmsd_aligned']:.4f}, ged {glob['ged']:.4f}, "
        f"clash {glob['clash']:.4f}; summary_stats.json written")

    t0 = time.perf_counter()
    latent_trained(device)
    log(f"phase latent_trained: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    lat_steps, lat_members = 100, 10
    # the val proteins' shards, which the distill phase reads too
    shard_dir = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    atexit.register(shutil.rmtree, shard_dir, True)
    cli = run_latent_cli(device, steps=lat_steps, ensemble=lat_members, shard_dir=shard_dir)
    log(f"phase latent_entry: cli.test --experiment latent, then prior (trained weights, "
        f"bf16, {lat_steps} ancestral steps, {lat_members} members, the first 96 frames of "
        f"prot_0030 and prot_0031; shards written in {cli['shard_seconds']:.2f} s); {card}:")
    for p, ref in JAX_EVAL.items():
        lat, pri = cli["latent"][p], cli["prior"][p]
        log(f"  {p} latent: " + ", ".join(f"{k} {lat[k]:.4f} (JAX {ref['latent'][k]:.4f})"
                                          for k in EVAL_TOL)
            + f"; member std of rmsd_aligned "
            f"{statistics.pstdev([m['rmsd_aligned'] for m in lat['per_ensemble']]):.4f}; "
            f"{lat['wallclock_sec']:.2f} s a protein; prior: rmsd_aligned "
            f"{pri['rmsd_aligned']:.4f} (JAX {ref['prior']['rmsd_aligned']:.4f}), ged "
            f"{pri['ged']:.4f}, clash {pri['clash']:.4f}, div {pri['div']:.4f}; "
            f"{pri['wallclock_sec']:.2f} s a protein")
    failures = check_latent_cli(cli, lat_steps, lat_members)
    launches = {k: v for k, v in cli["launches"].items() if v}
    for name in ("fused_message_sum", "fused_message_edge_lnmod", "edge_gather",
                 "edge_aggregate"):
        records[name]["latent_cli_launches"] = cli["launches"][name]
    log(f"  launches over the latent run {launches} (asserted: per draw "
        f"{chain_launches(lat_steps)} and a decode's {decoder_launches()})")
    pipe = trained_pipeline(device, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for p, shard in cli["shards"].items():
        b = {k: torch.as_tensor(v, device=device) for k, v in shard.items()}
        nb, nl = b["res_type"].shape
        draws = [run_slice(pipe, b, gen) for _ in range(3)]
        for d in draws:
            check_launches(d["launches"], {**chain_launches(lat_steps), **decoder_launches()},
                           f"the trained draw at L {nl}")
        sec = [d["seconds"] for d in draws]
        log(f"  trained bf16 draw + decode, {p} ({nb} x {nl}, K {min(64, nl)}): "
            f"{[round(x, 4) for x in sec]} s, warm median {statistics.median(sec[1:]):.4f} s "
            f"({lat_steps / statistics.median(sec[1:]):.2f} steps/s)")
        calls = check_trained_calls(pipe, b, gen)
        log(f"  kernel calls of a trained draw on {p} (first and last step, decode) against "
            f"their plain versions on the same inputs: "
            + "; ".join(f"{k} {n} calls at {shape}, max|d| {err:.3g} (max|ref| {ref:.4g}), "
                        f"{bad} failed" for k, (n, err, bad, shape, ref) in calls.items()))
        want = {"fused_message_sum": 12, "fused_message_edge_lnmod": 6,
                "edge_gather": decoder_launches()["edge_gather"],
                "edge_aggregate": decoder_launches()["edge_aggregate"]}
        if {k: v[0] for k, v in calls.items()} != want or any(v[2] for v in calls.values()):
            failures.append(f"the trained draw's kernel calls on {p} disagree with their "
                            f"plain versions or were not all seen (expected {want}): {calls}")
        names = trace_sampling(pipe, b, args.seed)
        if not any("message_edge_lnmod_mma_kernel" in n for n in names) or any(
                "chain_kernel" in n for n in names):
            failures.append(f"the traced trained draw at L {nl} did not run K2 on its "
                            f"tensor-core kernel: {sorted(names)}")
    del pipe, cli
    if failures:
        raise RuntimeError("the latent CLI: " + "; ".join(failures))
    log(f"phase latent_entry: {time.perf_counter() - t0:.2f} s")

    phase_guided_sampling(args.seed, device, records, card)

    t0 = time.perf_counter()
    s1_batch = stage1_batch(args.seed, device)
    per_step = stage1_train_launches()
    for dtype, n_steps, traced in ((torch.bfloat16, STAGE1_TRAIN_STEPS, 1),
                                   (torch.float32, 3, 0)):
        dname = str(dtype).split(".")[-1]
        _, state, step = build_stage1_trainer(device, args.seed, compute_dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        times, metrics, syncs = run_stage1_train(state, step, s1_batch, n_steps, per_step,
                                                 traced=traced)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if dtype == torch.bfloat16:
            for key, name in (("fused_tp_bwd", "fused_tp_bwd"), ("fused_tp_bf16", "fused_tp"),
                              ("edge_gather_bf16", "edge_gather"),
                              ("edge_aggregate_bf16", "edge_aggregate")):
                records[key]["launches"] = per_step[name] * n_steps
        nb, nl = s1_batch["res_type"].shape
        log(f"  train_stage1 {dname}: {n_steps} steps of make_vqvae_step at {nb}x{nl} (3 + 4 "
            f"layers, 512 codes, LossWeights(zeta=5, omega=3).dynamic(2)): median of the "
            f"{len(times)} untraced {statistics.median(times[1:] or times):.2f} ms/step (first "
            f"{times[0]:.1f} ms), host read of the loss {statistics.median(syncs):.2f} ms a "
            f"step (median), peak memory {peak:.2f} GiB; launches a step {per_step} "
            f"(asserted); last loss {float(metrics['loss']):.5g}, recon "
            f"{float(metrics['recon']):.5g}, vq {float(metrics['vq']):.4g}, perplexity "
            f"{float(metrics['vq_perplexity']):.4g}; skipped 0 at every step")
        del state, step
    log(f"phase train_stage1: {time.perf_counter() - t0:.2f} s")
    del s1_batch

    t0 = time.perf_counter()
    stage1_train_reference(args.seed, device)
    log(f"phase train_stage1_reference: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    chain = run_stage1_cli(args.seed, device)
    tv = chain["train_vqvae"]
    log(f"phase train_stage1_entry: {time.perf_counter() - t0:.2f} s; train_vqvae -bf16 "
        f"epochs {tv['epochs']} (the third after -resume) train loss "
        f"{[round(v, 4) for v in tv['train_loss']]}, {tv['steps']} steps, "
        f"{tv['seconds'][0]:.2f} s + {tv['seconds'][1]:.2f} s; extract_features "
        f"{chain['extract_features']}; train_latent losses "
        f"{[round(v, 4) for v in chain['train_latent']['losses']]}; test --experiment recon "
        f"--vae_ckpt rmsd_aligned {chain['test_recon']['rmsd_aligned']:.4f}, ged "
        f"{chain['test_recon']['ged']:.4f}")

    phase_stage1_variants(args.seed, device, records, card)
    phase_flows(args.seed, device, records, card, diffusion_rate)
    phase_distill(args.seed, device, records, card, shard_dir)
    phase_parallel(args.seed, device, records, card)
    phase_import_and_mpnn(args.seed, device, card)
    log(f"total: {time.perf_counter() - t_start:.2f} s")

    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
