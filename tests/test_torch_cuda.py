"""The CUDA kernels against their plain versions on the card: K1-K5's
forwards against the plain versions, the backwards (K3, K4, K5's) against
torch.autograd of the plain versions on the same inputs and cotangent; K8
(bit for bit), K9 and K10 against theirs; K11 (K10's backward) and the
K8/K9 backwards (each the other kernel) against autograd of the plain
versions.

Marked `cuda`: they skip where there is no CUDA device. This file imports
no JAX, so on the machine with the card it runs without the suite's
conftest:  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from codlad_tpu_torch.kernels import mpnn_kernels as MK

pytestmark = pytest.mark.cuda

H = 128
# (dtype, atol, rtol): f32 as tests/test_kernels.py:77; bf16 ~2.5 ulps
TOLS = [(torch.float32, 2e-4, 2e-4), (torch.bfloat16, 2e-2, 2e-2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, B, L, N, K, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    return dict(A=r(B, L, H).to(dtype), E=r(B, L, K, H).to(dtype), Gn=r(B, N, H).to(dtype),
                idx=torch.randint(0, N, (B, L, K), generator=g).to(dev),
                mask=(torch.rand(B, L, K, generator=g) > 0.3).float().to(dev),
                W_e=r(H, H, sc=H ** -0.5).to(dtype), W2=r(H, H, sc=H ** -0.5).to(dtype),
                b2=r(H, sc=0.1), W3=r(H, H, sc=H ** -0.5).to(dtype), b3=r(H, sc=0.1),
                sh=r(B, H, sc=0.3), sc=r(B, H, sc=0.3), g=r(B, H))


_SUM = ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3", "b3")
_EDGE = ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3", "sh", "sc", "g")


def _close(got, want, atol, rtol):
    assert got.dtype == want.dtype
    d = (got.float() - want.float()).abs()
    assert bool((d <= atol + rtol * want.float().abs()).all()), d.max().item()


@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("L,N,K", [(128, 128, 64), (37, 50, 32), (9, 9, 16), (48, 48, 48)])
def test_kernels_match_plain(dev, dtype, atol, rtol, L, N, K):
    """Bench shape, a ragged L with a longer gather table, a tiny K, and the
    L = 48 bucket (K = 48 does not divide a block's rows: a partial tile)."""
    x = _inputs(dev, dtype, 3, L, N, K)
    MK.reset_launches()
    s = MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)
    e = MK.fused_message_edge_lnmod(*(x[k] for k in _EDGE))
    torch.cuda.synchronize()
    assert MK.LAUNCHES == dict(MK.LAUNCHES, fused_message_sum=1,
                               fused_message_edge_lnmod=1)
    assert sum(MK.LAUNCHES.values()) == 2
    _close(s, MK.ref_message_sum(*(x[k] for k in _SUM), 30.0), atol, rtol)
    _close(e, MK.ref_message_edge_lnmod(*(x[k] for k in _EDGE)), atol, rtol)


def test_kernel_refuses_a_k_it_cannot_tile(dev):
    x = _inputs(dev, torch.bfloat16, 1, 8, 8, 12)  # 12 does not divide 128
    with pytest.raises(ValueError):
        MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)


# Backwards. f32: atol 2e-4 + rtol 2e-4 elementwise, as the forwards. bf16:
# |d| <= 2e-2 * max|ref| + 2e-2 * |ref|: the kernels and autograd of the plain
# versions round to bf16 at different points of the backward chain (the TPU
# kernel's casts: cast(dx2), cast(dpre); autograd: the gradient at each cast
# of the forward), and the weight grads sum every edge row.
_GRAD = ("A", "E", "Gn", "W_e", "W2", "b2", "W3", "b3")


def _grad_close(name, got, want, dtype):
    assert got.dtype == want.dtype, name
    d = (got.float() - want.float()).abs()
    ref = want.float().abs()
    if dtype == torch.float32:
        bound = 2e-4 + 2e-4 * ref
    else:
        bound = 2e-2 * ref.max() + 2e-2 * ref
    assert bool((d <= bound).all()), (name, d.max().item(), ref.max().item())


def _grads(fn, x, keys, names, ct):
    leaves = {k: x[k].detach().clone().requires_grad_(k in names) for k in keys}
    out = fn(*(leaves[k] for k in keys))
    gs = torch.autograd.grad(out, [leaves[k] for k in names], ct)
    return out, dict(zip(names, gs))


def _check_bwd(kernel_fn, plain_fn, x, keys, names, ct, dtype):
    out_k, gk = _grads(kernel_fn, x, keys, names, ct)
    torch.cuda.synchronize()
    out_p, gp = _grads(plain_fn, x, keys, names, ct)
    for n in names:
        _grad_close(n, gk[n], gp[n], dtype)
    return out_k, out_p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,N,K", [(37, 50, 32), (9, 9, 16), (20, 20, 64), (48, 48, 48)])
def test_backward_kernels_match_plain_autograd(dev, dtype, L, N, K):
    """K3 through fused_message_sum, K4 through fused_message_edge_lnmod."""
    x = _inputs(dev, dtype, 3, L, N, K, seed=1)
    g = torch.Generator().manual_seed(2)
    ct_sum = torch.randn(3, L, H, generator=g).to(dev)
    ct_edge = torch.randn(3, L, K, H, generator=g).to(dev).to(dtype)
    MK.reset_launches()
    _check_bwd(lambda *a: MK.fused_message_sum(*a, 30.0),
               lambda *a: MK.ref_message_sum(*a, 30.0), x, _SUM, _GRAD, ct_sum, dtype)
    _check_bwd(MK.fused_message_edge_lnmod, MK.ref_message_edge_lnmod, x, _EDGE,
               _GRAD + ("sh", "sc", "g"), ct_edge, dtype)
    assert MK.LAUNCHES == dict(MK.LAUNCHES, fused_message_sum=1, fused_message_sum_bwd=1,
                               fused_message_edge_lnmod=1,
                               fused_message_edge_lnmod_bwd=1)
    assert sum(MK.LAUNCHES.values()) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernels_match_plain(dev, dtype):
    """K5: the seeded mask equals the plain generator's bit for bit; both
    variants' forwards and backwards match the plain versions."""
    B, L, N, K, p = 3, 21, 30, 32, 0.6
    x = _inputs(dev, dtype, B, L, N, K, seed=3)
    seeds = torch.tensor([11, -5, 2 ** 31 - 1], dtype=torch.int32, device=dev)
    ct = torch.randn(B, L, K, H, generator=torch.Generator().manual_seed(4)).to(dev).to(dtype)
    names = _GRAD + ("sh", "sc", "g")
    MK.reset_launches()
    out, mask = MK.edge_lnmod_pdrop_debug(*(x[k] for k in _EDGE), seeds, p)
    torch.cuda.synchronize()
    want = MK.keep_scales(seeds, (L, K, H), p)
    assert torch.equal(mask, want)
    atol, rtol = dict((d, (a, r)) for d, a, r in TOLS)[dtype]
    _close(out, MK.plain_message_edge_lnmod_pdrop(*(x[k] for k in _EDGE), seeds, p),
           atol, rtol)
    _check_bwd(lambda *a: MK.fused_message_edge_lnmod_pdrop(*a, seeds, p),
               lambda *a: MK.plain_message_edge_lnmod_pdrop(*a, seeds, p),
               x, _EDGE, names, ct, dtype)
    keep = want.to(dtype)
    _check_bwd(lambda *a: MK.fused_message_edge_lnmod_drop(*a, keep),
               lambda *a: MK.ref_message_edge_lnmod(*a, keep=keep), x, _EDGE, names, ct,
               dtype)
    assert MK.LAUNCHES == dict(MK.LAUNCHES, fused_message_edge_lnmod_drop=3,
                               fused_message_edge_lnmod_drop_bwd=2)
    assert sum(MK.LAUNCHES.values()) == 5


# Stage-1 kernels. K8 is an index read: bit for bit. K9 sums in f32 in
# another order than index_add_: f32 atol 2e-4 + rtol 2e-4; bf16 within
# 2^-6 |ref| + 1e-4 max|ref| (a sum on the other side of a bf16 rounding
# boundary, then the division rounds again). K10 f32 atol 2e-4 + rtol 2e-4;
# bf16 2e-2 max|ref| (the plain version rounds TR to bf16, the kernel does
# not, as the Pallas kernel does not).
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _edges(dev, B, E, N, seed):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, N, (B, E), generator=g, dtype=torch.int32)
    mask = (torch.rand(B, E, generator=g) > 0.3).float()
    idx[:, E // 2:] = 0            # padding: index 0, mask 0
    mask[:, E // 2:] = 0.0
    return idx.to(dev), mask.to(dev), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_kernels_match_plain(dev, dtype):
    from codlad_tpu_torch.kernels import edge_kernels as EK
    B, E, N = 2, 3000, 300
    idx, mask, g = _edges(dev, B, E, N, 5)
    EK.reset_launches()
    for F in (4, 13, 48):
        nodes = torch.randn(B, N, F, generator=g).to(dev).to(dtype)
        got = EK.edge_gather(idx, mask, nodes)
        want = EK.ref_gather(idx, mask, nodes)
        assert torch.equal(got.view(_BITS[dtype]), want.view(_BITS[dtype]))
        msgs = torch.randn(B, E, F, generator=g).to(dev).to(dtype)
        csr = EK.build_csr(idx, mask, N)
        for reduce in ("sum", "mean"):
            got = EK.edge_aggregate(idx, mask, msgs, N, reduce, csr)
            assert torch.equal(got, EK.edge_aggregate(idx, mask, msgs, N, reduce, csr))
            want = EK.ref_aggregate(idx, mask, msgs, N, reduce)
            d, ref = (got.float() - want.float()).abs(), want.float().abs()
            if dtype == torch.float32:
                assert bool((d <= 2e-4 + 2e-4 * ref).all()), d.max().item()
            else:
                assert bool((d <= 2 ** -6 * ref + 1e-4 * ref.max()).all()), d.max().item()
    torch.cuda.synchronize()
    assert EK.LAUNCHES == {"edge_gather": 3, "edge_aggregate": 12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", [0, 1, 2])
def test_fused_tp_matches_plain(dev, dtype, layer):
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables
    lad = irrep_ladder(12, 4)
    tb = fused_tp_tables(tuple(lad[layer]), tuple(SH_IRREPS), tuple(lad[layer + 1]))
    g = torch.Generator().manual_seed(layer)
    TK.reset_launches()
    for lead in ((2, 1000), (2, 9, 14)):       # edge rows (not a multiple of 32), cross graph
        x = torch.randn(*lead, lad[layer].dim, generator=g).to(dev).to(dtype)
        sh = sh_l2(torch.randn(*lead, 3, generator=g)).to(dev).to(dtype)
        w = torch.randn(*lead, tb["numel"], generator=g).to(dev).to(dtype)
        got = TK.fused_tp(x, sh, w, tb)
        want = TK.ref_fused_tp(x, sh, w, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
        assert got.dtype == dtype and got.shape == want.shape
        d, ref = (got.float() - want.float()).abs(), want.float().abs()
        if dtype == torch.float32:
            assert bool((d <= 2e-4 + 2e-4 * ref).all()), d.max().item()
        else:
            assert bool((d <= 2e-2 * ref.max()).all()), (d.max().item(), ref.max().item())
    torch.cuda.synchronize()
    assert TK.LAUNCHES == {"fused_tp": 2, "fused_tp_bwd": 0}


# K11 (f32 against the plain version's autograd in float64: atol 2e-4 +
# rtol 2e-4 + 2e-6 max|ref|; bf16 against the bf16 plain version's autograd:
# 2e-2 max|ref|, a few bf16 ulps of the largest element, as the rounding
# points differ: the plain forward rounds TR and wR to bf16, the kernel
# keeps them in f32).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", [0, 1, 2])
def test_fused_tp_backward_matches_plain(dev, dtype, layer):
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables
    lad = irrep_ladder(12, 4)
    tb = fused_tp_tables(tuple(lad[layer]), tuple(SH_IRREPS), tuple(lad[layer + 1]))
    g = torch.Generator().manual_seed(10 + layer)
    TK.reset_launches()
    n_bwd = 0
    for lead in ((2, 1000), (2, 9, 14)):
        x = torch.randn(*lead, lad[layer].dim, generator=g).to(dev).to(dtype)
        sh = sh_l2(torch.randn(*lead, 3, generator=g)).to(dev).to(dtype)
        w = (torch.randn(*lead, tb["numel"], generator=g) * 0.2).to(dev).to(dtype)
        ct = torch.randn(*lead, tb["SUMR"].shape[1], generator=g).to(dev).to(dtype)
        ref_dt = torch.float64 if dtype == torch.float32 else dtype
        for with_sh in (True, False):
            leaves = [x.clone().requires_grad_(True), sh.clone().requires_grad_(with_sh),
                      w.clone().requires_grad_(True)]
            diff = [t for t in leaves if t.requires_grad]
            got = torch.autograd.grad(TK.fused_tp(*leaves, tb), diff, ct)
            n_bwd += 1
            ref_leaves = [t.detach().to(ref_dt).requires_grad_(t.requires_grad) for t in leaves]
            out = TK.ref_fused_tp(*ref_leaves, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
            want = torch.autograd.grad(out, [t for t in ref_leaves if t.requires_grad],
                                       ct.to(ref_dt))
            for a, b in zip(got, want):
                assert a.dtype == dtype and a.shape == b.shape
                d, ref = (a.double() - b.double()).abs(), b.double().abs()
                if dtype == torch.float32:
                    bound = 2e-4 + 2e-4 * ref + 2e-6 * ref.max()
                else:
                    bound = 2e-2 * ref.max()
                assert bool((d <= bound).all()), (d.max().item(), ref.max().item())
    torch.cuda.synchronize()
    assert TK.LAUNCHES == {"fused_tp": n_bwd, "fused_tp_bwd": n_bwd}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_backwards_launch_each_other(dev, dtype):
    """d nodes of K8 is K9 over the CSR of its index: f32 within atol 1e-5 +
    rtol 1e-5 of the plain version's autograd in float64; bf16 (one f32 sum
    rounded once) within 2^-8 |ref| + 1e-5 max|ref| of the plain version's
    autograd in float32 on the same bf16 values. d msgs of K9 (sum, and mean
    over the valid degree) is K8 of the cotangent: bit for bit the plain
    version's autograd. Padded edges get no gradient."""
    from codlad_tpu_torch.kernels import edge_kernels as EK
    B, E, N, F = 2, 3000, 300, 13
    idx, mask, g = _edges(dev, B, E, N, 6)
    csr = EK.build_csr(idx, mask, N)
    nodes = torch.randn(B, N, F, generator=g).to(dev).to(dtype)
    msgs = torch.randn(B, E, F, generator=g).to(dev).to(dtype)
    ct_e = torch.randn(B, E, F, generator=g).to(dev).to(dtype)
    ct_n = torch.randn(B, N, F, generator=g).to(dev).to(dtype)
    EK.reset_launches()
    leaf = nodes.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(EK.edge_gather(idx, mask, leaf, csr), leaf, ct_e)
    ref_dt = torch.float64 if dtype == torch.float32 else torch.float32
    rl = nodes.to(ref_dt).requires_grad_(True)
    (want,) = torch.autograd.grad(EK.ref_gather(idx.long(), mask, rl), rl, ct_e.to(ref_dt))
    d, ref = (got.double() - want.double()).abs(), want.double().abs()
    bound = (1e-5 + 1e-5 * ref if dtype == torch.float32
             else 2 ** -8 * ref + 1e-5 * ref.max())
    assert got.dtype == dtype and bool((d <= bound).all()), d.max().item()
    for reduce in ("sum", "mean"):
        leaf = msgs.clone().requires_grad_(True)
        (got,) = torch.autograd.grad(EK.edge_aggregate(idx, mask, leaf, N, reduce, csr), leaf,
                                     ct_n)
        rl = msgs.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(EK.ref_aggregate(idx.long(), mask, rl, N, reduce), rl,
                                      ct_n)
        assert got.dtype == dtype and torch.equal(got, want), reduce
        assert bool((got[mask == 0] == 0).all())
    # no grad needed: no backward launch
    EK.edge_gather(idx, mask, nodes.clone().requires_grad_(False), csr)
    torch.cuda.synchronize()
    assert EK.LAUNCHES == {"edge_gather": 4, "edge_aggregate": 3}
