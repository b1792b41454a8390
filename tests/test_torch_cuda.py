"""The CUDA kernels against their plain versions on the card: K1-K7's
forwards against the plain versions, the backwards (K3, K4, K5's, K6's)
against torch.autograd of the plain versions on the same inputs and
cotangent (the bf16 K3 and K6 on the tensor cores at every K the featurizer
gives, bit for bit from run to run but K3's dGn; the bf16 K4, K5's and K6's
backwards on the tensor cores at the training shapes, K5's regenerated
mask the forward's, every output but dGn bit for bit from run to run; the
bf16 K5 forward on K2's tensor-core kernel, its seeded and keep-tensor
forms bit for bit each other and a keep of ones bit for bit K2); K8 (bit
for bit, every width, aligned and offset views), K9 (also bit for bit its
order emulated in torch, tests/_torch_aggregate_order.py) and
K10 against theirs (K10 in bf16 also on offset views); K11 (K10's
backward; in bf16 also on offset views) and the K8/K9 backwards (each the
other kernel) against autograd of the plain versions; the tensor-core K1
and K2 at every K the featurizer gives in bf16 and at every K the f32
wrapper takes in f32 (3xTF32), each bit for bit from run to run; K7
against K2's kernel then K1's, bit for bit, both dtypes; a guided self-conditioned f32 draw against the CPU, and a
remat training step against the plain one; CGPrior's kernel calls (K8-K11
over the CG graph) against the CPU, and the FSQ and Gumbel quantizers on
CUDA tensors against the CPU; an f32 flow draw by each solver against the
CPU, with its K1/K2 launches per denoiser evaluation.

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


@pytest.mark.parametrize("K", [16, 32, 48, 64])
def test_message_sum_bf16_tensor_cores_every_k(dev, K):
    """The tensor-core K1 at every K the featurizer gives, with L not a
    multiple of a block's residues and a gather table longer than L: within
    TOLS' bf16 limits of the plain version, and bit for bit from run to run
    (the K-sum is taken in a fixed order)."""
    x = _inputs(dev, torch.bfloat16, 2, 37, 50, K, seed=K)
    MK.reset_launches()
    s = MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)
    again = MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)
    torch.cuda.synchronize()
    assert MK.LAUNCHES["fused_message_sum"] == 2 and s.dtype == torch.float32
    assert torch.equal(s, again)
    _close(s, MK.ref_message_sum(*(x[k] for k in _SUM), 30.0), 2e-2, 2e-2)


def test_message_sum_bf16_refuses_k_off_the_warp_slab(dev):
    x = _inputs(dev, torch.bfloat16, 1, 8, 8, 24)  # a multiple of 8, not of 16
    with pytest.raises(ValueError):
        MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)


@pytest.mark.parametrize("L,N,K", [(16, 16, 16), (32, 32, 32), (48, 48, 48), (64, 64, 64),
                                   (37, 50, 32)])
def test_edge_lnmod_bf16_tensor_cores_every_k(dev, L, N, K):
    """The tensor-core K2 at every K the featurizer gives and at a ragged L
    with a longer gather table: within TOLS' bf16 limits of the plain
    version and bit for bit from run to run."""
    x = _inputs(dev, torch.bfloat16, 3, L, N, K, seed=20 + K)
    args = [x[k] for k in _EDGE]
    MK.reset_launches()
    e = MK.fused_message_edge_lnmod(*args)
    again = MK.fused_message_edge_lnmod(*args)
    torch.cuda.synchronize()
    assert MK.LAUNCHES["fused_message_edge_lnmod"] == 2 and e.dtype == torch.bfloat16
    assert torch.equal(e, again)
    _close(e, MK.ref_message_edge_lnmod(*args), 2e-2, 2e-2)


def test_edge_lnmod_bf16_refuses_k_off_the_warp_slab(dev):
    x = _inputs(dev, torch.bfloat16, 1, 8, 8, 24)  # a multiple of 8, not of 16
    with pytest.raises(ValueError):
        MK.fused_message_edge_lnmod(*(x[k] for k in _EDGE))


# The f32 K1 and K2 on the tensor cores (3xTF32) at every K the f32 wrapper
# takes (a multiple of 4 up to 64: K not a multiple of 16 leaves padding rows
# in a residue's last slab), L not a multiple of a K1 tile's 8 residues and a
# gather table longer than L: within TOLS' f32 limits of the plain version,
# and bit for bit from run to run (K1's K-sum is taken in a fixed order).
_F32_KS = list(range(4, 65, 4))


@pytest.mark.parametrize("K", _F32_KS)
def test_message_sum_f32_tensor_cores_every_k(dev, K):
    x = _inputs(dev, torch.float32, 2, 37, 50, K, seed=40 + K)
    MK.reset_launches()
    s = MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)
    again = MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)
    torch.cuda.synchronize()
    assert MK.LAUNCHES["fused_message_sum"] == 2 and s.dtype == torch.float32
    assert torch.equal(s, again)
    _close(s, MK.ref_message_sum(*(x[k] for k in _SUM), 30.0), 2e-4, 2e-4)


@pytest.mark.parametrize("K", _F32_KS)
def test_edge_lnmod_f32_tensor_cores_every_k(dev, K):
    x = _inputs(dev, torch.float32, 3, 37, 50, K, seed=60 + K)
    args = [x[k] for k in _EDGE]
    MK.reset_launches()
    e = MK.fused_message_edge_lnmod(*args)
    again = MK.fused_message_edge_lnmod(*args)
    torch.cuda.synchronize()
    assert MK.LAUNCHES["fused_message_edge_lnmod"] == 2 and e.dtype == torch.float32
    assert torch.equal(e, again)
    _close(e, MK.ref_message_edge_lnmod(*args), 2e-4, 2e-4)


@pytest.mark.parametrize("K", [6, 68])
def test_f32_kernels_refuse_a_k_the_wrapper_does_not_take(dev, K):
    x = _inputs(dev, torch.float32, 1, 8, 8, K)
    with pytest.raises(ValueError):
        MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)
    with pytest.raises(ValueError):
        MK.fused_message_edge_lnmod(*(x[k] for k in _EDGE))


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



# K6 (the raw per-edge messages) and K7 (K2 chained into K1), at L = K = 48 and
# 64 and a ragged L with a longer gather table. Forwards: f32 atol 2e-4 + rtol
# 2e-4; bf16 2e-2 max|ref| (K6's messages and K7's node sum), and K7's edge
# output, K2's arithmetic, within the JAX test's 5e-2 (tests/test_kernels.py:
# 796) + K2's rtol 2e-2. K6's backward as K4's (`_grad_close`).
_MSG = ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3")
_SHAPES_67 = [(48, 48, 48), (64, 64, 64), (37, 50, 32)]


def _fwd_close(got, want, dtype, atol_bf16=0.0, rtol_bf16=0.0):
    assert got.dtype == want.dtype
    d, ref = (got.float() - want.float()).abs(), want.float().abs()
    if dtype == torch.float32:
        bound = 2e-4 + 2e-4 * ref
    elif atol_bf16:
        bound = atol_bf16 + rtol_bf16 * ref
    else:
        bound = 2e-2 * ref.max()
    assert bool((d <= bound).all()), (d.max().item(), ref.max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,N,K", _SHAPES_67)
def test_message_edge_kernels_match_plain(dev, dtype, L, N, K):
    """K6's forward against ref_message_edge, its backward against autograd
    of ref_message_edge, one launch of each."""
    x = _inputs(dev, dtype, 3, L, N, K, seed=5)
    ct = torch.randn(3, L, K, H, generator=torch.Generator().manual_seed(6)).to(dev).to(dtype)
    MK.reset_launches()
    out_k, out_p = _check_bwd(MK.fused_message_edge, MK.ref_message_edge, x, _MSG, _GRAD, ct,
                              dtype)
    _fwd_close(out_k.detach(), out_p.detach(), dtype)
    assert MK.LAUNCHES == dict(MK.LAUNCHES, fused_message_edge=1, fused_message_edge_bwd=1)
    assert sum(MK.LAUNCHES.values()) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,N,K", _SHAPES_67)
def test_edge_then_sum_kernel_matches_plain(dev, dtype, L, N, K):
    """K7 against ref_edge_then_sum (K2's plain version, then K1's on its
    output), one launch; it refuses inputs that require grad."""
    x = _inputs(dev, dtype, 3, L, N, K, seed=7)
    y = _inputs(dev, dtype, 3, L, N, K, seed=8)  # the next layer's node chain
    args = ([x[k] for k in _EDGE] + [y["A"], y["Gn"]]
            + [y[k] for k in ("W_e", "W2", "b2", "W3", "b3")] + [x["mask"], 30.0])
    MK.reset_launches()
    e2, ns = MK.fused_edge_then_sum(*args)
    torch.cuda.synchronize()
    assert MK.LAUNCHES == dict(MK.LAUNCHES, fused_edge_then_sum=1)
    assert sum(MK.LAUNCHES.values()) == 1
    e2_p, ns_p = MK.ref_edge_then_sum(*args)
    assert ns.dtype == torch.float32 and e2.shape == x["E"].shape
    _fwd_close(e2, e2_p, dtype, atol_bf16=5e-2, rtol_bf16=2e-2)
    _fwd_close(ns, ns_p, dtype)
    args[0] = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError):
        MK.fused_edge_then_sum(*args)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,N,K", [(48, 48, 48), (64, 64, 64), (128, 128, 64), (37, 50, 32)])
def test_edge_then_sum_is_k2_then_k1_bit_for_bit(dev, dtype, L, N, K):
    """K7's edge output is K2's kernel's and its node sum is K1's kernel's
    run on that edge output, bit for bit (in bf16 all three share the
    tensor-core slab functions), so the pair-fused denoiser equals the
    unfused one."""
    x = _inputs(dev, dtype, 3, L, N, K, seed=9)
    y = _inputs(dev, dtype, 3, L, N, K, seed=10)
    args = ([x[k] for k in _EDGE] + [y["A"], y["Gn"]]
            + [y[k] for k in ("W_e", "W2", "b2", "W3", "b3")] + [x["mask"], 30.0])
    e2, ns = MK.fused_edge_then_sum(*args)
    e2_k = MK.fused_message_edge_lnmod(*args[:12])
    ns_k = MK.fused_message_sum(args[12], e2, args[13], args[3], args[19], *args[14:19],
                                args[20])
    torch.cuda.synchronize()
    assert torch.equal(e2, e2_k)
    assert torch.equal(ns, ns_k), (ns - ns_k).abs().max().item()

@pytest.mark.parametrize("L,N,K", [(16, 16, 16), (32, 32, 32), (48, 48, 48), (64, 64, 64),
                                   (37, 50, 32)])
def test_message_edge_bf16_tensor_cores_every_k(dev, L, N, K):
    """The tensor-core K6 (K2's chain with the raw epilogue) at every K the
    featurizer gives and at a ragged L with a longer gather table: within
    2e-2 max|ref| of the plain version (chip_smoke.py's MSG_TOL_BF16) and
    bit for bit from run to run."""
    x = _inputs(dev, torch.bfloat16, 3, L, N, K, seed=40 + K)
    args = [x[k] for k in _MSG]
    MK.reset_launches()
    e = MK.fused_message_edge(*args)
    again = MK.fused_message_edge(*args)
    torch.cuda.synchronize()
    assert MK.LAUNCHES["fused_message_edge"] == 2 and e.dtype == torch.bfloat16
    assert torch.equal(e, again)
    _fwd_close(e, MK.ref_message_edge(*args), torch.bfloat16)


def test_message_edge_bf16_refuses_k_off_the_warp_slab(dev):
    x = _inputs(dev, torch.bfloat16, 1, 8, 8, 24)  # a multiple of 8, not of 16
    with pytest.raises(ValueError):
        MK.fused_message_edge(*(x[k] for k in _MSG))


@pytest.mark.parametrize("L,N,K", [(16, 16, 16), (32, 32, 32), (48, 48, 48), (64, 64, 64),
                                   (37, 50, 32)])
def test_message_sum_bwd_bf16_tensor_cores_every_k(dev, L, N, K):
    """The tensor-core K3 (main pass and the weight-grad pass) at every K the
    featurizer gives and at a ragged L with a longer gather table: within
    the bf16 limits of test_backward_kernels_match_plain_autograd of plain
    autograd, and every output but dGn (f32 atomics) bit for bit from run to
    run."""
    x = _inputs(dev, torch.bfloat16, 3, L, N, K, seed=60 + K)
    ct = torch.randn(3, L, H, generator=torch.Generator().manual_seed(61)).to(dev)
    MK.reset_launches()
    _check_bwd(lambda *a: MK.fused_message_sum(*a, 30.0),
               lambda *a: MK.ref_message_sum(*a, 30.0), x, _SUM, _GRAD, ct, torch.bfloat16)
    args = [x[k] for k in ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3")]
    first = MK.message_sum_bwd(*args, ct / 30.0)
    again = MK.message_sum_bwd(*args, ct / 30.0)
    torch.cuda.synchronize()
    assert MK.LAUNCHES["fused_message_sum_bwd"] == 3
    for name, a, b in zip(("dA", "dE", "dGn", "dW_e", "dW2", "db2", "dW3", "db3"), first, again):
        if name != "dGn":
            assert torch.equal(a, b), name


def test_message_sum_bwd_bf16_refuses_k_off_the_warp_slab(dev):
    x = _inputs(dev, torch.bfloat16, 1, 8, 8, 24)  # a multiple of 8, not of 16
    args = [x[k] for k in ("A", "E", "Gn", "idx", "mask", "W_e", "W2", "b2", "W3")]
    with pytest.raises(ValueError):
        MK.message_sum_bwd(*args, torch.zeros(1, 8, H, device=dev))


@pytest.mark.parametrize("L,N,K", [(37, 50, 32), (48, 48, 48)])
def test_edge_backwards_bf16_weight_grads_repeat(dev, L, N, K):
    """K4's, K5's and K6's backwards in bf16 (tensor-core main passes and
    the weight-grad pass they share with K3): every output but dGn (f32
    atomics) repeats bit for bit from run to run (their limits against
    plain autograd are the tests above and below)."""
    x = _inputs(dev, torch.bfloat16, 3, L, N, K, seed=70 + K)
    g = torch.Generator().manual_seed(71)
    ct = torch.randn(3, L, K, H, generator=g).to(dev).to(torch.bfloat16)
    seeds = torch.tensor([3, 4, 5], dtype=torch.int32, device=dev)
    base = [x[k] for k in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3")]
    edge = base + [x["b3"], x["sc"], x["g"], ct]
    calls = [lambda: MK.message_edge_lnmod_bwd(*edge),
             lambda: MK.message_edge_lnmod_bwd(*edge, seeds=seeds, p=0.6),
             lambda: MK.message_edge_bwd(*base, ct)]
    for call in calls:
        first, again = call(), call()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(first, again)):
            if i != 2:                      # dGn
                assert torch.equal(a, b), i


@pytest.mark.parametrize("B,L,N,K", [(96, 128, 128, 64), (96, 48, 48, 48), (3, 37, 50, 32)])
def test_edge_backwards_bf16_tensor_cores(dev, B, L, N, K):
    """The tensor-core K4, K5's backward (seeds) and K6's backward at the
    training shapes (B96 L128 K64, the L = 48 bucket) and a ragged L with a
    longer gather table: against plain autograd within the bf16 limits of
    test_backward_kernels_match_plain_autograd; the seeded backward equals
    the keep-tensor backward given the forward's own mask
    (edge_lnmod_pdrop_debug) bit for bit but dGn, so the mask it regenerates
    is the forward's."""
    bf, p = torch.bfloat16, 0.6
    x = _inputs(dev, bf, B, L, N, K, seed=80 + K)
    g = torch.Generator().manual_seed(81)
    ct = torch.randn(B, L, K, H, generator=g).to(dev).to(bf)
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=g, dtype=torch.int32).to(dev)
    names = _GRAD + ("sh", "sc", "g")
    MK.reset_launches()
    _check_bwd(MK.fused_message_edge_lnmod, MK.ref_message_edge_lnmod, x, _EDGE, names, ct, bf)
    _check_bwd(lambda *a: MK.fused_message_edge_lnmod_pdrop(*a, seeds, p),
               lambda *a: MK.plain_message_edge_lnmod_pdrop(*a, seeds, p), x, _EDGE, names,
               ct, bf)
    _check_bwd(MK.fused_message_edge, MK.ref_message_edge, x, _MSG, _GRAD, ct, bf)
    assert MK.LAUNCHES == dict(MK.LAUNCHES, fused_message_edge_lnmod_bwd=1,
                               fused_message_edge_lnmod_drop_bwd=1, fused_message_edge_bwd=1)
    _, mask = MK.edge_lnmod_pdrop_debug(*(x[k] for k in _EDGE), seeds, p)
    base = [x[k] for k in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3")]
    edge = base + [x["b3"], x["sc"], x["g"], ct]
    seeded = MK.message_edge_lnmod_bwd(*edge, seeds=seeds, p=p)
    kept = MK.message_edge_lnmod_bwd(*edge, keep=mask.to(bf))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(seeded, kept)):
        if i != 2:                          # dGn
            assert torch.equal(a, b), i


@pytest.mark.parametrize("B,L,N,K", [(96, 128, 128, 64), (96, 48, 48, 48), (3, 37, 50, 32)])
def test_dropout_forward_bf16_tensor_cores(dev, B, L, N, K):
    """K5's bf16 forward runs K2's tensor-core kernel: the debug forward's
    mask is keep_scales'; the seeded forward equals the debug forward and
    the keep-tensor forward given that mask, and a keep of ones equals K2,
    each bit for bit; every forward repeats bit for bit; within 2e-2
    max|ref| of the plain version (K6's limit: at these shapes a few
    elements pass the elementwise 2e-2 + 2e-2 |ref| by a bf16 flip that
    the keep scale 2.5 enlarges, while the kernel and the plain version
    lie equally far from a float64 reference)."""
    bf, p = torch.bfloat16, 0.6
    x = _inputs(dev, bf, B, L, N, K, seed=90 + K)
    args = [x[k] for k in _EDGE]
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=torch.Generator().manual_seed(91),
                          dtype=torch.int32).to(dev)
    MK.reset_launches()
    out, mask = MK.edge_lnmod_pdrop_debug(*args, seeds, p)
    seeded = MK.fused_message_edge_lnmod_pdrop(*args, seeds, p)
    kept = MK.fused_message_edge_lnmod_drop(*args, mask.to(bf))
    ones = MK.fused_message_edge_lnmod_drop(*args, torch.ones_like(out))
    torch.cuda.synchronize()
    assert MK.LAUNCHES["fused_message_edge_lnmod_drop"] == 4
    assert torch.equal(mask, MK.keep_scales(seeds, (L, K, H), p))
    assert torch.equal(seeded, out) and torch.equal(kept, out)
    assert torch.equal(ones, MK.fused_message_edge_lnmod(*args))
    assert torch.equal(MK.fused_message_edge_lnmod_pdrop(*args, seeds, p), seeded)
    assert torch.equal(MK.fused_message_edge_lnmod_drop(*args, mask.to(bf)), kept)
    want = MK.plain_message_edge_lnmod_pdrop(*args, seeds, p).float()
    assert (out.float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_dropout_forward_bf16_refuses_k_off_the_warp_slab(dev):
    x = _inputs(dev, torch.bfloat16, 1, 8, 8, 24)  # a multiple of 8, not of 16
    seeds = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        MK.fused_message_edge_lnmod_pdrop(*(x[k] for k in _EDGE), seeds, 0.6)


def test_edge_backwards_bf16_refuse_k_off_the_warp_slab(dev):
    x = _inputs(dev, torch.bfloat16, 1, 8, 8, 24)  # a multiple of 8, not of 16
    base = [x[k] for k in ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3")]
    ct = torch.zeros(1, 8, 24, H, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        MK.message_edge_lnmod_bwd(*base, x["b3"], x["sc"], x["g"], ct)
    with pytest.raises(ValueError):
        MK.message_edge_bwd(*base, ct)


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


def _offset_view(t, elems):
    """t's values in a contiguous view that starts `elems` elements into
    its storage (so its data_ptr() is off the 8- and 16-byte grid)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = buf[elems:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.contiguous().data_ptr() == view.data_ptr()
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 3, 4, 12, 36, 37, 48])
def test_edge_gather_bit_for_bit(dev, dtype, F):
    """K8 equals ref_gather bit for bit at every width, on aligned nodes (the
    vector path where F % 4 == 0) and on a view whose data_ptr() is not 8-
    or 16-byte aligned (the scalar path), with B*E (2 x 1001) not a multiple
    of a block's 256 threads."""
    from codlad_tpu_torch.kernels import edge_kernels as EK
    B, E, N = 2, 1001, 77
    idx, mask, g = _edges(dev, B, E, N, 7 + F)
    nodes = torch.randn(B, N, F, generator=g).to(dev).to(dtype)
    EK.reset_launches()
    for view in (nodes, _offset_view(nodes, 1), _offset_view(nodes, 3)):
        got = EK.edge_gather(idx, mask, view)
        want = EK.ref_gather(idx, mask, view)
        assert got.dtype == dtype and got.shape == (B, E, F)
        assert torch.equal(got.view(_BITS[dtype]), want.view(_BITS[dtype]))
    torch.cuda.synchronize()
    assert EK.LAUNCHES["edge_gather"] == 3


def test_edge_gather_refuses_int32_overflow(dev):
    from codlad_tpu_torch.kernels import edge_kernels as EK
    idx = torch.zeros((1, 2 ** 16), dtype=torch.int32, device=dev)
    nodes = torch.empty((1, 1, 2 ** 15), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="2\\^31"):
        EK.edge_gather(idx, torch.ones(idx.shape, device=dev), nodes)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_fused_tp_bf16_unaligned_views(dev, layer):
    """The bf16 (tensor-core) K10 on operands that start off the 16-byte
    grid (its 2-byte staging path) and on one row, as on aligned ones,
    within 2e-2 max|ref| of the plain version."""
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables
    lad = irrep_ladder(12, 4)
    tb = fused_tp_tables(tuple(lad[layer]), tuple(SH_IRREPS), tuple(lad[layer + 1]))
    g = torch.Generator().manual_seed(30 + layer)
    bf = torch.bfloat16
    for m in (77, 1):
        x = torch.randn(m, lad[layer].dim, generator=g).to(dev).to(bf)
        sh = sh_l2(torch.randn(m, 3, generator=g)).to(dev).to(bf)
        w = torch.randn(m, tb["numel"], generator=g).to(dev).to(bf)
        want = TK.ref_fused_tp(x, sh, w, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
        aligned = TK.fused_tp(x, sh, w, tb)
        shifted = TK.fused_tp(_offset_view(x, 1), _offset_view(sh, 3), _offset_view(w, 5), tb)
        torch.cuda.synchronize()
        assert torch.equal(aligned, shifted)
        d, ref = (aligned.float() - want.float()).abs(), want.float().abs()
        assert bool((d <= 2e-2 * ref.max()).all()), (d.max().item(), ref.max().item())


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


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_fused_tp_bwd_bf16_unaligned_views(dev, layer):
    """The tensor-core K11 on operands that start off the 16-byte grid (its
    2-byte staging paths), on one row and on 77 (not a multiple of a
    block's 48): the same bits as on aligned copies and from run to run,
    with and without dsh, within 2e-2 max|ref| of the plain version's
    autograd."""
    from codlad_tpu_torch.kernels import tp_kernels as TK
    from codlad_tpu_torch.models.encoder import irrep_ladder
    from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
    from codlad_tpu_torch.nn.tensor_product import fused_tp_tables
    lad = irrep_ladder(12, 4)
    tb = fused_tp_tables(tuple(lad[layer]), tuple(SH_IRREPS), tuple(lad[layer + 1]))
    g = torch.Generator().manual_seed(50 + layer)
    bf = torch.bfloat16
    for m in (77, 1):
        x = torch.randn(m, lad[layer].dim, generator=g).to(dev).to(bf)
        sh = sh_l2(torch.randn(m, 3, generator=g)).to(dev).to(bf)
        w = (torch.randn(m, tb["numel"], generator=g) * 0.2).to(dev).to(bf)
        ct = torch.randn(m, tb["SUMR"].shape[1], generator=g).to(dev).to(bf)
        TK.reset_launches()
        aligned = TK.fused_tp_bwd(x, sh, w, ct, tb)
        again = TK.fused_tp_bwd(x, sh, w, ct, tb)
        shifted = TK.fused_tp_bwd(_offset_view(x, 1), _offset_view(sh, 3), _offset_view(w, 5),
                                  _offset_view(ct, 7), tb)
        no_dsh = TK.fused_tp_bwd(x, sh, w, ct, tb, want_dsh=False)
        torch.cuda.synchronize()
        assert TK.LAUNCHES["fused_tp_bwd"] == 4 and no_dsh[1] is None
        for a, b, c, name in zip(aligned, again, shifted, ("dx", "dsh", "dw")):
            assert torch.equal(a, b) and torch.equal(a, c), name
        assert torch.equal(no_dsh[0], aligned[0]) and torch.equal(no_dsh[2], aligned[2])
        leaves = [t.clone().requires_grad_(True) for t in (x, sh, w)]
        out = TK.ref_fused_tp(*leaves, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
        want = torch.autograd.grad(out, leaves, ct)
        for a, b, name in zip(aligned, want, ("dx", "dsh", "dw")):
            d, ref = (a.float() - b.float()).abs(), b.float().abs()
            assert bool((d <= 2e-2 * ref.max()).all()), (name, d.max().item(), ref.max().item())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [3, 12, 36, 48, 130])
def test_aggregate_is_its_emulated_order(dev, dtype, F):
    """K9 equals csr_order_aggregate (its order in torch, which
    tests/test_torch_aggregate_tiles.py holds against the TPU kernel) bit
    for bit, sum and mean, on fresh tensors and on offset views (which the
    wrapper copies to an aligned buffer), with a node of 200 edges and
    nodes of none; the C entry refuses msgs off the 16-byte grid."""
    from _torch_aggregate_order import csr_order_aggregate
    from codlad_tpu_torch.kernels import build
    from codlad_tpu_torch.kernels import edge_kernels as EK
    B, E, N = 2, 3000, 300
    idx, mask, g = _edges(dev, B, E, N, 6)
    idx[:, :200], mask[:, :200] = 5, 1.0
    msgs = torch.randn(B, E, F, generator=g).to(dev).to(dtype)
    csr = EK.build_csr(idx, mask, N)
    assert int((csr[0][1:] - csr[0][:-1]).max()) >= 200
    for reduce in ("sum", "mean"):
        want = csr_order_aggregate(csr, mask, msgs, N, reduce)
        for m in (msgs, _offset_view(msgs, 1)):
            got = EK.edge_aggregate(idx, mask, m, N, reduce, csr)
            assert torch.equal(got.view(_BITS[dtype]), want.view(_BITS[dtype])), reduce
    fn = build.entry("edge_ops", f"edge_aggregate_{EK._SUFFIX[dtype]}", EK._AGGREGATE_ARGS)
    out, shifted = torch.empty(B * N, F, dtype=dtype, device=dev), _offset_view(msgs, 1)
    with pytest.raises(RuntimeError, match="cudaError"):
        build.launch(fn, msgs.device, csr[0].data_ptr(), csr[1].data_ptr(), mask.data_ptr(),
                     shifted.data_ptr(), out.data_ptr(), B * N, F, 0)


def test_trained_denoiser_on_the_card(dev):
    """The converted trained Stage-2 denoiser (weights/convergence_latent.npz,
    EMA) on the card: one f32 denoise of two fixture frames through K1/K2
    against the same weights' plain versions on the CPU (the f32 kernels'
    atol 2e-4 + rtol 2e-4, as the kernel tests), 6 K1 and 3 K2 launches."""
    import os

    import numpy as np

    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.convert.from_flax import load_denoiser

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "weights", "convergence_vqvae_fixture.npz")) as fx:
        res, cg, mask = (fx["batch/res_type"][:2], fx["batch/cg_xyz_og"][:2, 1:-1],
                         fx["batch/res_mask"][:2])
    x = np.random.default_rng(0).standard_normal(res.shape + (3,)).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        model, _, _ = load_denoiser(os.path.join(root, "weights", "convergence_latent.npz"), d)
        args = [torch.as_tensor(a, device=d) for a in (res, cg, mask)]
        with torch.no_grad():
            cond = model.compute_condition(*args)
            kernels.reset_launches()
            out[str(d)] = model.denoise(torch.as_tensor(x, device=d),
                                        torch.full((2,), 500, device=d), cond).cpu()
        launches = kernels.launch_counts()
    assert launches["fused_message_sum"] == 6 and launches["fused_message_edge_lnmod"] == 3
    got, want = out[str(dev)], out["cpu"]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 2e-4 + 2e-4 * want.abs()).all(), (got - want).abs().max()


def _small_denoiser(d, seed=0, **kw):
    """A 1 + 1-layer H 128 denoiser with its adaLN heads drawn small (so that
    every layer reaches the output), on device d."""
    from codlad_tpu_torch.models.denoiser import MPNNDenoiser

    gen = torch.Generator().manual_seed(seed)
    model = MPNNDenoiser(gen, num_encoder_layers=1, num_decoder_layers=1, k_neighbors=16, **kw)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "Dense_0" in name and ("layers" in name or "w_out" in name):
                p.normal_(0.0, 0.02, generator=gen)
    return model.to(d)


def _jittered_batch(n, L, seed):
    """res_type, C-alpha trace (jittered off the exact 3.8 Å ties, so that
    the kNN order is the same on every device) and mask of n synthetic
    proteins."""
    import numpy as np

    from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch

    nb = synthetic_cg_batch(n, L, seed=seed)
    cg = nb["cg_xyz_og"][:, 1:-1]
    cg = cg + 0.1 * np.random.default_rng(seed).standard_normal(cg.shape)
    return {"res_type": torch.as_tensor(nb["res_type"]),
            "cg_xyz": torch.as_tensor(cg.astype(np.float32)),
            "mask": torch.as_tensor(nb["res_mask"])}


def test_guided_self_conditioned_draw_matches_the_cpu(dev):
    """A guided (cfg 1.5) f32 draw of a self-conditioned denoiser and
    process, 5 ancestral steps from the same x_T and noise, on the card and
    on the CPU: one K1/K2 launch a layer a step over the doubled batch, the
    latents within 1e-4 of max|latent| (the featurizer's self-edge rounding
    noise, as chip_smoke.py's reference check holds the plain path)."""
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.eval.harness import SamplingPipeline
    from codlad_tpu_torch.gen.diffusion import create_diffusion

    extras = _jittered_batch(2, 32, 3)
    g = torch.Generator().manual_seed(4)
    noise = torch.randn(extras["res_type"].shape + (3,), generator=g)
    zs = [torch.randn(noise.shape, generator=g) for _ in range(5)]
    out = {}
    for d in ("cpu", dev):
        pipe = SamplingPipeline(denoiser=_small_denoiser(d, self_condition=True),
                                process=create_diffusion("ddim5", self_condition=True),
                                vae=None, codebook=None, norm_mean=[0.0] * 3,
                                norm_std=[1.0] * 3, cfg_scale=1.5)
        kernels.reset_launches()
        out[str(d)] = pipe.sample_latents({k: v.to(d) for k, v in extras.items()},
                                          noise=noise.to(d), noises=[z.to(d) for z in zs]).cpu()
    launches = kernels.launch_counts()
    assert launches["fused_message_sum"] == 10 and launches["fused_message_edge_lnmod"] == 5
    got, want = out[str(dev)], out["cpu"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_remat_step_matches_the_plain_step_on_the_card(dev):
    """One f32 self-conditioned (coin heads) training step at dropout 0.6 with
    and without remat on the card: the masks are keyed by the seed, so the
    loss is the same bit for bit; the grads differ only by the order of K3's
    and K5's dGn atomics (within 1e-5 of max|grad|). With remat K1 and K5
    run once more a step, in the recomputed forward."""
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.gen.diffusion import create_diffusion
    from codlad_tpu_torch.train.state import TrainState
    from codlad_tpu_torch.train.steps import make_latent_step

    extras = {k: v.to(dev) for k, v in _jittered_batch(2, 32, 5).items()}
    x1 = torch.randn(extras["res_type"].shape + (3,),
                     generator=torch.Generator().manual_seed(6)).to(dev)
    out = {}
    for remat in (False, True):
        model = _small_denoiser(dev, dropout=0.6, self_condition=True, remat=remat)
        state = TrainState(dict(model.named_parameters()), lambda s: 1e-3, grad_clip=1.0)
        step, _ = make_latent_step(model, create_diffusion(None, self_condition=True))
        kernels.reset_launches()
        _, m = step(state, x1, extras, 7, self_cond=True)
        out[remat] = (m, kernels.launch_counts())
    (m0, n0), (m1, n1) = out[False], out[True]
    assert float(m0["loss"]) == float(m1["loss"])
    for k, g in m0["grads"].items():
        assert (m1["grads"][k] - g).abs().max() <= 1e-5 * g.abs().max() + 1e-12, k
    assert n0["fused_message_sum"] == 4 and n1["fused_message_sum"] == 6
    assert n0["fused_message_edge_lnmod_drop"] == 2 and n1["fused_message_edge_lnmod_drop"] == 3
    assert n0["fused_message_sum_bwd"] == n1["fused_message_sum_bwd"] == 2


def _stage1_batch(n_frames, n_res, seed, device):
    from codlad_tpu_torch.data.batch import collate, quantize_spec, spec_for
    from codlad_tpu_torch.data.cg_batch import to_device
    from codlad_tpu_torch.data.synthetic import synthetic_examples
    ex = synthetic_examples(n_frames, n_res, seed=seed)
    return to_device(collate(ex, quantize_spec(spec_for(ex))), device)


def test_cgprior_kernel_calls_match_plain(dev):
    """CGPrior's forward and backward on the card (K8-K11 over the CG graph)
    against the same module on the CPU (the plain versions), f32: mu and
    sigma within 1e-4, every parameter's grad within 1e-3 max|grad| + 1e-5
    of the largest grad; 3 K10 and 3 K11 launches (one a layer), 11 K8 and
    9 K9 (the forward's 8 gathers and 3 means, the backward's 3 and 6)."""
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.models.prior import CGPrior
    out = {}
    for d in ("cpu", dev):
        prior = CGPrior(torch.Generator().manual_seed(0)).to(d)
        batch = _stage1_batch(2, 40, 3, d)
        kernels.reset_launches()
        mu, sigma = prior(batch)
        (mu.square().sum() + sigma.sum()).backward()
        out[str(d)] = (mu.detach().cpu(), sigma.detach().cpu(),
                       {k: p.grad.cpu() for k, p in prior.named_parameters()},
                       kernels.launch_counts())
    (mu_c, sg_c, g_c, _), (mu_d, sg_d, g_d, n_d) = out["cpu"], out[str(dev)]
    assert (mu_d - mu_c).abs().max() <= 1e-4 and (sg_d - sg_c).abs().max() <= 1e-4
    scale = max(g.abs().max() for g in g_c.values())
    for k, g in g_c.items():
        assert (g_d[k] - g).abs().max() <= 1e-3 * g.abs().max() + 1e-5 * scale, k
    assert {k: v for k, v in n_d.items() if v} == {"edge_gather": 11, "edge_aggregate": 9,
                                                    "fused_tp": 3, "fused_tp_bwd": 3}


def test_fsq_and_gumbel_quantizers_on_cuda_match_cpu(dev):
    """FSQ and the Gumbel / ReinMax quantizer on CUDA tensors against the
    CPU, the same inputs, state and Gumbel noise: codes equal (FSQ's where
    the bounded value is more than 1e-4 from a rounding boundary), z_q,
    loss and new state within 1e-6, the gradient through the
    straight-through within 1e-6 + 1e-5 |ref|."""
    from codlad_tpu_torch.models import vq as TVQ
    g = torch.Generator().manual_seed(4)
    z = torch.randn(3, 50, 5, generator=g) * 2
    mask = (torch.rand(3, 50, generator=g) > 0.2).float()
    c = torch.randn(3, 50, 5, generator=g)
    fsq = TVQ.build_quantize("fsq_5", dim=5)
    res = {}
    for d in ("cpu", dev):
        zz = z.to(d).clone().requires_grad_(True)
        zq, idx, loss, st = fsq.quantize(None, zz, mask.to(d), train=True)
        (zq * c.to(d)).sum().backward()
        res[str(d)] = (zq.detach().cpu(), idx.cpu(), zz.grad.cpu())
    (zq_c, idx_c, gr_c), (zq_d, idx_d, gr_d) = res["cpu"], res[str(dev)]
    half_l, offset, shift, _, _ = TVQ.fsq_tables(fsq.levels)
    bounded = torch.tanh(z + shift) * half_l - offset
    safe = ((bounded - bounded.floor() - 0.5).abs() > 1e-4).all(-1)
    assert safe.float().mean() > 0.9
    assert torch.equal(idx_d[safe], idx_c[safe])
    assert (zq_d[safe] - zq_c[safe]).abs().max() <= 1e-6
    assert ((gr_d - gr_c).abs() <= 1e-6 + 1e-5 * gr_c.abs()).all()

    gq = TVQ.build_quantize("gumbel", codebook_size=32, dim=3)
    state = gq.init(torch.Generator().manual_seed(5))
    z3, c3 = z[..., :3].contiguous(), c[..., :3].contiguous()
    noise = TVQ.gumbel_noise((z3.shape[0] * z3.shape[1], 32), torch.Generator().manual_seed(6))
    res = {}
    for d in ("cpu", dev):
        zz = z3.to(d).clone().requires_grad_(True)
        zq, idx, loss, st = gq.quantize(state.to(d), zz, mask.to(d), train=True,
                                        noise=noise.to(d))
        ((zq * c3.to(d)).sum() + loss).backward()
        res[str(d)] = (zq.detach().cpu(), idx.cpu(), float(loss.detach()), st.to("cpu"),
                       zz.grad.cpu())
    (zq_c, idx_c, l_c, st_c, gr_c), (zq_d, idx_d, l_d, st_d, gr_d) = res["cpu"], res[str(dev)]
    assert torch.equal(idx_d, idx_c) and abs(l_d - l_c) <= 1e-6
    assert (zq_d - zq_c).abs().max() <= 1e-6
    for k, v in st_c.tensors().items():
        assert (st_d.tensors()[k] - v).abs().max() <= 1e-6 + 1e-6 * v.abs().max(), k
    assert ((gr_d - gr_c).abs() <= 1e-6 + 1e-5 * gr_c.abs()).all()


@pytest.mark.parametrize("method,steps,evals", [("euler", 4, 4), ("midpoint", 2, 4),
                                                ("rk4", 1, 4), ("dopri5", 2, None)])
def test_flow_draw_launches_and_matches_the_cpu(dev, method, steps, evals):
    """An f32 flow draw (1 + 1 layers, C output channels) by each solver on
    the card and on the CPU from the same x0: one K1 a layer and one K2 an
    encoder layer per denoiser evaluation (dopri5: 7 an attempt), nfe equal,
    the latents within 1e-4 of max|latent| (each side on its own
    conditioning, as the guided test above)."""
    from codlad_tpu_torch import kernels
    from codlad_tpu_torch.eval.harness import SamplingPipeline

    extras = _jittered_batch(2, 32, 5)
    noise = torch.randn(extras["res_type"].shape + (3,), generator=torch.Generator().manual_seed(6))
    out, nfe = {}, {}
    for d in ("cpu", dev):
        pipe = SamplingPipeline(denoiser=_small_denoiser(d, learn_sigma=False), process=None,
                                vae=None, codebook=None, norm_mean=[0.0] * 3, norm_std=[1.0] * 3,
                                process_kind="otcfm", ode_method=method, ode_steps=steps)
        kernels.reset_launches()
        out[str(d)] = pipe.sample_latents({k: v.to(d) for k, v in extras.items()},
                                          noise=noise.to(d)).cpu()
        nfe[str(d)] = pipe.last_ode["nfe"]
    launches = kernels.launch_counts()
    n = nfe[str(dev)]
    assert n == nfe["cpu"] and (evals is None or n == evals)
    assert launches["fused_message_sum"] == 2 * n and launches["fused_message_edge_lnmod"] == n
    got, want = out[str(dev)], out["cpu"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
