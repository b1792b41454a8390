"""K1/K2 CUDA kernels against their plain versions on the card.

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
@pytest.mark.parametrize("L,N,K", [(128, 128, 64), (37, 50, 32), (9, 9, 16)])
def test_kernels_match_plain(dev, dtype, atol, rtol, L, N, K):
    """Bench shape, a ragged L with a longer gather table, and a tiny K."""
    x = _inputs(dev, dtype, 3, L, N, K)
    MK.reset_launches()
    s = MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)
    e = MK.fused_message_edge_lnmod(*(x[k] for k in _EDGE))
    torch.cuda.synchronize()
    assert MK.LAUNCHES == {"fused_message_sum": 1, "fused_message_edge_lnmod": 1}
    _close(s, MK.ref_message_sum(*(x[k] for k in _SUM), 30.0), atol, rtol)
    _close(e, MK.ref_message_edge_lnmod(*(x[k] for k in _EDGE)), atol, rtol)


def test_kernel_refuses_a_k_it_cannot_tile(dev):
    x = _inputs(dev, torch.bfloat16, 1, 8, 8, 12)  # 12 does not divide 128
    with pytest.raises(ValueError):
        MK.fused_message_sum(*(x[k] for k in _SUM), 30.0)
