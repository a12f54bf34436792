"""The port's hand-written kernels against their plain versions on an
NVIDIA GPU. Imports no jax, so it runs on a machine with the card (and
no jax: --noconftest skips tests/conftest.py, which sets jax up):

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

Without a card every test skips (the decision is taken inside the
fixture, never at import).
"""
import pytest
import torch

from stp3_tpu_torch.ops.kernels import bev_splat as K1
from stp3_tpu_torch.ops.kernels import convnext_mlp as K2

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernels have no CPU or interpret mode)')
    return torch.device('cuda', 0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c', [8, 40, 64])
def test_bev_splat_kernel_matches_plain(cuda, dtype, c):
    gen = torch.Generator().manual_seed(c)
    f, p, ncells = 3, 1001, 97          # P not a multiple of a block's 8 warps
    feats = torch.randn(f, p, c, generator=gen).to(cuda, dtype)
    ranks = torch.randint(0, ncells + 1, (f, p), generator=gen, dtype=torch.int32).to(cuda)
    n = K1.bev_splat_accumulate.launches
    got = K1.bev_splat_accumulate(feats, ranks, ncells)
    assert K1.bev_splat_accumulate.launches == n + 1
    want = K1.bev_splat_accumulate_plain(feats, ranks, ncells)
    torch.cuda.synchronize()
    # fp32 on both sides; the atomics only reorder the sums
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n', [500, 2049])
def test_convnext_mlp_kernel_matches_plain(cuda, dtype, n):
    gen = torch.Generator().manual_seed(n)
    c = 64

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(cuda)

    h, x = rnd(n, c).to(dtype), rnd(n, c).to(dtype)
    weights = (rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1), rnd(c, 4 * c, scale=0.125),
               rnd(4 * c, scale=0.1), rnd(4 * c, c, scale=0.0625), rnd(c, scale=0.1),
               rnd(c, scale=0.5))
    k = K2.convnext_mlp.launches
    got = K2.convnext_mlp(h, x, *weights)
    assert K2.convnext_mlp.launches == k + 1 and got.dtype == dtype
    want = K2.convnext_mlp_plain(h, x, *weights)
    # the bf16 matmul operands can round one ULP apart (tests/test_convnext_kernel.py)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
