"""The port's hand-written kernels against their plain versions on an
NVIDIA card. Every test here is marked `cuda` and skips without a card (a
CUDA or Triton kernel has no CPU mode). The file imports no JAX, so that
it runs on a machine with torch alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from learning_embeddings_tpu_torch.ops import bn, bn_triton
from learning_embeddings_tpu_torch.ops import pairwise_order as k3

pytestmark = pytest.mark.cuda

#: (M, N, D): both routes' boundaries (D = 1, 2, 10, 16 = EXACT_D_MAX, then
#: 17 and 131 on the generic route), N ≡ 0, 1, 2, 3 (mod 4), M off the
#: 16-row tiles, the eval's shapes at 344 and 723 labels, and an empty one
K3_SHAPES = [(1, 1, 1), (37, 129, 10), (130, 7, 3), (5, 300, 131),
             (344, 5286, 10), (344, 344, 10), (0, 5, 3),
             (17, 128, 2), (33, 131, 16), (19, 130, 17), (7, 255, 5),
             (45, 4099, 12), (344, 5049, 10), (723, 5286, 10),
             (723, 723, 10)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_pairwise_order_kernel_matches_plain(gen, shape):
    m, n, d = shape
    ui = torch.randint(-3, 4, (m, d), device="cuda", generator=gen).float()
    vi = torch.randint(-3, 4, (n, d), device="cuda", generator=gen).float()
    before = (k3.LAUNCHES, k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES)
    got = k3.pairwise_order(ui, vi)
    torch.cuda.synchronize()
    exact = int(bool(m and n) and k3.route_for(d) == "exact_d")
    generic = int(bool(m and n) and k3.route_for(d) == "generic")
    assert (k3.LAUNCHES, k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES) == (
        before[0] + exact + generic, before[1] + exact, before[2] + generic)
    # integer-valued inputs: every partial sum is exact in f32
    assert torch.equal(got, k3.pairwise_order_plain(ui, vi))
    u = torch.randn((m, d), device="cuda", generator=gen)
    v = torch.randn((n, d), device="cuda", generator=gen)
    got = k3.pairwise_order(u, v)
    ref = k3.pairwise_order_plain(u, v)   # also Σ_d of the (≥ 0) terms
    # the same f32 terms summed in another order
    assert bool(((got - ref).abs() <= 1e-5 * ref + 1e-6).all())


@pytest.mark.parametrize("shape", [(37, 129, 10), (344, 5049, 10),
                                   (17, 128, 2)], ids=str)
def test_generic_route_matches_plain_at_small_d(gen, shape):
    """The generic kernel, which pairwise_order takes only past
    EXACT_D_MAX, is right at the exact_d route's D too."""
    m, n, d = shape
    ui = torch.randint(-3, 4, (m, d), device="cuda", generator=gen).float()
    vi = torch.randint(-3, 4, (n, d), device="cuda", generator=gen).float()
    before = (k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES)
    got = k3.pairwise_order_generic(ui, vi)
    torch.cuda.synchronize()
    assert (k3.EXACT_D_LAUNCHES, k3.GENERIC_LAUNCHES) == (before[0],
                                                          before[1] + 1)
    assert torch.equal(got, k3.pairwise_order_plain(ui, vi))


@pytest.mark.parametrize("R,C", [(12345, 100), (25088, 2048), (401408, 64)])
def test_bn_kernels_match_plain(gen, R, C):
    ints = [torch.randint(-1, 2, (R, C), device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2)]
    for got, want in ((bn_triton.bn_stats(ints[0]),
                       bn._stats_plain(ints[0])),
                      (bn_triton.bn_corr(*ints), bn._corr_plain(*ints))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)   # integer sums are exact in f32
