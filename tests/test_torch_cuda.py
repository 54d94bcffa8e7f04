"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a card. These cover the ragged
and odd shapes that the full-width run in ``chip_smoke.py`` does not: F not
a multiple of the column tile, K not a multiple of the hidden tile, q not a
multiple of the edge tile, ids out of range, N above the shared-memory
histogram. On the machine with the card (no JAX there, so without the
repository's conftest):

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from sgs_gnn_tpu_torch.ops import scatter as sc
from sgs_gnn_tpu_torch.ops import score_sampled as ss
from sgs_gnn_tpu_torch.ops._build import LAUNCHES

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False); the CPU runs the plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sum_tol(abs_sum):
    # f32 sums in another order (atomics): error well under 1e-5 of the sum
    # of magnitudes plus a floor for empty rows
    return 1e-5 * abs_sum + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,f,order", [(37, 1001, 41, "random"),
                                         (2048, 20000, 256, "sorted"),
                                         (5, 333, 300, "random"),
                                         (64, 4096, 1, "sorted")])
def test_scatter_add_kernel(card, dtype, n, e, f, order):
    g = torch.Generator(device=card).manual_seed(0)
    vals = torch.randn(e, f, generator=g, device=card).to(dtype)
    ids = torch.randint(-1, n + 1, (e,), generator=g, device=card,
                        dtype=torch.int32)
    if order == "sorted":
        ids = ids.sort().values
    before = LAUNCHES["scatter_add"]
    out = sc.scatter_add(vals, ids, n)
    torch.cuda.synchronize()
    assert LAUNCHES["scatter_add"] == before + 1
    ref = sc.scatter_add_plain(vals, ids, n)
    tol = _sum_tol(sc.scatter_add_plain(vals.abs(), ids, n))
    assert out.dtype == torch.float32 and out.shape == (n, f)
    assert bool(((out - ref).abs() <= tol).all())


@pytest.mark.parametrize("n", [1, 2048, 12288, 12289, 100_000])
def test_segment_sum_scalar_kernel(card, n):
    e = 50_000
    g = torch.Generator(device=card).manual_seed(1)
    w = torch.rand(e, generator=g, device=card)
    ids = torch.randint(-1, n + 1, (e,), generator=g, device=card,
                        dtype=torch.int32)
    before = LAUNCHES["segment_sum_scalar"]
    out = sc.segment_sum_scalar(w, ids, n)
    torch.cuda.synchronize()
    assert LAUNCHES["segment_sum_scalar"] == before + 1
    ref = sc.segment_sum_scalar_plain(w, ids, n)
    assert bool(((out - ref).abs() <= _sum_tol(ref)).all())
    ones = torch.ones_like(w)                  # counts are exact in f32
    assert torch.equal(sc.segment_sum_scalar(ones, ids, n),
                       sc.segment_sum_scalar_plain(ones, ids, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,f,k,q", [(37, 40, 50, 77), (2048, 256, 256, 4099),
                                     (9, 3, 300, 64), (100, 130, 1, 1)])
def test_score_head_kernel(card, dtype, n, f, k, q):
    g = torch.Generator(device=card).manual_seed(2)
    h = torch.randn(n, f, generator=g, device=card).to(dtype)
    fc1 = torch.randn(2 * f, k, generator=g, device=card) / (2 * f) ** 0.5
    b1 = torch.randn(k, generator=g, device=card) * 0.1
    fc2 = torch.randn(k, 1, generator=g, device=card) / k ** 0.5
    b2 = torch.randn(1, generator=g, device=card) * 0.1
    s = torch.randint(0, n, (q,), generator=g, device=card, dtype=torch.int32)
    r = torch.randint(0, n, (q,), generator=g, device=card, dtype=torch.int32)
    before = LAUNCHES["score_head_sampled"]
    out = ss.score_head_sampled(h, fc1, b1, fc2, b2, s, r)
    torch.cuda.synchronize()
    assert LAUNCHES["score_head_sampled"] == before + 1
    ref = ss.score_head_plain(h, *ss.split_head(h, fc1, b1, fc2, b2), s, r)
    # same bf16-rounded features on both sides; f32 sums in another order
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_kernels_raise_on_bad_input(card):
    v = torch.zeros(4, 3, device=card)
    with pytest.raises(TypeError):
        sc.scatter_add(v, torch.zeros(4, dtype=torch.int64, device=card), 2)
    with pytest.raises(TypeError):
        sc.scatter_add(v.half(), torch.zeros(4, dtype=torch.int32,
                                             device=card), 2)
    h = torch.zeros(4, 3, device=card)
    ids = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError):
        ss.score_head_sampled(h, torch.zeros(6, 5, device=card),
                              torch.zeros(5, device=card),
                              torch.zeros(5, 1, device=card),
                              torch.zeros(1, device=card), ids, ids,
                              drop_rate=0.5)
    with pytest.raises(NotImplementedError):
        sc.scatter_add(v.requires_grad_(), ids.new_zeros(4), 2)
