"""K1-K4 and K6-K8 against their plain versions on a CUDA card, at small
shapes with ragged edges, in fp32 (tolerance 1e-5: fp32 sums in another
order) and bf16 (both sides round one fp32 result to bf16, so an element
may differ by one bf16 ulp, at most 2^-7 of its value: the tolerance is
two such ulps of each element plus 1e-5). The backward kernels K6/K7 and
the dropout branches K8 use the same two tolerances, with rtol 1e-5
added in fp32 for gradients that are sums of a thousand terms. Skipped
where there is no card.
On the GPU machine, which has no JAX (the repo's conftest imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from mebt_tpu_torch.ops.attention_cuda import (
    dropout_branch,
    fused_attention,
    fused_dropout_attention,
    largeq_attention,
    largeq_attention_ref,
    largeq_backward,
    largeq_backward_ref,
    smallq_attention,
    smallq_attention_ref,
    smallq_backward,
    smallq_backward_ref,
)
from mebt_tpu_torch.ops.head_sample import (
    head_sample,
    head_sample_ref,
    head_topk_sample,
    head_topk_sample_ref,
)

pytestmark = pytest.mark.cuda

TOL = {
    torch.float32: dict(atol=1e-5, rtol=0),
    torch.bfloat16: dict(atol=1e-5, rtol=2.0**-6),
}
GRAD_TOL = {
    torch.float32: dict(atol=1e-5, rtol=1e-5),
    torch.bfloat16: dict(atol=1e-5, rtol=2.0**-6),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(gen, *shape, dtype, dev):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smallq_matches_plain(dev, dtype):
    gen = torch.Generator(dev).manual_seed(0)
    B, H, NQ, NK, Dh = 3, 2, 70, 130, 64
    q, k, v = (_randn(gen, B, H, n, Dh, dtype=dtype, dev=dev) for n in (NQ, NK, NK))
    mask = torch.rand(B, NK, generator=gen, device=dev) < 0.5
    mask[1] = False
    mask[2, 64:] = False  # whole key tiles without a live key
    before = smallq_attention.launches
    out, lse = smallq_attention(q, k, v, mask)
    ref, ref_lse = smallq_attention_ref(q, k, v, mask)
    assert smallq_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    assert torch.all(out[1] == 0) and torch.all(lse[1] == 1e30)


# fp32 K/V of 512 keys exceed shared memory (test_unsupported_shapes_raise)
@pytest.mark.parametrize(
    "dtype,NK",
    [(torch.float32, 8), (torch.float32, 256), (torch.bfloat16, 8),
     (torch.bfloat16, 256), (torch.bfloat16, 512)],
)
def test_largeq_matches_plain(dev, dtype, NK):
    gen = torch.Generator(dev).manual_seed(NK)
    B, H, NQ, Dh = 2, 2, 100, 64
    q = _randn(gen, B, H, NQ, Dh, dtype=dtype, dev=dev)
    k, v = (_randn(gen, B, H, NK, Dh, dtype=dtype, dev=dev) for _ in range(2))
    out = largeq_attention(q, k, v)
    torch.testing.assert_close(
        out.float(), largeq_attention_ref(q, k, v).float(), **TOL[dtype]
    )


def test_unsupported_shapes_raise(dev):
    q = torch.zeros(1, 1, 4, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        smallq_attention(q, q, q, torch.ones(1, 4, dtype=torch.bool, device=dev))
    k = torch.zeros(1, 1, 512, 64, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        largeq_attention(torch.zeros(1, 1, 4, 64, device=dev), k, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_sample_matches_plain(dev, dtype):
    gen = torch.Generator(dev).manual_seed(0)
    R, D, V = 300, 96, 1000  # no multiple of the 64-row / 64-column tiles
    x = _randn(gen, R, D, dtype=dtype, dev=dev)
    w = (0.1 * torch.randn(V, D, generator=gen, device=dev)).to(dtype)
    for temp in (1.0, 0.7):
        ids, probs = head_sample(x, w, 5, temp)
        rids, rprobs = head_sample_ref(x, w, temp, seed=5)
        assert (ids != rids).sum().item() <= 1  # a near-tie may flip
        same = ids == rids
        torch.testing.assert_close(probs[same], rprobs[same], rtol=1e-4, atol=1e-7)
    ids0, _ = head_sample(x, w, 5, 0.0)
    logits = x.float() @ w.float().t()
    assert (ids0.long() == logits.argmax(-1)).float().mean().item() >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,k", [(1000, 32), (1000, 1), (20, 32)])  # k >= V: k = V
def test_head_topk_sample_matches_plain(dev, dtype, V, k):
    gen = torch.Generator(dev).manual_seed(V + k)
    R, D = 300, 96  # no multiple of the 64-row / 64-column tiles
    x = _randn(gen, R, D, dtype=dtype, dev=dev)
    w = (0.1 * torch.randn(V, D, generator=gen, device=dev)).to(dtype)
    logits = x.float() @ w.float().t()
    kk = min(k, V)
    before = head_topk_sample.launches
    for temp in (1.0, 0.7):
        ids, probs = head_topk_sample(x, w, 5, k, temp)
        rids, rprobs = head_topk_sample_ref(x, w, k, temp, seed=5)
        assert (ids != rids).sum().item() <= 1  # a near-tie may flip
        same = ids == rids
        torch.testing.assert_close(probs[same], rprobs[same], rtol=1e-4, atol=1e-7)
        # inside the top-k set, but for a near-tie at its edge
        kth = torch.topk(logits, kk, dim=-1).values[:, -1]
        assert (logits.gather(1, ids.long()[:, None])[:, 0] >= kth - 1e-4).all()
    assert head_topk_sample.launches == before + 2
    ids0, probs0 = head_topk_sample(x, w, 5, k, 0.0)
    assert (ids0.long() == logits.argmax(-1)).float().mean().item() >= 0.99
    assert (probs0 > 0.5).float().mean().item() >= 0.99


def test_head_topk_sample_frequencies(dev):
    """One row repeated: the draws follow the top-k-filtered softmax and
    never leave the top-k (chi-square, 7 dof, upper 1e-4 quantile)."""
    gen = torch.Generator(dev).manual_seed(1)
    D, V, k, R = 32, 64, 8, 1 << 15
    x1 = torch.randn(1, D, generator=gen, device=dev)
    w = 0.3 * torch.randn(V, D, generator=gen, device=dev)
    ids, _ = head_topk_sample(x1.expand(R, D).contiguous(), w, 9, k, 1.0)
    vals, cols = torch.topk((x1 @ w.t())[0], k)
    counts = torch.bincount(ids.long(), minlength=V).double()
    assert counts.sum() == counts[cols].sum()
    expect = torch.softmax(vals.double(), 0) * R
    chi2 = ((counts[cols] - expect) ** 2 / expect).sum().item()
    assert chi2 < 29.878


def test_head_topk_sample_refuses_large_k(dev):
    x = torch.zeros(4, 8, device=dev)
    w = torch.zeros(1000, 8, device=dev)
    with pytest.raises(ValueError, match="top-k"):
        head_topk_sample(x, w, 0, 257)


def _masked_case(gen, dev, dtype, B=3, H=2, NQ=70, NK=200, Dh=64):
    q, k, v, g = (_randn(gen, B, H, n, Dh, dtype=dtype, dev=dev) for n in (NQ, NK, NK, NQ))
    mask = torch.rand(B, NK, generator=gen, device=dev) < 0.5
    mask[1] = False  # a fully masked batch row
    mask[2, 64:128] = False  # a whole key tile without a live key
    return q, k, v, g, mask


def _assert_all_close(got, want, tol):
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_smallq_backward_matches_plain(dev, dtype, p_drop):
    gen = torch.Generator(dev).manual_seed(1)
    q, k, v, g, mask = _masked_case(gen, dev, dtype)
    out, lse = smallq_attention(q, k, v, mask, p_drop=p_drop, seed=9)
    ref_out, _ = smallq_attention_ref(q, k, v, mask, p_drop=p_drop, seed=9)
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])
    before = smallq_backward.launches
    got = smallq_backward(q, k, v, mask, out, lse, g, p_drop=p_drop, seed=9)
    assert smallq_backward.launches == before + 1
    want = smallq_backward_ref(q, k, v, mask, out, lse, g, p_drop=p_drop, seed=9)
    _assert_all_close(got, want, GRAD_TOL[dtype])
    assert all(bool(torch.all(t[1] == 0)) for t in got)  # the masked row
    dead = ~mask
    assert all(bool(torch.all(t.transpose(1, 2)[dead] == 0)) for t in got[1:])
    again = smallq_backward(q, k, v, mask, out, lse, g, p_drop=p_drop, seed=9)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bit-equal


# fp32 K/V of 512 keys exceed shared memory (test_unsupported_backward_shapes_raise)
@pytest.mark.parametrize(
    "dtype,NK",
    [(torch.float32, 8), (torch.float32, 256), (torch.bfloat16, 8),
     (torch.bfloat16, 200), (torch.bfloat16, 512)],
)
@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_largeq_backward_matches_plain(dev, dtype, NK, p_drop):
    gen = torch.Generator(dev).manual_seed(NK)
    B, H, NQ, Dh = 2, 2, 100, 64
    q, g = (_randn(gen, B, H, NQ, Dh, dtype=dtype, dev=dev) for _ in range(2))
    k, v = (_randn(gen, B, H, NK, Dh, dtype=dtype, dev=dev) for _ in range(2))
    out = largeq_attention(q, k, v, p_drop=p_drop, seed=4)
    torch.testing.assert_close(
        out.float(), largeq_attention_ref(q, k, v, p_drop=p_drop, seed=4).float(), **TOL[dtype])
    before = largeq_backward.launches
    got = largeq_backward(q, k, v, g, p_drop=p_drop, seed=4)
    assert largeq_backward.launches == before + 1
    _assert_all_close(got, largeq_backward_ref(q, k, v, g, p_drop=p_drop, seed=4), GRAD_TOL[dtype])
    again = largeq_backward(q, k, v, g, p_drop=p_drop, seed=4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_unsupported_backward_shapes_raise(dev):
    q = torch.zeros(1, 1, 4, 64, device=dev)
    k = torch.zeros(1, 1, 512, 64, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        largeq_backward(q, k, k, q)
    with pytest.raises(ValueError, match="does not match q"):
        largeq_backward(q, k[:, :, :8], k[:, :, :8], q[:, :, :2])
    with pytest.raises(ValueError, match="dropout rate"):
        largeq_attention(q, k[:, :, :8], k[:, :, :8], p_drop=1.0)


@pytest.mark.parametrize("masked", [True, False])
def test_dropout_seed_and_rate_zero(dev, masked):
    gen = torch.Generator(dev).manual_seed(2)
    q, k, v, g, mask = _masked_case(gen, dev, torch.float32)
    km = mask if masked else None
    base = fused_attention(q, k, v, km)
    assert torch.equal(fused_dropout_attention(q, k, v, km, 0.0, 5), base)
    before = dropout_branch.launches
    a = fused_dropout_attention(q, k, v, km, 0.3, 5)
    assert dropout_branch.launches == before + 1
    assert torch.equal(a, fused_dropout_attention(q, k, v, km, 0.3, 5))
    assert not torch.equal(a, fused_dropout_attention(q, k, v, km, 0.3, 6))
    assert not torch.equal(a, base)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_autograd_runs_the_backward_kernels(dev, masked, rate):
    gen = torch.Generator(dev).manual_seed(3)
    q, k, v, g, mask = _masked_case(gen, dev, torch.float32)
    km = mask if masked else None
    fwd, bwd = ((smallq_attention, smallq_backward) if masked
                else (largeq_attention, largeq_backward))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_f, n_b, n_d = fwd.launches, bwd.launches, dropout_branch.launches
    out = fused_dropout_attention(*leaves, km, rate, 11)
    out.backward(g)
    assert (fwd.launches, bwd.launches) == (n_f + 1, n_b + 1)
    assert dropout_branch.launches == n_d + (2 if rate > 0 else 0)
    if masked:
        o, lse = smallq_attention_ref(q, k, v, mask, p_drop=rate, seed=11)
        want = smallq_backward_ref(q, k, v, mask, o, lse, g, p_drop=rate, seed=11)
    else:
        want = largeq_backward_ref(q, k, v, g, p_drop=rate, seed=11)
    _assert_all_close([t.grad for t in leaves], want, GRAD_TOL[torch.float32])
    # inference: nothing recorded, one forward launch
    n_f, n_b = fwd.launches, bwd.launches
    with torch.no_grad():
        fused_attention(q, k, v, km)
    assert (fwd.launches, bwd.launches) == (n_f + 1, n_b)
