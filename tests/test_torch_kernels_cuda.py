"""K1-K9 against their plain versions on a CUDA card, at small
shapes with ragged edges, in fp32 (tolerance 1e-5: fp32 sums in another
order) and bf16 (both sides round one fp32 result to bf16, so an element
may differ by one bf16 ulp, at most 2^-7 of its value: the tolerance is
two such ulps of each element plus 1e-5). The backward kernels K6/K7 and
the dropout branches K8 use the same two tolerances, with rtol 1e-5
added in fp32 for gradients that are sums of a thousand terms. K9's
codes follow the near-tie rule of ops/vq.py:code_mismatches, and on
integer data (exact fp32 sums) equal the plain version's, lowest index
first among ties. Skipped where there is no card.
On the GPU machine, which has no JAX (the repo's conftest imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from mebt_tpu_torch.ops.attention_cuda import (
    dkdv_splits,
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
    smallq_splits,
)
from mebt_tpu_torch.ops.head_sample import (
    head_sample,
    head_sample_ref,
    head_topk_sample,
    head_topk_sample_ref,
    head_topk_sample_v1,
)

from mebt_tpu_torch.ops.philox import philox_keep
from mebt_tpu_torch.ops.vq import (
    code_mismatches,
    codebook_slices,
    nearest_code,
    nearest_code_ref,
    tf32_split,
    tf32_split_ref,
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


# (dtype, B, NQ, NK, scale of q). fp32 K/V of 512 keys exceed shared
# memory (test_unsupported_shapes_raise). The bf16 cases after the first
# five exercise the tensor-core K2 and K7: query counts around their
# 16-row blocks, one (b, h) of the 128f decode, 16 keys, and scores eight
# times larger, whose row maxima move from one key chunk to the next.
LARGEQ_CASES = [
    (torch.float32, 2, 100, 8, 1.0), (torch.float32, 2, 100, 256, 1.0),
    (torch.bfloat16, 2, 100, 8, 1.0), (torch.bfloat16, 2, 100, 256, 1.0),
    (torch.bfloat16, 2, 100, 512, 1.0),
    (torch.bfloat16, 2, 1, 256, 1.0), (torch.bfloat16, 2, 8, 256, 1.0),
    (torch.bfloat16, 2, 63, 256, 1.0), (torch.bfloat16, 2, 65, 256, 1.0),
    (torch.bfloat16, 1, 8192, 256, 1.0), (torch.bfloat16, 2, 100, 16, 1.0),
    (torch.bfloat16, 2, 100, 256, 8.0), (torch.bfloat16, 2, 1000, 200, 8.0),
]


def _largeq_case(dev, dtype, B, NQ, NK, q_scale, H=2, Dh=64):
    gen = torch.Generator(dev).manual_seed(NK + NQ)
    q, g = ((q_scale * torch.randn(B, H, NQ, Dh, generator=gen, device=dev)).to(dtype),
            _randn(gen, B, H, NQ, Dh, dtype=dtype, dev=dev))
    k, v = (_randn(gen, B, H, NK, Dh, dtype=dtype, dev=dev) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("dtype,B,NQ,NK,q_scale", LARGEQ_CASES)
@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_largeq_matches_plain(dev, dtype, B, NQ, NK, q_scale, p_drop):
    q, k, v, _ = _largeq_case(dev, dtype, B, NQ, NK, q_scale)
    before = largeq_attention.launches
    out = largeq_attention(q, k, v, p_drop=p_drop, seed=4)
    assert largeq_attention.launches == before + 1
    torch.testing.assert_close(
        out.float(), largeq_attention_ref(q, k, v, p_drop=p_drop, seed=4).float(), **TOL[dtype]
    )
    assert torch.equal(out, largeq_attention(q, k, v, p_drop=p_drop, seed=4))


# The bf16 K2's wgmma tile at its edges: queries around the 64-row tile
# (8, 64, 65, 1000, 8192; 130 with NQ % 4 == 2, where the keep stream's
# groups of four rows straddle heads), keys in one 128-key block (64), two
# (200, a ragged one, and 256), three (320) and four (512, the most), with
# and without dropout; two calls give the same bits.
K2_TILE_EDGES = [
    (2, 8, 64), (2, 64, 200), (2, 65, 256), (1, 1000, 320), (1, 8192, 512),
    (3, 1000, 256), (2, 64, 512), (2, 130, 256),
]


@pytest.mark.parametrize("B,NQ,NK", K2_TILE_EDGES)
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_largeq_wgmma_tile_edges_match_plain(dev, B, NQ, NK, p_drop):
    q, k, v, _ = _largeq_case(dev, torch.bfloat16, B, NQ, NK, 1.0)
    out = largeq_attention(q, k, v, p_drop=p_drop, seed=8)
    ref = largeq_attention_ref(q, k, v, p_drop=p_drop, seed=8)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    assert torch.equal(out, largeq_attention(q, k, v, p_drop=p_drop, seed=8))


@pytest.mark.parametrize("NQ,NK", [(65, 256), (1000, 320)])
def test_largeq_wgmma_forward_then_backward_kernels_at_rate_0_1(dev, NQ, NK):
    """K2's forward and K7's backward under autograd at rate 0.1: the
    backward draws the forward's mask again, so the gradients match the
    plain version's only if the new forward dropped the same elements."""
    q, k, v, g = _largeq_case(dev, torch.bfloat16, 2, NQ, NK, 1.0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n_f, n_b = largeq_attention.launches, largeq_backward.launches
    out = fused_dropout_attention(*leaves, None, 0.1, 21)
    out.backward(g)
    assert (largeq_attention.launches, largeq_backward.launches) == (n_f + 1, n_b + 1)
    torch.testing.assert_close(out.float(), largeq_attention_ref(
        q, k, v, p_drop=0.1, seed=21).float(), **TOL[torch.bfloat16])
    want = largeq_backward_ref(q, k, v, g, p_drop=0.1, seed=21)
    _assert_all_close([t.grad for t in leaves], want, GRAD_TOL[torch.bfloat16])


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


def _head_case(gen, dev, R, V, D=1024, ties=False):
    """bf16 x (R, D), w (V, D). ties: entries in {-1, 0, 1} / 4 (exact fp32
    sums on both sides) and 40 distinct W rows, so equal logits fall in
    many vocabulary slices."""
    if ties:
        x = (torch.randint(-1, 2, (R, D), generator=gen, device=dev) / 4).to(torch.bfloat16)
        base = (torch.randint(-1, 2, (40, D), generator=gen, device=dev) / 4).to(torch.bfloat16)
        return x, base[torch.randint(0, 40, (V,), generator=gen, device=dev)]
    x = torch.randn(R, D, generator=gen, device=dev).to(torch.bfloat16)
    return x, (0.02 * torch.randn(V, D, generator=gen, device=dev)).to(torch.bfloat16)


def _greedy_gap(logits, ids):
    """The largest logit gap at a row whose greedy id is not the argmax."""
    top = logits.argmax(-1)
    miss = ids.long() != top
    if not miss.any():
        return 0.0
    gap = logits.gather(1, top[:, None])[:, 0] - logits.gather(1, ids.long()[:, None])[:, 0]
    return gap[miss].max().item()


@pytest.mark.parametrize("R", [256, 4096, 8192])  # the most slices; 16f last segment; D&R
def test_head_sample_slices_match_plain(dev, R):
    """The bf16 K3 split over the vocabulary and merged, at the decode's
    small-R shapes: chip_smoke.py's gates (ids but at near-ties, chosen
    prob 1e-3, greedy misses only at gaps <= 1e-4)."""
    gen = torch.Generator(dev).manual_seed(R)
    x, w = _head_case(gen, dev, R, 16384)
    logits = x.float() @ w.float().t()
    ids, probs = head_sample(x, w, 5, 1.0)
    rids, _ = head_sample_ref(x, w, 1.0, seed=5)
    assert (ids != rids).sum().item() <= max(2, R // 10000)
    p = torch.softmax(logits, -1).gather(1, ids.long()[:, None])[:, 0]
    torch.testing.assert_close(probs, p, rtol=1e-3, atol=0.0)
    assert _greedy_gap(logits, head_sample(x, w, 5, 0.0)[0]) <= 1e-4


# The bf16 K3's wgmma tile (two 64-row product warpgroups and a noise
# warpgroup a CTA) at its edges: rows around the CTA's 128 (1, 127, 129,
# 1000), a vocabulary narrower
# than a chunk (24) and no multiple of it (16100; 16101, whose last noise
# group is partial), the head width no multiple of the 64-deep stage
# (96); ids but at near-ties, the chosen probability under the logits'
# softmax, one launch a call, two calls bit-equal.
@pytest.mark.parametrize("R", [1, 127, 129, 1000])
@pytest.mark.parametrize("V,D", [(24, 1024), (16100, 1024), (1000, 96), (16101, 1024)])
def test_head_sample_wgmma_tile_edges_match_plain(dev, R, V, D):
    gen = torch.Generator(dev).manual_seed(R * 3 + V + D)
    x, w = _head_case(gen, dev, R, V, D=D)
    logits = x.float() @ w.float().t()
    for temp in (1.0, 0.0):
        before = head_sample.launches
        ids, probs = head_sample(x, w, 5, temp)
        assert head_sample.launches == before + 1
        rids, _ = head_sample_ref(x, w, temp, seed=5)
        assert bool(((ids >= 0) & (ids < V)).all())
        assert (ids != rids).sum().item() <= 1  # a near-tie may flip
        if temp == 1.0:
            p = torch.softmax(logits, -1).gather(1, ids.long()[:, None])[:, 0]
            torch.testing.assert_close(probs, p, rtol=1e-3, atol=0.0)
        else:
            assert _greedy_gap(logits, ids) <= 1e-4
        again = head_sample(x, w, 5, temp)
        assert torch.equal(again[0], ids) and torch.equal(again[1], probs)


@pytest.mark.parametrize("R", [1, 127, 129, 1000])
@pytest.mark.parametrize("V", [24, 16100, 16101])
def test_head_sample_part_at_a_column_offset_off_a_group_matches_plain(dev, R, V):
    """The sharded K3 with one part whose W starts at column 2 of the whole
    head (the straddling instantiation: a thread pair's four columns take
    words of two noise groups): the plain version's ids at that offset but
    at near-ties, the chosen probability, two calls bit-equal."""
    from mebt_tpu_torch.ops.head_sample import _launch_parts

    gen = torch.Generator(dev).manual_seed(R + V)
    x, w = _head_case(gen, dev, R, V)
    logits = x.float() @ w.float().t()
    for temp in (1.0, 0.0):
        ids, probs = _launch_parts(0, x, w, 5, temp, None, 0, col_offset=2)
        rids, _ = head_sample_ref(x, w, temp, seed=5, col_offset=2)
        assert bool(((ids >= 2) & (ids < V + 2)).all())
        assert (ids != rids).sum().item() <= 1  # a near-tie may flip
        local = ids.long() - 2
        if temp == 1.0:
            p = torch.softmax(logits, -1).gather(1, local[:, None])[:, 0]
            torch.testing.assert_close(probs, p, rtol=1e-3, atol=0.0)
        else:
            assert _greedy_gap(logits, local) <= 1e-4
        again = _launch_parts(0, x, w, 5, temp, None, 0, col_offset=2)
        assert torch.equal(again[0], ids) and torch.equal(again[1], probs)


@pytest.mark.parametrize("R,V", [(256, 16384), (300, 1100)])
def test_head_sample_ties_match_plain(dev, R, V):
    """Exact ties across slices: the plain version's ids, bit for bit."""
    gen = torch.Generator(dev).manual_seed(V)
    x, w = _head_case(gen, dev, R, V, ties=True)
    for temp in (1.0, 0.0):
        ids, _ = head_sample(x, w, 3, temp)
        assert torch.equal(ids, head_sample_ref(x, w, temp, seed=3)[0])


@pytest.mark.parametrize("k", [None, 32], ids=["k3", "k4"])
def test_sharded_head_at_a_row_offset_gives_the_whole_batchs_ids(dev, k):
    """The sharded K3 / K4 (slice kernel into a part, the gather, the
    merge kernel) of rows 100.. of a batch, on one rank of a gloo group of
    one and without a mesh: the whole-head kernel's ids and probabilities
    of those rows, bit for bit (one part: the same slices and sums)."""
    import socket

    import torch.distributed as dist

    from mebt_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator(dev).manual_seed(9)
    x, w = _head_case(gen, dev, 1000, 16384)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(data=1, model=1)
        for temp in (1.0, 0.0):
            if k is None:
                whole = head_sample(x, w, 5, temp)
                parts = [head_sample(x[100:], w, 5, temp, mesh=m, row_offset=100)
                         for m in (mesh, None)]
            else:
                whole = head_topk_sample(x, w, 5, k, temp)
                parts = [head_topk_sample(x[100:], w, 5, k, temp, mesh=m, row_offset=100)
                         for m in (mesh, None)]
            for ids, probs in parts:
                assert torch.equal(ids, whole[0][100:])
                assert torch.equal(probs, whole[1][100:])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("R", [256, 3328, 6400])  # the most slices; 128f last two segments
def test_head_topk_sample_slices_match_plain(dev, R):
    gen = torch.Generator(dev).manual_seed(R)
    x, w = _head_case(gen, dev, R, 16384)
    logits = x.float() @ w.float().t()
    top = torch.topk(logits, 32, dim=-1).values
    ids, probs = head_topk_sample(x, w, 5, 32, 1.0)
    rids, _ = head_topk_sample_ref(x, w, 32, 1.0, seed=5)
    assert (ids != rids).sum().item() <= max(2, R // 10000)
    at = logits.gather(1, ids.long()[:, None])[:, 0]
    assert (at >= top[:, -1] - 1e-4).all()
    torch.testing.assert_close(probs, torch.exp(at - torch.logsumexp(top, -1)), rtol=1e-3,
                               atol=0.0)
    assert _greedy_gap(logits, head_topk_sample(x, w, 5, 32, 0.0)[0]) <= 1e-4


@pytest.mark.parametrize("R,V", [(256, 16384), (300, 1100)])
@pytest.mark.parametrize("k", [7, 32, 200])
def test_head_topk_sample_ties_keep_the_lowest_columns(dev, R, V, k):
    """The k-th value is shared by columns in several slices: the merged
    set holds the lowest of them (the plain stable sort's), so the ids are
    the plain version's, bit for bit."""
    gen = torch.Generator(dev).manual_seed(V + k)
    x, w = _head_case(gen, dev, R, V, ties=True)
    for temp in (1.0, 0.0):
        ids, _ = head_topk_sample(x, w, 3, k, temp)
        assert torch.equal(ids, head_topk_sample_ref(x, w, k, temp, seed=3)[0])


# The bf16 K4's wgmma tile at its edges: rows around the 64-row
# warpgroup and 128-row CTA (1, 63, 64, 1000), a vocabulary smaller than k
# (24) and no multiple of the 128-column chunk (16100), k 1, 32 and 256
# (256: one warpgroup a CTA, whose buffers fill shared memory).
@pytest.mark.parametrize("R", [1, 63, 64, 1000])
@pytest.mark.parametrize("V", [24, 16100])
@pytest.mark.parametrize("k", [1, 32, 256])
def test_head_topk_wgmma_tile_edges_match_plain(dev, R, V, k):
    gen = torch.Generator(dev).manual_seed(R * 7 + V + k)
    x, w = _head_case(gen, dev, R, V)
    logits = x.float() @ w.float().t()
    kk = min(k, V)
    kth = torch.topk(logits, kk, dim=-1).values
    for temp in (1.0, 0.0):
        ids, probs = head_topk_sample(x, w, 5, k, temp)
        rids, rprobs = head_topk_sample_ref(x, w, k, temp, seed=5)
        assert bool(((ids >= 0) & (ids < V)).all())
        assert (ids != rids).sum().item() <= 1  # a near-tie may flip
        at = logits.gather(1, ids.long()[:, None])[:, 0]
        assert (at >= kth[:, -1] - 1e-4).all()
        if temp == 1.0:
            torch.testing.assert_close(probs, torch.exp(at - torch.logsumexp(kth, -1)),
                                       rtol=1e-3, atol=0.0)
        again = head_topk_sample(x, w, 5, k, temp)
        assert torch.equal(again[0], ids) and torch.equal(again[1], probs)


def test_head_topk_part_at_a_column_offset_gives_the_whole_heads_ids(dev):
    """The sharded K4 without a group: the two halves of a 16384-row head
    (the second at col_off 8192) as two ranks' parts, gathered in rank
    order and merged, give the whole head's ids and probabilities bit
    for bit (the tile's sums do not depend on a column's place in it)."""
    import ctypes

    from mebt_tpu_torch.ops import _build
    from mebt_tpu_torch.ops.head_sample import _SIGNATURES

    gen = torch.Generator(dev).manual_seed(17)
    R, D, V, k = 1000, 1024, 8192, 32
    x, w = _head_case(gen, dev, R, 2 * V)
    lib = _build.load("head_sample", _SIGNATURES)
    splits, err = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.mebt_head_part_plan(R, V, k, 2, ctypes.byref(splits), ctypes.byref(err))
    _build.check(err.value, "plan")
    part_bytes = -(-n // 256) * 256
    parts = torch.zeros(2 * part_bytes, device=dev, dtype=torch.uint8)
    ids = torch.empty(R, device=dev, dtype=torch.int32)
    probs = torch.empty(R, device=dev, dtype=torch.float32)
    stream, ptr = _build.stream_ptr(x), ctypes.c_void_p
    for temp in (1.0, 0.0):
        inv_temp = 1.0 / (temp + 1e-8)
        for r in range(2):
            w_r = w[r * V:(r + 1) * V]
            _build.check(lib.mebt_head_topk_part(
                ptr(x.data_ptr()), ptr(w_r.data_ptr()), ptr(parts.data_ptr() + r * part_bytes),
                R, D, V, k, inv_temp, r * V, 2, stream), "part")
        _build.check(lib.mebt_head_topk_merge(
            ptr(parts.data_ptr()), part_bytes, 2, ptr(ids.data_ptr()), ptr(probs.data_ptr()),
            R, k, splits.value, 5, 0, stream), "merge")
        whole = head_topk_sample(x, w, 5, k, temp)
        assert torch.equal(ids, whole[0]) and torch.equal(probs, whole[1])


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "R,V,k", [(256, 1024, 32), (300, 1000, 32), (300, 1000, 1), (70, 20, 32), (130, 700, 256)]
)  # small; ragged rows and vocabulary; k = 1; k >= V (k = V); the largest k
def test_head_topk_sample_v1_matches_plain_and_k4(dev, dtype, R, V, k):
    """K5 computes K4's function: at one seed its ids equal K4's (same
    logits tile, same exact top-k, same Philox draws) and the plain
    version's but for a near-tie."""
    gen = torch.Generator(dev).manual_seed(R + V + k)
    D = 96
    x = _randn(gen, R, D, dtype=dtype, dev=dev)
    w = (0.1 * torch.randn(V, D, generator=gen, device=dev)).to(dtype)
    logits = x.float() @ w.float().t()
    kk = min(k, V)
    before = head_topk_sample_v1.launches
    for temp in (1.0, 0.7, 0.0):
        ids, probs = head_topk_sample_v1(x, w, 5, k, temp)
        ids4, probs4 = head_topk_sample(x, w, 5, k, temp)
        rids, rprobs = head_topk_sample_ref(x, w, k, temp, seed=5)
        assert torch.equal(ids, ids4)
        torch.testing.assert_close(probs, probs4, rtol=1e-5, atol=1e-7)
        assert (ids != rids).sum().item() <= 1  # a near-tie may flip
        same = ids == rids
        torch.testing.assert_close(probs[same], rprobs[same], rtol=1e-4, atol=1e-7)
        kth = torch.topk(logits, kk, dim=-1).values[:, -1]
        assert (logits.gather(1, ids.long()[:, None])[:, 0] >= kth - 1e-4).all()
    assert head_topk_sample_v1.launches == before + 3


@pytest.mark.parametrize("R", [256, 3328, 6400])  # the most slices; 128f last two segments
@pytest.mark.parametrize("k", [1, 32, 256])
def test_head_topk_sample_v1_equals_k4_bitwise(dev, R, k):
    """The bf16 K5 runs K4's tile, slices and merge with v1's sorted
    extraction: its ids and probabilities are K4's bit for bit, greedy
    and sampled, and two calls give the same bits."""
    gen = torch.Generator(dev).manual_seed(R + k)
    x, w = _head_case(gen, dev, R, 16384)
    before = head_topk_sample_v1.launches
    for temp in (1.0, 0.0):
        ids, probs = head_topk_sample_v1(x, w, 5, k, temp)
        ids4, probs4 = head_topk_sample(x, w, 5, k, temp)
        assert torch.equal(ids, ids4) and torch.equal(probs, probs4)
    again = head_topk_sample_v1(x, w, 5, k, 0.0)
    assert torch.equal(again[0], ids) and torch.equal(again[1], probs)
    assert head_topk_sample_v1.launches == before + 3


@pytest.mark.parametrize("R,V", [(256, 16384), (300, 1100)])
@pytest.mark.parametrize("k", [7, 32, 200])
def test_head_topk_sample_v1_ties_keep_the_lowest_columns(dev, R, V, k):
    """Exact ties across slices and chunks: the bf16 K5's ids are the
    plain version's (the lowest columns of the k-th value) and K4's."""
    gen = torch.Generator(dev).manual_seed(V + k + 1)
    x, w = _head_case(gen, dev, R, V, ties=True)
    for temp in (1.0, 0.0):
        ids, probs = head_topk_sample_v1(x, w, 3, k, temp)
        assert torch.equal(ids, head_topk_sample_ref(x, w, k, temp, seed=3)[0])
        ids4, probs4 = head_topk_sample(x, w, 3, k, temp)
        assert torch.equal(ids, ids4) and torch.equal(probs, probs4)


def test_head_topk_sample_v1_frequencies_and_large_k(dev):
    """The draws follow the top-k-filtered softmax and never leave the
    top-k (chi-square, 7 dof, upper 1e-4 quantile); k past the shared
    memory buffer is refused."""
    gen = torch.Generator(dev).manual_seed(1)
    D, V, k, R = 32, 64, 8, 1 << 15
    x1 = torch.randn(1, D, generator=gen, device=dev)
    w = 0.3 * torch.randn(V, D, generator=gen, device=dev)
    ids, _ = head_topk_sample_v1(x1.expand(R, D).contiguous(), w, 9, k, 1.0)
    vals, cols = torch.topk((x1 @ w.t())[0], k)
    counts = torch.bincount(ids.long(), minlength=V).double()
    assert counts.sum() == counts[cols].sum()
    expect = torch.softmax(vals.double(), 0) * R
    chi2 = ((counts[cols] - expect) ** 2 / expect).sum().item()
    assert chi2 < 29.878
    with pytest.raises(ValueError, match="top-k"):
        head_topk_sample_v1(torch.zeros(4, 8, device=dev), torch.zeros(1000, 8, device=dev), 0, 257)


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


# fp32 K/V of 512 keys exceed shared memory (test_unsupported_backward_shapes_raise).
# NQ 1000 with scores eight times larger is held to the float64 value in
# test_largeq_backward_scaled_matches_float64 instead.
@pytest.mark.parametrize(
    "dtype,B,NQ,NK,q_scale",
    [(torch.bfloat16, 2, 100, 200, 1.0)]
    + [c for c in LARGEQ_CASES
       if c not in ((torch.bfloat16, 2, 100, 256, 1.0), (torch.bfloat16, 2, 1000, 200, 8.0))],
)
@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_largeq_backward_matches_plain(dev, dtype, B, NQ, NK, q_scale, p_drop):
    q, k, v, g = _largeq_case(dev, dtype, B, NQ, NK, q_scale)
    out = largeq_attention(q, k, v, p_drop=p_drop, seed=4)
    torch.testing.assert_close(
        out.float(), largeq_attention_ref(q, k, v, p_drop=p_drop, seed=4).float(), **TOL[dtype])
    before = largeq_backward.launches
    got = largeq_backward(q, k, v, g, p_drop=p_drop, seed=4)
    assert largeq_backward.launches == before + 1
    _assert_all_close(got, largeq_backward_ref(q, k, v, g, p_drop=p_drop, seed=4), GRAD_TOL[dtype])
    again = largeq_backward(q, k, v, g, p_drop=p_drop, seed=4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_largeq_backward_scaled_matches_float64(dev, p_drop):
    """Scores eight times larger over 1000 queries: some dk elements lie
    near zero as sums of terms some 20 in size, where an fp32 sum in any
    order is a few 1e-6 off: on the H100 the plain version itself lies
    most of the bf16 gate's bound from the float64 value at such an
    element, and the kernel as far on the other side. Both are held to
    the float64 value of the same function, under the same bound."""
    q, k, v, g = _largeq_case(dev, torch.bfloat16, 2, 1000, 200, 8.0)
    got = largeq_backward(q, k, v, g, p_drop=p_drop, seed=4)
    plain = largeq_backward_ref(q, k, v, g, p_drop=p_drop, seed=4)
    q6, k6, v6, g6 = (t.double() for t in (q, k, v, g))
    p = torch.softmax(q6 @ k6.transpose(-1, -2) / 8.0, dim=-1)
    dp = g6 @ v6.transpose(-1, -2)
    if p_drop > 0:
        keep = philox_keep(4, p.shape, p_drop, dev).double() / (1.0 - p_drop)
        p_v, dp = p * keep, dp * keep
    else:
        p_v = p
    ds = p * (dp - (g6 * (p_v @ v6)).sum(-1, keepdim=True)) / 8.0
    exact = (ds @ k6, ds.transpose(-1, -2) @ q6, p_v.transpose(-1, -2) @ g6)
    for t in (got, plain):
        _assert_all_close(t, [e.to(torch.bfloat16) for e in exact], GRAD_TOL[torch.bfloat16])


def test_largeq_backward_split_walk_with_dropout(dev):
    """The 128f latent_dec shape (5 x 16 x 8192 queries over 256 keys),
    where the dk/dv pass splits its query walk and merges the splits:
    against the plain version under the bf16 gate with dropout, and the
    same bits on two calls."""
    q, k, v, g = _largeq_case(dev, torch.bfloat16, 5, 8192, 256, 1.0, H=16)
    assert dkdv_splits(q, k, 0.1) > 1
    got = largeq_backward(q, k, v, g, p_drop=0.1, seed=4)
    _assert_all_close(got, largeq_backward_ref(q, k, v, g, p_drop=0.1, seed=4),
                      GRAD_TOL[torch.bfloat16])
    again = largeq_backward(q, k, v, g, p_drop=0.1, seed=4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# The bf16 K7's wgmma passes at their edges: queries around the 64-query
# tile (1, 63, 65, 1000), keys in one 64-key block (16, 64), ragged (200),
# four (256: the dq pass's 4-block instantiation), five and eight (320,
# 512: its 8-block one), with and without dropout; the dk/dv pass at one
# query split and at several (the 128f shape, test_largeq_backward_split_
# walk_with_dropout). One launch a call, the plain version's gradients
# under the bf16 gate, the same bits on two calls.
K7_TILE_EDGES = [
    (2, 1, 256), (2, 63, 16), (2, 65, 64), (1, 1000, 200), (3, 1000, 256), (2, 65, 320),
    (1, 1000, 512), (2, 130, 256),
]


@pytest.mark.parametrize("B,NQ,NK", K7_TILE_EDGES)
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_largeq_backward_wgmma_tile_edges_match_plain(dev, B, NQ, NK, p_drop):
    q, k, v, g = _largeq_case(dev, torch.bfloat16, B, NQ, NK, 1.0)
    before = largeq_backward.launches
    got = largeq_backward(q, k, v, g, p_drop=p_drop, seed=6)
    assert largeq_backward.launches == before + 1
    _assert_all_close(got, largeq_backward_ref(q, k, v, g, p_drop=p_drop, seed=6),
                      GRAD_TOL[torch.bfloat16])
    again = largeq_backward(q, k, v, g, p_drop=p_drop, seed=6)
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


# The bf16 K1 / K6 walk the live keys of a batch row only and split them
# over CTAs when the (b, h) pairs are too few to fill the card. (B, H,
# NQ, NK, mask, scale of q): the 128f lt2l key count at B 1-2 (splits),
# masks with runs of dead tiles, a batch row without a live key, query
# and key counts around the tiles (70, 130: NQ % 4 == 2), and a mask with
# one live key.
SMALLQ_TC_CASES = [
    (1, 2, 256, 8448, "half", 1.0), (2, 2, 256, 8448, "dead_tiles", 1.0),
    (2, 3, 70, 1000, "empty_row", 1.0), (3, 2, 17, 130, "dead_tiles", 1.0),
    (2, 2, 256, 1280, "one_live", 1.0), (2, 2, 256, 8448, "half", 8.0),
    (2, 2, 130, 300, "half", 1.0),
]


def _smallq_tc_case(dev, B, H, NQ, NK, kind, q_scale, Dh=64):
    gen = torch.Generator(dev).manual_seed(B * 1000 + NK + NQ)
    q = (q_scale * torch.randn(B, H, NQ, Dh, generator=gen, device=dev)).to(torch.bfloat16)
    k, v = (_randn(gen, B, H, NK, Dh, dtype=torch.bfloat16, dev=dev) for _ in range(2))
    g = _randn(gen, B, H, NQ, Dh, dtype=torch.bfloat16, dev=dev)
    mask = torch.rand(B, NK, generator=gen, device=dev) < 0.5
    if kind == "dead_tiles":
        mask[:, 64:320] = False  # four whole 64-key tiles
        mask[-1, NK // 2:] = False
    elif kind == "empty_row":
        mask[0] = False
        mask[1, :512] = False
    elif kind == "one_live":
        mask[:] = False
        mask[:, NK - 1] = True
    return q, k, v, g, mask


@pytest.mark.parametrize("B,H,NQ,NK,kind,q_scale", SMALLQ_TC_CASES)
@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_smallq_tensor_core_matches_plain(dev, B, H, NQ, NK, kind, q_scale, p_drop):
    """bf16 K1 and K6 against their plain versions: out within the bf16
    gate, lse within 1e-5, gradients within the bf16 gate; a row without
    a live key gives out 0, lse 1e30 and zero gradients, a dead key zero
    dk and dv; two calls give the same bits."""
    q, k, v, g, mask = _smallq_tc_case(dev, B, H, NQ, NK, kind, q_scale)
    out, lse = smallq_attention(q, k, v, mask, p_drop=p_drop, seed=21)
    ref, ref_lse = smallq_attention_ref(q, k, v, mask, p_drop=p_drop, seed=21)
    live = mask.any(dim=1)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    got_lse = lse
    if q_scale != 1.0:  # lse about 35: the plain fp32 lse strays up to 1e-5 from float64
        s64 = (q.double() @ k.double().transpose(-1, -2)) / 8.0
        ref_lse = torch.logsumexp(s64.masked_fill(~mask[:, None, None, :], float("-inf")), -1)
        got_lse = lse.double()
    torch.testing.assert_close(got_lse[live], ref_lse[live], atol=1e-5, rtol=0)
    assert torch.all(out[~live] == 0) and torch.all(lse[~live] == 1e30)
    again = smallq_attention(q, k, v, mask, p_drop=p_drop, seed=21)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    got = smallq_backward(q, k, v, mask, out, lse, g, p_drop=p_drop, seed=21)
    if q_scale == 1.0:  # x8: held to float64 below
        want = smallq_backward_ref(q, k, v, mask, out, lse, g, p_drop=p_drop, seed=21)
        _assert_all_close(got, want, GRAD_TOL[torch.bfloat16])
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert all(bool(torch.all(t[~live] == 0)) for t in got)
    assert all(bool(torch.all(t.transpose(1, 2)[~mask] == 0)) for t in got[1:])
    again = smallq_backward(q, k, v, mask, out, lse, g, p_drop=p_drop, seed=21)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bit-equal


@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_smallq_backward_scaled_matches_float64(dev, p_drop):
    """Scores eight times larger over 8448 masked keys, B 2: as for K7,
    kernel and plain version are both held to the float64 value of the
    same function (the softmax over the live keys, D from the kernel's
    out), under the bf16 gate."""
    q, k, v, g, mask = _smallq_tc_case(dev, 2, 2, 256, 8448, "half", 8.0)
    out, lse = smallq_attention(q, k, v, mask, p_drop=p_drop, seed=21)
    got = smallq_backward(q, k, v, mask, out, lse, g, p_drop=p_drop, seed=21)
    plain = smallq_backward_ref(q, k, v, mask, out, lse, g, p_drop=p_drop, seed=21)
    q6, k6, v6, g6 = (t.double() for t in (q, k, v, g))
    s = (q6 @ k6.transpose(-1, -2) / 8.0).masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    dp = g6 @ v6.transpose(-1, -2)
    if p_drop > 0:
        keep = philox_keep(21, p.shape, p_drop, dev).double() / (1.0 - p_drop)
        p_v, dp = p * keep, dp * keep
    else:
        p_v = p
    ds = p * (dp - (g6 * out.double()).sum(-1, keepdim=True)) / 8.0
    exact = (ds @ k6, ds.transpose(-1, -2) @ q6, p_v.transpose(-1, -2) @ g6)
    for t in (got, plain):
        _assert_all_close(t, [e.to(torch.bfloat16) for e in exact], GRAD_TOL[torch.bfloat16])


def _live_mask(dev, gen, NK, counts):
    """A (len(counts), NK) mask whose row b has counts[b] live keys at
    random places."""
    mask = torch.zeros(len(counts), NK, dtype=torch.bool, device=dev)
    for b, n in enumerate(counts):
        mask[b, torch.randperm(NK, generator=gen, device=dev)[:n]] = True
    return mask


def _check_smallq_wgmma(q, k, v, g, mask, p_drop=0.0, seed=0, **rows):
    """bf16 K1 and K6 against their plain versions at the dropout rows'
    offsets `rows`: out and gradients within the bf16 gate, lse within
    1e-5; a row without a live key gives out 0, lse 1e30 and zero
    gradients, a dead key zero dk and dv; one launch a call, and two calls
    give the same bits."""
    kw = dict(p_drop=p_drop, seed=seed, **rows)
    n_f, n_b = smallq_attention.launches, smallq_backward.launches
    out, lse = smallq_attention(q, k, v, mask, **kw)
    got = smallq_backward(q, k, v, mask, out, lse, g, **kw)
    assert (smallq_attention.launches, smallq_backward.launches) == (n_f + 1, n_b + 1)
    ref, ref_lse = smallq_attention_ref(q, k, v, mask, **kw)
    want = smallq_backward_ref(q, k, v, mask, out, lse, g, **kw)
    live = mask.any(dim=1)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-5, rtol=0)
    _assert_all_close(got, want, GRAD_TOL[torch.bfloat16])
    assert torch.all(out[~live] == 0) and torch.all(lse[~live] == 1e30)
    assert all(bool(torch.all(t[~live] == 0)) for t in got)
    assert all(bool(torch.all(t.transpose(1, 2)[~mask] == 0)) for t in got[1:])
    again = smallq_attention(q, k, v, mask, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert all(torch.equal(a, b) for a, b in zip(
        got, smallq_backward(q, k, v, mask, out, lse, g, **kw)))
    return out, lse, got


# live keys a batch row around the 64-key stage of the Hopper K1 / K6
# (none, one, a stage less one, a stage, a stage and one), at key counts
# that are and are not stage multiples
@pytest.mark.parametrize("n_live", [0, 1, 63, 64, 65])
@pytest.mark.parametrize("NK", [128, 200, 1000])
@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_smallq_wgmma_live_counts_match_plain(dev, n_live, NK, p_drop):
    gen = torch.Generator(dev).manual_seed(NK + n_live)
    q, k, v, g = (_randn(gen, 3, 2, n, 64, dtype=torch.bfloat16, dev=dev)
                  for n in (70, NK, NK, 70))
    # the count under test, that count plus two stages, and a masked row
    mask = _live_mask(dev, gen, NK, [n_live, min(NK, n_live + 128), 0])
    _check_smallq_wgmma(q, k, v, g, mask, p_drop, seed=4)


# (B, H, NQ, NK) at which the plans of K1 and of K6's dq pass on an
# NVIDIA H100 (132 SMs) take every split count 1-8, with and without
# dropout (tests/test_torch_attention_split_masked.py live_splits)
SPLIT_SHAPES = ((1, 1, 64, 64), (1, 1, 64, 320), (1, 1, 64, 384), (1, 1, 64, 448),
                (1, 1, 64, 512), (2, 6, 256, 384), (2, 6, 256, 448), (3, 15, 64, 512),
                (2, 12, 256, 512), (2, 16, 256, 512), (2, 43, 64, 512), (4, 25, 64, 512))


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_smallq_wgmma_every_split_count_matches_plain(dev, splits, backward, p_drop):
    """K1 (or K6's dq pass) at every split count its plan can pick (1-8),
    at a shape where the plan picks it: the splits' partials merged in
    split order, the scratch sized for that count."""
    def planned(B, H, NQ, NK):
        q = torch.empty(B, H, NQ, 64, dtype=torch.bfloat16, device=dev)
        return smallq_splits(q, q.new_empty(B, H, NK, 64), backward, p_drop)

    B, H, NQ, NK = next((s for s in SPLIT_SHAPES if planned(*s) == splits), (0, 0, 0, 0))
    assert B, f"no shape of SPLIT_SHAPES gets {splits} splits on {torch.cuda.get_device_name()}"
    gen = torch.Generator(dev).manual_seed(splits)
    q, k, v, g = (_randn(gen, B, H, n, 64, dtype=torch.bfloat16, dev=dev)
                  for n in (NQ, NK, NK, NQ))
    # a row live but for one key, and (with more rows) a random half and
    # a row without a live key
    mask = _live_mask(dev, gen, NK, [NK - 1, NK // 2, 0][:B] + [NK // 2] * (B - 3))
    _check_smallq_wgmma(q, k, v, g, mask, p_drop, seed=6)


def test_smallq_wgmma_plans_by_query_rows(dev):
    """The plans count the query rows that a merge of the splits reads, so
    two shapes of the same CTAs and keys but other query counts take their
    own split counts, asked in either order (on an H100: 5 at 64 queries a
    (b, h), 1 at 256), and each runs with scratch sized for its own."""
    gen = torch.Generator(dev).manual_seed(11)
    shapes = {NQ: [_randn(gen, 1, 13, n, 64, dtype=torch.bfloat16, dev=dev)
                   for n in (NQ, 320, 320, NQ)] for NQ in (64, 256)}
    for order in ((64, 256), (256, 64)):
        assert [smallq_splits(shapes[n][0], shapes[n][1]) for n in order] == [
            {64: 5, 256: 1}[n] for n in order]
    mask = _live_mask(dev, gen, 320, [319])
    for NQ in (256, 64):
        _check_smallq_wgmma(*shapes[NQ], mask)


def test_smallq_wgmma_dropout_at_row_and_head_offsets(dev):
    """K8 in the Hopper K1 / K6 keyed on the whole model's rows: batch rows
    from b0 3 and heads from h0 2 of 6, against the plain versions at the
    same offsets; zero offsets give the default rows' bits."""
    gen = torch.Generator(dev).manual_seed(8)
    q, k, v, g = (_randn(gen, 2, 3, n, 64, dtype=torch.bfloat16, dev=dev)
                  for n in (256, 1000, 1000, 256))
    mask = _live_mask(dev, gen, 1000, [500, 1000])
    at = dict(b0=3, h0=2, heads=6)
    out, _, grads = _check_smallq_wgmma(q, k, v, g, mask, 0.1, seed=7, **at)
    local = smallq_attention(q, k, v, mask, p_drop=0.1, seed=7)[0]
    same = smallq_attention(q, k, v, mask, p_drop=0.1, seed=7, b0=0, h0=0, heads=3)[0]
    assert torch.equal(local, same) and not torch.equal(local, out)


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


# (M, K, D): tile edges in every dimension, a width no multiple of the
# 32-deep stage (40, 200), the widest width (one 64-row warpgroup a CTA),
# closure16's (512 rows over 64 codes of width 16: one 16-deep stage), a
# ragged codebook under 1000 rows
@pytest.mark.parametrize("M,K,D", [(100, 1000, 256), (64, 64, 40), (7, 130, 512), (512, 64, 16),
                                   (300, 700, 200), (1000, 16000, 256)])
def test_nearest_code_matches_plain(dev, M, K, D):
    gen = torch.Generator(dev).manual_seed(M)
    x = torch.randn(M, D, generator=gen, device=dev)
    e = torch.randn(K, D, generator=gen, device=dev)
    before = nearest_code.launches
    got = nearest_code(x, e)
    assert nearest_code.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (M,)
    want = nearest_code_ref(x, e)
    n, gap, over = code_mismatches(x, e, got, want)
    assert over <= 1.0, (n, gap, over)


@pytest.mark.parametrize("splits", [0, 1, 2, 3, 7])
def test_nearest_code_ties_pick_the_lowest_index(dev, splits):
    gen = torch.Generator(dev).manual_seed(9)
    x = torch.randint(-1, 2, (300, 64), generator=gen, device=dev).float()
    half = torch.randint(-1, 2, (200, 64), generator=gen, device=dev).float()
    e = torch.cat([half, half])
    got = nearest_code(x, e, splits=splits)
    assert torch.equal(got, nearest_code_ref(x, e))
    assert int(got.max()) < 200


# (M, K): the 16f encoder's shape, and a ragged codebook under few row tiles
@pytest.mark.parametrize("M,K", [(6144, 16384), (1000, 16000)])
def test_nearest_code_slices_give_the_same_codes(dev, M, K):
    """S codebook slices merged in order give the codes of one slice, bit
    for bit, and two calls the same codes."""
    gen = torch.Generator(dev).manual_seed(K)
    x = torch.randn(M, 256, generator=gen, device=dev)
    e = torch.randn(K, 256, generator=gen, device=dev)
    assert codebook_slices(M, K, 256) > 1 and codebook_slices(M, K, 256, 1) == 1
    got = nearest_code(x, e)
    assert torch.equal(got, nearest_code(x, e))
    assert torch.equal(got, nearest_code(x, e, splits=1))
    assert torch.equal(got, nearest_code(x, e, splits=7))
    n, gap, over = code_mismatches(x, e, got, nearest_code_ref(x, e))
    assert over <= 1.0, (n, gap, over)


@pytest.mark.parametrize("shape", [(16384, 256), (64, 16), (7, 13)])
def test_tf32_split_matches_plain_bitwise(dev, shape):
    """The search's split pass (hi = tf32(v), lo = tf32(v - hi)) on values
    of every magnitude, a tail under four values included, bit for bit."""
    gen = torch.Generator(dev).manual_seed(shape[1])
    v = torch.randn(shape, generator=gen, device=dev)
    v = v * torch.exp2(torch.randint(-60, 60, shape, generator=gen, device=dev).float())
    v.view(-1)[:3] = torch.tensor([0.0, -0.0, 1.0 + 2.0**-11], device=dev)
    before = tf32_split.launches
    hi, lo = tf32_split(v)
    assert tf32_split.launches == before + 1
    want_hi, want_lo = tf32_split_ref(v.cpu())
    assert torch.equal(hi.cpu().view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.cpu().view(torch.int32), want_lo.view(torch.int32))


def test_nearest_code_refuses_what_it_cannot_take(dev):
    with pytest.raises(ValueError, match="not taken"):
        nearest_code(torch.zeros(4, 513, device=dev), torch.zeros(8, 513, device=dev))
    with pytest.raises(ValueError, match="do not chain"):
        nearest_code(torch.zeros(4, 8, device=dev), torch.zeros(8, 16, device=dev))


def test_start_profile_records_the_first_kernels(dev):
    """A trace from train/trainer.py:start_profile holds every kernel of
    the work it traces, the first ones included, in each of a process's
    traces: a plain torch.profiler trace loses the kernels that run in
    its first milliseconds, a window that grows with the process's age."""
    from mebt_tpu_torch.train.trainer import spin_kernels, start_profile

    x = torch.zeros(1 << 20, device=dev)
    for _ in range(3):
        torch.cuda.synchronize()
        prof = start_profile(dev)
        for _ in range(40):
            x.mul_(0.5)  # one kernel each
        torch.cuda.synchronize()
        prof.stop()
        calls = sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and "MulFunctor" in e.key)
        assert calls == 40
        assert spin_kernels(prof) > 0  # the lost window ended inside the spins



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [True, False])
def test_dropout_rows_at_offsets_match_the_plain_version(dev, dtype, masked):
    """K8 keyed on the whole model's rows: K1/K6 (masked) or K2/K7 with
    batch rows from b0 = 3 and heads from h0 = 2 of 6 against the plain
    versions at the same offsets, and the counter at b0 = h0 = 0, heads = H
    equal to the default's bit for bit."""
    gen = torch.Generator(dev).manual_seed(8)
    B, H, NQ, NK = 2, 2, 70, 200
    q, k, v, g = (_randn(gen, B, H, n, 64, dtype=dtype, dev=dev) for n in (NQ, NK, NK, NQ))
    rows = dict(b0=3, h0=2, heads=6)
    if masked:
        mask = torch.rand(B, NK, device=dev, generator=gen) > 0.3
        out, lse = smallq_attention(q, k, v, mask, p_drop=0.1, seed=5, **rows)
        ref, _ = smallq_attention_ref(q, k, v, mask, p_drop=0.1, seed=5, **rows)
        grads = smallq_backward(q, k, v, mask, out, lse, g, p_drop=0.1, seed=5, **rows)
        want = smallq_backward_ref(q, k, v, mask, out, lse, g, p_drop=0.1, seed=5, **rows)
        base = smallq_attention(q, k, v, mask, p_drop=0.1, seed=5)[0]
        same = smallq_attention(q, k, v, mask, p_drop=0.1, seed=5, b0=0, h0=0, heads=H)[0]
    else:
        out = largeq_attention(q, k, v, p_drop=0.1, seed=5, **rows)
        ref = largeq_attention_ref(q, k, v, p_drop=0.1, seed=5, **rows)
        grads = largeq_backward(q, k, v, g, p_drop=0.1, seed=5, **rows)
        want = largeq_backward_ref(q, k, v, g, p_drop=0.1, seed=5, **rows)
        base = largeq_attention(q, k, v, p_drop=0.1, seed=5)
        same = largeq_attention(q, k, v, p_drop=0.1, seed=5, b0=0, h0=0, heads=H)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    _assert_all_close(grads, want, GRAD_TOL[dtype])
    assert torch.equal(base, same) and not torch.equal(base, out)


# (masked, B, H, NQ, NK, offsets): K8's mask at NQ % 4 == 0 (the four
# lanes of a group of rows share each Philox call), NQ % 4 != 0 (each lane
# draws its own) and the tiles' edges, at a rank's rows and heads too
K8_MASK_CASES = [
    (False, 2, 2, 1024, 256, {}), (False, 2, 2, 130, 200, {}), (False, 1, 3, 65, 320, {}),
    (False, 2, 2, 256, 256, dict(b0=3, h0=1, heads=4)),
    (True, 2, 2, 256, 1280, {}), (True, 2, 3, 70, 1000, {}), (True, 2, 2, 130, 300, {}),
    (True, 2, 2, 256, 640, dict(b0=1, h0=2, heads=5)),
]


@pytest.mark.parametrize("masked,B,H,NQ,NK,rows", K8_MASK_CASES)
def test_dropout_masks_through_the_outputs_equal_philox_keep(dev, masked, B, H, NQ, NK, rows):
    """The bf16 K1 / K2 forward's and K6 / K7 dq pass's keep masks,
    recovered through their outputs (v, then g, as basis vectors), equal
    ops/philox.py:philox_keep bit for bit wherever the probability passes
    1e-6 (chip_smoke.kernel_masks); two calls give the same bits, and rate
    0 is the kernel without dropout."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    gen = torch.Generator(dev).manual_seed(B * NQ + NK)
    q, k, v, g = (_randn(gen, B, H, n, 64, dtype=torch.bfloat16, dev=dev) for n in (NQ, NK, NK, NQ))
    mask = (torch.rand(B, NK, generator=gen, device=dev) < 0.5) if masked else None
    fwd, bwd, dv_of = chip_smoke.k8_calls(q, k, v, g, mask, 31, **rows)
    want = philox_keep(31, (B, H, NQ, NK), chip_smoke.P_DROP, dev, **rows)
    got = chip_smoke.kernel_masks(fwd, dv_of, q, k, v, g, mask, want, "test")[0]
    assert got["fwd_mask_bit_equal"] and got["bwd_mask_bit_equal"] and got["mask_elements"] > 0
    out, grads = fwd(v), bwd()
    assert torch.equal(out, fwd(v)) and all(torch.equal(a, b) for a, b in zip(grads, bwd()))
    assert torch.equal(fwd(v, rate=0.0), fused_attention(q, k, v, mask))
