"""The Philox streams of the port (mebt_tpu_torch/ops/philox.py, the plain
versions of csrc/philox.cuh), on the CPU: Philox4x32-10's known answers,
the noise stream of K3 / K4 / K5 (word col & 3 of the call at counter
(col >> 2, row, NOISE_TAG, 0)), the keep stream of K8 (word prow & 3 of
the call at counter (key, prow >> 2, KEEP_TAG, 0)), their statistics, and
an emulation of the
wgmma kernels' warp-cooperative draw (csrc/attention.cu:keep_bits_stage:
four lanes share each call, a byte transpose by two shuffles) against the
plain mask bit for bit. Inputs from numpy seeds.
"""

import numpy as np
import pytest
import torch

from mebt_tpu_torch.ops.philox import (
    KEEP_TAG,
    NOISE_TAG,
    drop_threshold,
    keep_rows,
    philox4,
    philox_bits,
    philox_keep,
    philox_exponential,
    philox_keep_at,
)

torch.set_num_threads(1)
M32 = 0xFFFFFFFF


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox4_known_answers(counter, key, want):
    """Random123's Philox4x32-10 test vectors."""
    got = philox4(*counter, *key)
    assert tuple(int(w) for w in got) == want


def _philox_int(c, k0, k1=0):
    """Philox4x32-10 on Python integers (an independent statement)."""
    c = list(c)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1, p0 & M32]
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c


def test_noise_stream_is_word_col_and_3_at_col_div_4_row_noise_tag_0():
    """philox_bits (the noise of K3, K4 and K5) is word col & 3 of
    philox4 at counter (col >> 2, row, NOISE_TAG, 0), the integer
    reference's word, for a row's shared columns and a row's own."""
    seed = 0x9E3779B9
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(0, 2**32, (6, 1)))
    cols = torch.from_numpy(rng.integers(0, 2**32, (1, 5)))
    got = philox_bits(seed, rows, cols)
    words = torch.stack(philox4(cols >> 2, rows, NOISE_TAG, 0, seed))
    assert torch.equal(got, words.gather(0, (cols & 3).expand(6, 5)[None])[0])
    own = torch.from_numpy(rng.integers(0, 2**32, (6, 3)))
    got_own = philox_bits(seed, rows, own)
    for i, r in enumerate(rows[:, 0].tolist()):
        for j, c in enumerate(cols[0].tolist()):
            assert int(got[i, j]) == _philox_int([c >> 2, r, NOISE_TAG, 0], seed)[c & 3]
        for j, c in enumerate(own[i].tolist()):
            assert int(got_own[i, j]) == _philox_int([c >> 2, r, NOISE_TAG, 0], seed)[c & 3]


def test_four_columns_share_a_call():
    """Columns 4i .. 4i + 3 of one row take words 0 .. 3 of the call at
    (i, row, NOISE_TAG, 0), wherever the columns start (a rank's block
    of the vocabulary at an offset that is no multiple of 4)."""
    seed = 4321
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(rng.integers(0, 2**32, (3, 1)))
    for first in (0, 2, 4 * int(rng.integers(1, 2**29)) + 3):
        cols = torch.arange(first, first + 12)[None, :]
        got = philox_bits(seed, rows, cols)
        for i, r in enumerate(rows[:, 0].tolist()):
            for j, c in enumerate(cols[0].tolist()):
                assert int(got[i, j]) == _philox_int([c >> 2, r, NOISE_TAG, 0], seed)[c & 3]
    grp = philox_bits(seed, rows, torch.arange(40, 44)[None, :])
    assert torch.equal(grp, torch.stack(philox4(10, rows[:, 0], NOISE_TAG, 0, seed), dim=1))


def test_noise_and_keep_streams_stay_apart():
    """On a 64 x 64 block the noise stream's words are not the keep
    stream's (both key (seed, 0); the tags differ), nor are its keep
    decisions at either rate."""
    seed = 77
    rows, cols = torch.arange(64)[:, None], torch.arange(64)[None, :]
    noise = philox_bits(seed, rows, cols)
    keep_words = torch.stack(philox4(cols, rows >> 2, KEEP_TAG, 0, seed)).gather(
        0, (rows & 3).expand(64, 64)[None])[0]
    assert int((noise == keep_words).sum()) == 0
    for rate in (0.1, 0.5):
        assert not torch.equal(philox_keep_at(seed, rows, cols, rate),
                               noise >= drop_threshold(rate))


def test_noise_word_statistics():
    """philox_exponential's draws of each word m = col & 3 have mean and
    variance within 4 sigma of 1 (Exp(1)), and the draws of columns 4i
    and 4i + 1 (words 0 and 1 of one call) have a correlation within 4
    sigma of 0."""
    q = philox_exponential(13, 256, 1024, "cpu", row_offset=5).double().reshape(256, 256, 4)
    n = q[..., 0].numel()
    for m in range(4):
        w = q[..., m]
        assert abs(w.mean().item() - 1.0) < 4 / n**0.5
        # Var of the sample variance of Exp(1): (mu4 - sigma^4) / n = 8 / n
        assert abs(w.var().item() - 1.0) < 4 * (8 / n) ** 0.5
    a, b = q[..., 0].flatten(), q[..., 1].flatten()
    corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
    assert abs(corr) < 4 / n**0.5


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_a_group_of_rows_shares_one_call(rate):
    """Rows 4i .. 4i + 3 at one key take words 0 .. 3 of the call at
    (key, i, KEEP_TAG, 0); the keep stream is not the noise stream."""
    seed, thresh = 1234, drop_threshold(rate)
    rows = torch.arange(40, 56)[:, None]
    cols = torch.tensor([[0, 1, 63, 255, 8191]])
    got = philox_keep_at(seed, rows, cols, rate)
    for i, r in enumerate(rows[:, 0].tolist()):
        for j, c in enumerate(cols[0].tolist()):
            word = _philox_int([c, r >> 2, KEEP_TAG, 0], seed)[r & 3]
            assert bool(got[i, j]) == (word >= thresh)
    rows, cols = torch.arange(64)[:, None], torch.arange(64)[None, :]
    assert not torch.equal(philox_keep_at(seed, rows, cols, rate),
                           philox_bits(seed, rows, cols) >= thresh)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_fraction_per_word_and_neighbour_agreement(rate):
    """The kept fraction of each word m = prow & 3 is within 4 sigma of
    1 - rate, and rows 4i and 4i + 1 (words 0 and 1 of one call) agree at
    one key within 4 sigma of (1 - rate)^2 + rate^2: the words are
    independent."""
    keep = philox_keep(11, (2, 4, 64, 256), rate, "cpu").reshape(-1, 4, 256)
    n = keep[:, 0].numel()
    for m in range(4):
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(keep[:, m].float().mean().item() - (1 - rate)) < 4 * sigma
    agree = (keep[:, 0] == keep[:, 1]).double().mean().item()
    want = (1 - rate) ** 2 + rate**2
    assert abs(agree - want) < 4 * (want * (1 - want) / n) ** 0.5


# ---------------------------------------------------------------------------
# csrc/attention.cu:keep_bits_stage emulated lane by lane


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint64 arrays of 32-bit words."""
    v = x | (y << np.uint64(32))
    out = np.zeros_like(x)
    for i in range(4):
        src = ((sel >> np.uint64(4 * i)) & np.uint64(7)) * np.uint64(8)
        out |= ((v >> src) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out


def _lane_layout():
    lane = np.arange(32)
    return lane, lane >> 2, lane & 3  # lane, g, tq


def keep_bits_stage(seed, thresh, grouped, prow, key_at):
    """The 32 lanes' words of one warp: prow (32, 2) each lane's two Philox
    rows (g, g + 8), key_at(c) the key at the stage's column c (numpy)."""
    lane, g, tq = _lane_layout()
    if grouped:
        m = g & 3
        x = np.zeros(32, np.uint64)
        for c in range(8):
            col = (2 * m + (c >> 2)) * 8 + 2 * tq + (c & 1)
            grp = prow[:, (c >> 1) & 1] >> 2
            w = philox4(torch.from_numpy(key_at(col)), torch.from_numpy(grp), KEEP_TAG, 0, seed)
            for mp in range(4):
                x |= (w[mp].numpy() >= thresh).astype(np.uint64) << np.uint64(8 * mp + c)
        y = x[lane ^ 8]
        z = _byte_perm(x, y, np.where(m & 2, 0x3276, 0x5410).astype(np.uint64))
        u = z[lane ^ 4]
        return _byte_perm(z, u, np.where(m & 1, 0x3715, 0x6240).astype(np.uint64))
    kb = np.zeros(32, np.uint64)
    for i in range(32):
        col = (i >> 2) * 8 + 2 * tq + (i & 1)
        r = torch.from_numpy(prow[:, (i >> 1) & 1])
        w = philox4(torch.from_numpy(key_at(col)), r >> 2, KEEP_TAG, 0, seed)
        m = r & 3
        word = torch.where(m == 0, w[0], torch.where(m == 1, w[1], torch.where(m == 2, w[2], w[3])))
        kb |= (word.numpy() >= thresh).astype(np.uint64) << np.uint64(i)
    return kb


@pytest.mark.parametrize("NQ,b0,h0,heads,gathered", [
    (256, 0, 0, 16, False), (1024, 6, 8, 16, False), (256, 3, 1, 4, True),
    (8192, 0, 0, 16, True), (65, 0, 0, 2, False), (1000, 1, 1, 3, True), (70, 2, 0, 2, True),
])
def test_warp_cooperative_draw_equals_the_plain_mask(NQ, b0, h0, heads, gathered):
    """Every warp's 16 rows of every 64-query tile of a (b, h): the
    emulated keep_bits_stage (grouped where NQ % 4 == 0, each lane's own
    calls otherwise) gives bit i = element i of philox_keep_at, at mesh
    offsets too; columns are keys k0 + c (K2, K7) or gathered live keys
    out of order (K1, K6)."""
    rng = np.random.default_rng(NQ + b0)
    seed, rate = int(rng.integers(0, 2**32)), 0.1
    thresh = drop_threshold(rate)
    B, H, NK = 2, 2, 3000
    lane, g, tq = _lane_layout()
    rows = keep_rows((B, H, NQ, NK), b0, h0, heads).reshape(B, H, NQ).numpy()
    for b, h in ((0, 0), (B - 1, H - 1)):
        for row0 in sorted({0, 64 * ((NQ - 1) // 64)} | {16 * int(rng.integers(0, NQ // 16 + 1))}):
            local = row0 + g[:, None] + np.array([0, 8])[None, :]  # (32, 2) rows of (b, h)
            # rows past NQ continue into the next (b, h)'s, as the kernels' do
            flat = (b * H + h) * NQ + local
            prow = np.where(flat < B * H * NQ,
                            rows.reshape(-1)[np.minimum(flat, B * H * NQ - 1)], 0).astype(np.int64)
            if gathered:
                keys = np.sort(rng.choice(NK, 64, replace=False))
                rng.shuffle(keys)
                key_at = lambda c: keys[c].astype(np.int64)  # noqa: E731
            else:
                k0 = 64 * int(rng.integers(0, 4))
                key_at = lambda c: (k0 + c).astype(np.int64)  # noqa: E731
            got = keep_bits_stage(seed, thresh, NQ % 4 == 0, prow, key_at)
            for i in range(32):
                col = (i >> 2) * 8 + 2 * tq + (i & 1)
                want = philox_keep_at(seed, torch.from_numpy(prow[:, (i >> 1) & 1])[:, None],
                                      torch.from_numpy(key_at(col))[None, :], rate)
                want = torch.diagonal(want).numpy()
                bit = ((got >> np.uint64(i)) & np.uint64(1)).astype(bool)
                live = local[:, (i >> 1) & 1] < NQ
                np.testing.assert_array_equal(bit[live], want[live])


def test_grouped_rows_are_aligned_on_every_rank():
    """Where NQ % 4 == 0 a group of four rows never straddles a head or a
    batch row at any offsets, so the four lanes of rows 4i .. 4i + 3 of a
    tile draw one group: prow & 3 == local row & 3."""
    for b0, h0, heads in ((0, 0, 16), (6, 8, 16), (1, 3, 5)):
        rows = keep_rows((2, 2, 12, 8), b0, h0, heads).reshape(2, 2, 12)
        assert torch.equal(rows & 3, (torch.arange(12) & 3).expand(2, 2, 12))
        assert torch.equal(rows >> 2, (rows[..., ::4] >> 2).repeat_interleave(4, -1))
