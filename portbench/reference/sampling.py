"""What a decode derives from its seed, worked out again for the
generation check (frozen at the commit that added the benchmark), and
how a sampled token and a promotion are judged against the reference's
logits. It imports nothing of the program.

The random protocol of `bidirect_generate` (sampler/generation.py,
sampler/decode.py, ops/head_sample.py, csrc/philox.cuh):

- a batch's seed seeds a host generator; each decode pass (the
  bootstrap where there is one, then the MaskGIT window) takes the next
  `randint(2**62)` of it as its own seed;
- a pass's seed seeds a host generator, whose first `randint(2**62)`
  seeds the pass's device generator, and whose next `randint(2**32)`
  are the head kernels' seeds, one a live MaskGIT step;
- the device generator draws, in order: the bootstrap's one uniform
  (B, N), whose stable descending rank is its promotion order, and then
  a step's Exp(1) noise (B, M, V) of its sampled slots; a MaskGIT step's
  Exp(1) promotion noise (B, M), M the step's target bucket;
- the head kernels' Exp(1) noise at (row, column), row = b * M + slot,
  is word column & 3 of Philox4x32-10 at counter (column >> 2, row, 2,
  0) under key (head seed, 0), u from its top 23 bits (u in [2^-25, 1)),
  q = -log(u); a token is argmax(l / T - log q) over the vocabulary, or
  over the k largest scaled logits with top-k;
- a MaskGIT step ranks each target by (p / sum p) / E^ctemp, p the
  sampled token's probability (under the top-k softmax with top-k), E
  its promotion noise, and promotes the plan's count.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.draws import philox4

NOISE_TAG = 2
ROW_BLOCK = 2048  # rows of Philox noise made at a time


class PassRandom:
    """One decode pass's random streams, from its seed."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.host = torch.Generator().manual_seed(int(seed))
        self.dev = torch.Generator(self.device).manual_seed(self._int(2**62))

    def _int(self, high: int) -> int:
        return int(torch.randint(high, (1,), generator=self.host))

    def head_seed(self) -> int:
        return self._int(2**32)

    def exponential(self, shape) -> torch.Tensor:
        return torch.empty(shape, device=self.device).exponential_(generator=self.dev)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, device=self.device, generator=self.dev)


def pass_seeds(batch_seed: int, n: int) -> list[int]:
    g = torch.Generator().manual_seed(int(batch_seed))
    return [int(torch.randint(2**62, (1,), generator=g)) for _ in range(n)]


def rank_desc(values: torch.Tensor) -> torch.Tensor:
    """Each element's place in a stable descending sort (0 = largest,
    ties by index)."""
    order = torch.argsort(-values, dim=-1, stable=True)
    pos = torch.arange(values.shape[-1], device=values.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def head_noise(seed: int, rows: torch.Tensor, V: int) -> torch.Tensor:
    """(len(rows), V) Exp(1) draws of the head kernels' noise at the
    given rows and every vocabulary column."""
    dev = rows.device
    groups = torch.arange(-(-V // 4), device=dev, dtype=torch.int64)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out = []
    for r0 in range(0, rows.shape[0], ROW_BLOCK):
        r = rows[r0:r0 + ROW_BLOCK].to(torch.int64)[:, None]
        words = torch.stack(philox4(groups, r, zero + NOISE_TAG, zero, int(seed)))
        bits = words.permute(1, 2, 0).reshape(r.shape[0], -1)[:, :V]
        u = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0) \
            + 2.9802322e-8
        out.append(-torch.log(u))
    return torch.cat(out) if out else torch.empty(0, V, device=dev)


def pick(logits: torch.Tensor, q: torch.Tensor, k: int | None) -> torch.Tensor:
    """The token the protocol samples from scaled logits and noise."""
    pert = logits - torch.log(q)
    if k is None or k >= logits.shape[1]:
        return pert.argmax(dim=-1)
    cols = logits.topk(k, dim=-1).indices
    return cols.gather(1, pert.gather(1, cols).argmax(dim=-1, keepdim=True))[:, 0]


def log_prob(logits: torch.Tensor, tok: torch.Tensor, k: int | None) -> torch.Tensor:
    """log p of each row's token under the softmax (over the k largest
    logits with top-k; a token outside them keeps its own logit)."""
    top = logits if k is None or k >= logits.shape[1] else logits.topk(k, dim=-1).values
    return logits.gather(1, tok[:, None])[:, 0] - torch.logsumexp(top, dim=-1)


def sample_gap(logits: torch.Tensor, q: torch.Tensor, tok: torch.Tensor,
               k: int | None, iters: int = 30) -> torch.Tensor:
    """(R,) the least 2e such that logits moved by at most e each make
    `tok` what the protocol samples under the noise q: without top-k the
    gap of the token's perturbed logit below the best; with top-k the
    token has to enter the k largest and beat every other member there.
    0 where the reference samples the token itself."""
    pert = logits - torch.log(q)
    pt = pert.gather(1, tok[:, None])[:, 0]
    if k is None or k >= logits.shape[1]:
        return (pert.amax(dim=-1) - pt).clamp(min=0)
    lt = logits.gather(1, tok[:, None])[:, 0]
    vals, cols = logits.topk(k, dim=-1)
    inside = (cols == tok[:, None]).any(dim=-1)
    # the k largest, or the k - 1 largest and the token: a first bound
    members = torch.where(inside[:, None], cols, torch.cat([cols[:, :-1], tok[:, None]], 1))
    gap = (pert.gather(1, members).amax(dim=-1) - pt).clamp(min=0)
    gap = torch.maximum(gap, torch.where(inside, torch.zeros_like(lt), vals[:, -1] - lt))
    loose = torch.nonzero(gap > 0).flatten()
    if loose.numel():
        gap[loose] = _search(logits[loose], pert[loose], tok[loose], k, gap[loose], iters)
    return gap


def _search(logits, pert, tok, k, hi, iters):
    """Bisection of `sample_gap` on rows whose first bound is positive:
    at gap d the members can be any k columns, the token among them,
    whose perturbed logits lie at most d above the token's, and whose
    least logit lies at most d below the largest logit outside them;
    the best such set is the token with the k - 1 largest logits of
    the eligible columns."""
    R = logits.shape[0]
    rows = torch.arange(R, device=logits.device)
    pt = pert[rows, tok]
    lt = logits[rows, tok]
    lo = torch.zeros_like(hi)
    ninf = torch.tensor(float("-inf"), device=logits.device)
    for _ in range(iters):
        d = (lo + hi) / 2
        elig = pert <= (pt + d)[:, None]
        elig[rows, tok] = False
        la = torch.where(elig, logits, ninf)
        la[rows, tok] = float("-inf")
        v = la.topk(k, dim=-1).values
        rest = torch.where(elig, ninf, logits)
        rest[rows, tok] = float("-inf")
        out_max = torch.maximum(rest.amax(dim=-1), v[:, k - 1])
        if k > 1:
            memb_min = torch.minimum(lt, v[:, k - 2])
            ok = torch.isfinite(v[:, k - 2]) & (out_max - memb_min <= d)
        else:
            ok = out_max - lt <= d
        hi = torch.where(ok, d, hi)
        lo = torch.where(ok, lo, d)
    return hi


def promote_scores(logp: torch.Tensor, noise: torch.Tensor, ctemp: float) -> torch.Tensor:
    """The log of a MaskGIT step's promotion ranks over its targets."""
    p = torch.exp(logp.double())
    return (logp.double() - torch.log(p.sum()) - ctemp * torch.log(noise.double())).float()


def promote_gap(scores: torch.Tensor, chosen: torch.Tensor, n: int) -> float:
    """How far the chosen targets stray across the reference's line
    between its n highest scores and the rest, in log units: the
    largest shortfall of a chosen target below the n-th score, or excess
    of another above the (n + 1)-th. 0 where the sets agree."""
    srt = torch.sort(scores, descending=True).values
    gap = 0.0
    if n >= 1 and bool(chosen.any()):
        gap = max(gap, float((srt[n - 1] - scores[chosen]).max()))
    if n < scores.numel() and bool((~chosen).any()):
        gap = max(gap, float((scores[~chosen] - srt[n]).max()))
    return max(gap, 0.0)


def ctemp_of(c: float, scale: float) -> float:
    """A step's context temperature, the float32 product."""
    return float(np.float32(c) * np.float32(scale))
