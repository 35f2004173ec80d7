"""Token sampling and confidence-based mask promotion
(mebt_tpu/ops/sampling.py:26-296).

Conventions kept from the JAX package: logits are scaled by
1/(T + 1e-8); Gumbel-max sampling is argmax(l/T - log q) with
q ~ Exp(1), which equals argmax(softmax(l/T) / q); ranks are a stable
descending sort, so the lowest index wins a tie. Every function takes an
optional explicit `noise=` (shared with the JAX side in the tests) and
otherwise draws from the given `torch.Generator`, or from a `RowDraws`,
which makes a whole batch's draws and keeps some rows of them.
"""

from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


class RowDraws:
    """Draws of a batch of `total` rows from `generator`, of which the
    caller keeps `rows`: a data rank of a mesh makes the single-rank
    decode's draws and takes its own rows of them. A draw's first
    dimension is the batch; with all the rows (rows None: whatever batch
    is drawn) they are the generator's own draws."""

    def __init__(self, generator: torch.Generator, rows: slice | None = None,
                 total: int | None = None):
        self.generator, self.rows, self.total = generator, rows, total
        self._keep = slice(None) if rows is None else rows

    def _whole(self, shape):
        if self.rows is None:
            return tuple(shape)
        if shape[0] != self.rows.stop - self.rows.start:
            raise ValueError(f"a draw of {shape[0]} rows for rows {self.rows}")
        return (self.total, *shape[1:])

    def exponential(self, shape, device):
        t = torch.empty(self._whole(shape), device=device)
        return t.exponential_(generator=self.generator)[self._keep]

    def uniform(self, shape, device):
        return torch.rand(self._whole(shape), device=device, generator=self.generator)[self._keep]

    def normal(self, shape, device):
        return torch.randn(self._whole(shape), device=device, generator=self.generator)[self._keep]


def _exponential(shape, device, generator):
    if isinstance(generator, RowDraws):
        return generator.exponential(shape, device)
    return torch.empty(shape, device=device).exponential_(generator=generator)


def top_k_logits(logits: torch.Tensor, k: int, approx: bool = False) -> torch.Tensor:
    """Keep the k largest logits per row, set the rest to float32 min.

    `approx` is the JAX package's `approx_max_k(recall_target=0.99)`
    filter, a TPU speed choice: XLA lowers it to an exact top-k on every
    other backend, so the port keeps the exact threshold under it."""
    del approx  # exact top-k, what approx_max_k computes off the TPU
    kth = torch.topk(logits, int(k), dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def top_p_probs(probs: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: drop tokens once the cumulative sorted
    probability has reached p (the first crossing token is kept), then
    renormalize. A token is removed iff its prob is below the smallest
    kept sorted prob."""
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1)
    remove = cum >= p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    min_kept = torch.where(
        remove, torch.full_like(sorted_probs, float("inf")), sorted_probs
    ).amin(dim=-1, keepdim=True)
    out = torch.where(probs < min_kept, torch.zeros_like(probs), probs)
    return out / out.sum(dim=-1, keepdim=True)


def sample_tokens(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    need_probs: bool = False,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    approx_top_k: bool = False,
):
    """Sample token ids; returns (samples int32, chosen_prob, probs|None).

    `noise` ((..., V) Exp(1) draws) replaces the generator and takes the
    probability-materializing path, as in the JAX package.
    `approx_top_k` takes the exact top-k filter (`top_k_logits`)."""
    if noise is not None:
        scaled = logits.float() / (temperature + 1e-8)
        if top_k is not None:
            scaled = top_k_logits(scaled, int(top_k))
        probs = torch.softmax(scaled, dim=-1)
        if top_p is not None:
            probs = top_p_probs(probs, float(top_p))
        perturbed = torch.where(probs > 0, probs / noise, torch.zeros_like(probs))
        samples = torch.argmax(perturbed, dim=-1)
        chosen = probs.gather(-1, samples[..., None])[..., 0]
        return samples.to(torch.int32), chosen, probs

    logits = logits.float() / (temperature + 1e-8)
    if top_k is not None:
        logits = top_k_logits(logits, int(top_k), approx=approx_top_k)
    if top_p is None and not need_probs:
        q = _exponential(logits.shape, logits.device, generator)
        samples = torch.argmax(logits - torch.log(q), dim=-1)
        lse = torch.logsumexp(logits, dim=-1)
        chosen = torch.exp(logits.gather(-1, samples[..., None])[..., 0] - lse)
        return samples.to(torch.int32), chosen, None

    probs = torch.softmax(logits, dim=-1)
    if top_p is not None:
        probs = top_p_probs(probs, float(top_p))
    q = _exponential(probs.shape, probs.device, generator)
    perturbed = torch.where(probs > 0, probs / q, torch.zeros_like(probs))
    samples = torch.argmax(perturbed, dim=-1)
    chosen = probs.gather(-1, samples[..., None])[..., 0]
    return samples.to(torch.int32), chosen, probs


def sample_from_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """Sample token ids from the filtered softmax by the Exp(1) division
    (reference transformer.py:843-889, mebt_tpu/ops/sampling.py:193-222):
    argmax(probs / q) over the positive probabilities. `noise` ((..., V)
    Exp(1) draws) replaces the generator. Returns (samples int32, probs),
    probs the (..., V) fp32 probabilities after top-k / top-p."""
    logits = logits.float() / (temperature + 1e-8)
    if top_k is not None:
        logits = top_k_logits(logits, int(top_k))
    probs = torch.softmax(logits, dim=-1)
    if top_p is not None:
        probs = top_p_probs(probs, float(top_p))
    q = _exponential(probs.shape, probs.device, generator) if noise is None else noise
    perturbed = torch.where(probs > 0, probs / q, torch.zeros_like(probs))
    return torch.argmax(perturbed, dim=-1).to(torch.int32), probs


def sample_topk_tokens(
    logits: torch.Tensor,
    k: int,
    temperature: float,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
):
    """Sample from the top-k-filtered softmax without perturbing the
    whole vocabulary: take the k largest values, Gumbel-max among them
    (`noise` (rows, k) Exp(1) draws, else drawn from `generator`), and
    recover the id as the lowest index whose logit equals the chosen
    value. The search runs in the input dtype; temperature and the
    softmax over the k values run in fp32. Returns (samples int32,
    chosen_prob), each of logits.shape[:-1]."""
    *lead, V = logits.shape
    flat = logits.reshape(-1, V)
    vals = torch.topk(flat, min(int(k), V), dim=-1).values  # sorted descending
    valsf = vals.float() / (temperature + 1e-8)
    if noise is None:
        noise = _exponential(valsf.shape, valsf.device, generator)
    j = torch.argmax(valsf - torch.log(noise), dim=-1, keepdim=True)
    chosen = vals.gather(-1, j)
    samples = torch.argmax((flat == chosen).to(torch.uint8), dim=-1)
    lse = torch.logsumexp(valsf, dim=-1)
    chosen_prob = torch.exp(valsf.gather(-1, j)[:, 0] - lse)
    return samples.to(torch.int32).reshape(lead), chosen_prob.reshape(lead)


def exact_rank_desc(values: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of element i in a stable descending sort of
    `values` along the last axis (0 = largest, ties by index)."""
    order = torch.argsort(-values, dim=-1, stable=True)
    pos = torch.arange(values.shape[-1], device=values.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def promote_targets(
    scores: torch.Tensor,
    tgt_mask: torch.Tensor,
    n_new: int,
    context_temperature: float,
    random_scores: bool = False,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Promote the n_new most confident targets to contexts: normalize
    scores over targets, perturb by Exp(1)**ctemp, take the top n_new
    (reference mask_sampler.py:189-237). `random_scores` replaces the
    scores by N(0,1) draws with ctemp 0 (strategy random/bootstrap);
    `noise` is then that draw. Returns (B, N) bool."""
    B, N = scores.shape
    if random_scores:
        if noise is not None:
            scores, noise = noise, None
        else:
            scores = (
                generator.normal((B, N), scores.device) if isinstance(generator, RowDraws)
                else torch.randn((B, N), device=scores.device, generator=generator)
            )
        context_temperature = 0.0
    tgtf = tgt_mask.float()
    denom = (scores * tgtf).sum(dim=-1, keepdim=True)
    prob = scores / torch.where(denom == 0, torch.ones_like(denom), denom)
    if noise is None:
        noise = _exponential((B, N), scores.device, generator)
    perturbed = prob / noise ** context_temperature
    perturbed = torch.where(
        tgt_mask, perturbed, torch.full_like(perturbed, float("-inf"))
    )
    rank = exact_rank_desc(perturbed)
    return (rank < n_new) & tgt_mask
