"""Conditioning-stage stubs (mebt_tpu/models/encoders.py).

Reference: mebt/modules/encoders.py (SOSProvider:28, Labelator:14,
Identity:44) and transformer.py:204-214. The published models are
unconditional: the cond stage adds no vocabulary and a constant start
token. Class conditioning is declared upstream but not implemented: it
raises there, and here.
"""

from __future__ import annotations

import torch


class SOSProvider:
    """Constant start-of-sequence token provider; vocab contribution 0."""

    vocab_size = 0

    def __init__(self, sos_token: int = 0, quantize_interface: bool = True):
        self.sos_token = sos_token

    def encode(self, c, include_embeddings: bool = False):
        """(b, 1) int32 start tokens, b the batch of `c`, on `c`'s
        device when it is a tensor."""
        b = c.shape[0] if hasattr(c, "shape") else len(c)
        device = c.device if isinstance(c, torch.Tensor) else None
        tokens = torch.full((b, 1), self.sos_token, dtype=torch.int32, device=device)
        if include_embeddings:
            return None, tokens
        return tokens


class Labelator:
    """Class-label pass-through tokenizer (declared but never trained
    upstream; kept for the API)."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.vocab_size = n_classes

    def encode(self, labels, include_embeddings: bool = False):
        tokens = torch.as_tensor(labels).to(torch.int32).reshape(-1, 1)
        if include_embeddings:
            return None, tokens
        return tokens


class Identity:
    def encode(self, x, include_embeddings: bool = False):
        if include_embeddings:
            return None, x
        return x


def build_cond_stage(config) -> SOSProvider:
    """Reference init_cond_stage_from_ckpt (transformer.py:204-214)."""
    if config.get("unconditional", True):
        return SOSProvider(config.get("sos_token", 0))
    raise ValueError(
        "conditional models are not implemented (the reference raises "
        "identically, transformer.py:214)"
    )
