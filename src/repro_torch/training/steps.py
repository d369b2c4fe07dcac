"""Serving step factories (``repro/training/steps.py::make_prefill_step`` and
``make_decode_step``). The training step waits for the training slice."""

from __future__ import annotations

from typing import Callable

from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import decode_step as model_decode_step
from repro_torch.models.transformer import make_cache
from repro_torch.models.transformer import prefill as model_prefill


def make_prefill_step(cfg: ArchConfig, batch: int, max_seq: int,
                      attn_impl: str = "auto") -> Callable:
    """prefill_step(params, tokens) -> (logits, cache). The cache is built
    inside (zeros, on the tokens' device)."""
    def prefill_step(params, tokens):
        cache = make_cache(cfg, batch, max_seq, device=tokens.device)
        return model_prefill(cfg, params, tokens, cache, attn_impl=attn_impl)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """decode_step(params, tokens [B,1], cache, cache_index) ->
    (logits, cache); the cache is updated in place."""
    def decode(params, tokens, cache, cache_index):
        return model_decode_step(cfg, params, tokens, cache, cache_index)
    return decode
