"""Step builders (``repro/training/steps.py``): the training step (gradient
accumulation over microbatches, remat, the global-norm clip, the optimizer)
and the serving steps (prefill / decode)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import optim
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import decode_step as model_decode_step
from repro_torch.models.transformer import forward, make_cache
from repro_torch.models.transformer import prefill as model_prefill
from repro_torch.optim.transform import apply_update, tree_items
from repro_torch.training.losses import cross_entropy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training-step parameters, as in the JAX package.

    ``attn_impl``: ``"auto"`` (flash attention where the shapes allow it:
    the kernels on the card) or ``"ref"`` (the plain attention); the JAX
    package's ``"chunked"`` is not ported and raises. ``scan_unroll`` and
    ``gather_weights_once`` tune the JAX layer scan and its FSDP all-gather;
    a Python layer loop on one device has neither, so they are accepted
    and have no effect."""
    microbatches: int = 1          # gradient-accumulation splits
    remat: str = "none"            # none | full ("dots" is not ported)
    attn_impl: str = "auto"        # auto | ref
    scan_unroll: int = 1           # no effect in the port
    gather_weights_once: bool = False  # no effect in the port
    aux_weight: float = 0.01       # MoE load-balance loss weight
    z_loss: float = 0.0
    clip_norm: float = 1.0


def _leaves(params) -> list:
    return [p for _, p in tree_items(params)]


def make_grad_fn(cfg: ArchConfig, tc: TrainConfig = TrainConfig()
                 ) -> Callable:
    """``grad_fn(params, batch) -> (loss, aux, grads)``: the value and
    gradient of ``loss + aux_weight * aux`` (``grads`` a list in sorted-key
    order of the params' leaves). With ``microbatches`` m > 1 the batch is
    split in m along its first axis and the gradients are summed in float32
    and divided by m, as are loss and aux."""
    def loss_fn(params, tokens, labels, positions, input_embeds):
        logits, aux = forward(cfg, params, tokens, positions=positions,
                              input_embeds=input_embeds,
                              attn_impl=tc.attn_impl, remat=tc.remat)
        loss = cross_entropy(logits, labels, z_loss=tc.z_loss)
        return loss + tc.aux_weight * aux, loss, aux

    def value_and_grad(params, leaves, *inputs):
        with torch.enable_grad():
            total, loss, aux = loss_fn(params, *inputs)
            grads = torch.autograd.grad(total, leaves)
        return loss.detach(), aux.detach(), list(grads)

    def grad_fn(params, batch):
        inputs = (batch["tokens"], batch["labels"], batch.get("positions"),
                  batch.get("input_embeds"))
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            m = tc.microbatches
            if m <= 1:
                return value_and_grad(params, leaves, *inputs)
            B = inputs[0].shape[0]
            if B % m:
                raise ValueError(f"batch {B} does not split into {m} "
                                 f"microbatches")
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            loss = aux = torch.zeros((), dtype=torch.float32,
                                     device=leaves[0].device)
            for i in range(m):
                part = [None if x is None else x[i * (B // m):
                                                 (i + 1) * (B // m)]
                        for x in inputs]
                l, a, grads = value_and_grad(params, leaves, *part)
                for g_acc, g in zip(acc, grads):
                    g_acc.add_(g.float())
                del grads
                loss, aux = loss + l, aux + a
            for g_acc in acc:
                g_acc.div_(m)
            return loss / m, aux / m, acc
        finally:
            for p in leaves:
                p.requires_grad_(False)

    return grad_fn


def make_train_step(cfg: ArchConfig, tx: optim.GradientTransformation,
                    tc: TrainConfig = TrainConfig()) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. ``batch``: ``{"tokens", "labels"[, "positions",
    "input_embeds"]}`` tensors on the params' device; metrics ``loss``,
    ``aux_loss``, ``grad_norm`` as float32 0-d tensors.

    The parameters and the optimizer's moments are updated IN PLACE, tensor
    by tensor, under ``torch.no_grad()`` (the JAX step is pure and returns
    new ones; two copies of phi4-mini's 46 GB training state would not fit
    one card), and the same objects are returned. The op order is the
    reference's: the global norm of the gradients; each gradient upcast to
    float32 and times the clip factor; ``tx``'s transformations; the update
    cast to the parameter's type and added."""
    if tx.begin is None:
        raise ValueError("make_train_step needs a transformation that works "
                         "per leaf (one without clip_by_global_norm: the "
                         "step clips by TrainConfig.clip_norm itself)")
    grad_fn = make_grad_fn(cfg, tc)

    def train_step(params, opt_state, batch):
        loss, aux, grads = grad_fn(params, batch)
        grad_norm = optim.global_norm(grads)
        factor = optim.clip_factor(grad_norm, tc.clip_norm) \
            if tc.clip_norm else None
        leaf, opt_state = tx.begin(opt_state)
        with torch.no_grad():
            for i, (path, p) in enumerate(tree_items(params)):
                g, grads[i] = grads[i], None
                u = g.float() * factor if factor is not None else g
                del g
                apply_update(p, leaf(u, p, path))
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": grad_norm}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, batch: int, max_seq: int,
                      attn_impl: str = "auto") -> Callable:
    """prefill_step(params, tokens) -> (logits, cache). The cache is built
    inside (zeros, on the tokens' device): k and v, or the hybrid family's
    SSM state, conv tails and shared-attention k and v."""
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
