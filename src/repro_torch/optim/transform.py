"""Composable gradient transformations over trees of tensors (the port of
``repro/optim/transform.py``, a mini-optax).

A tree is a nested ``dict`` of tensors, walked in sorted-key order (the
order in which JAX flattens a dict). A ``GradientTransformation`` has the
reference's pair and one more entry:

    tx = chain(scale_by_adam(), add_decayed_weights(0.1), scale(-lr))
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)

``begin(state)`` advances the step counters once and returns ``(leaf,
state)``, where ``leaf(u, p, path)`` transforms the update ``u`` of the
parameter ``p`` at ``path`` (a tuple of keys). A training step that holds
tens of GB of state calls ``begin`` once and then ``leaf`` one tensor at a
time, so that no second copy of every gradient and moment exists at once
(``training/steps.py``). ``update`` is built from ``begin`` for every
transformation that works per leaf; ``clip_by_global_norm`` needs the whole
tree and has no ``begin``.

Moments are float32 whatever the parameter's type, and ``update`` and
``leaf`` write them IN PLACE (the JAX version returns new ones): the state
returned holds the same moment tensors and a new count. The op order is the
reference's, each Python constant rounded to float32 where it meets a
float32 tensor.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (updates, state, params=None) -> (updates, state)
    begin: Optional[Callable[[Any], tuple]] = None  # state -> (leaf, state)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_items(tree, prefix=()):
    """``(path, leaf)`` of every leaf, keys in sorted order."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from tree_items(tree[k], prefix + (k,))


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_from_items(items) -> Any:
    """The nested dict of ``(path, leaf)`` pairs (the leaf itself for the
    empty path)."""
    out: dict = {}
    for path, x in items:
        if not path:
            return x
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Transformations
# ---------------------------------------------------------------------------

def per_leaf(init, begin) -> GradientTransformation:
    """The transformation whose ``update`` maps ``begin``'s leaf function
    over the tree."""
    def update(updates, state, params=None):
        leaf, state = begin(state)
        return tree_from_items(
            (path, leaf(u, None if params is None else tree_get(params, path),
                        path))
            for path, u in tree_items(updates)), state

    return GradientTransformation(init, update, begin)


def _stateless(leaf) -> GradientTransformation:
    return per_leaf(lambda params: (), lambda state: (leaf, state))


def scale(factor: float) -> GradientTransformation:
    return _stateless(lambda u, p, path: u * factor)


def _zero_count(params) -> torch.Tensor:
    _, leaf = next(tree_items(params))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor   # int32 0-d


def scale_by_schedule(schedule: Callable) -> GradientTransformation:
    """Multiply by ``schedule(count)`` (a float32 0-d tensor), then count
    one step."""
    def init(params):
        return ScaleByScheduleState(_zero_count(params))

    def begin(state):
        factor = schedule(state.count)
        return (lambda u, p, path: u * factor,
                ScaleByScheduleState(state.count + 1))

    return per_leaf(init, begin)


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # int32 0-d
    mu: Any               # float32 tree shaped like the params
    nu: Any


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """Adam's moment rescaling: ``mu = b1 mu + (1 - b1) u``,
    ``nu = b2 nu + (1 - b2) u^2`` (in place, float32), then
    ``(mu / c1) / (sqrt(nu / c2) + eps)`` with ``c = 1 - b ** count``."""
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return ScaleByAdamState(_zero_count(params), tree_map(zeros, params),
                                tree_map(zeros, params))

    def begin(state):
        count = state.count + 1
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def leaf(u, p, path):
            u = u.float()
            mu, nu = tree_get(state.mu, path), tree_get(state.nu, path)
            mu.mul_(b1).add_(u * (1 - b1))
            nu.mul_(b2).add_(torch.square(u).mul_(1 - b2))
            return (mu / c1).div_(torch.sqrt(nu / c2).add_(eps))

        return leaf, ScaleByAdamState(count, state.mu, state.nu)

    return per_leaf(init, begin)


def add_decayed_weights(weight_decay: float,
                        mask: Callable | None = None
                        ) -> GradientTransformation:
    """AdamW's decoupled decay, ``u + weight_decay * p`` (p cast to the
    update's type). The reference's ``mask`` is not ported: no
    configuration of the port uses one."""
    if mask is not None:
        raise NotImplementedError("masked weight decay is not ported: "
                                  "ROADMAP A11")

    def leaf(u, p, path):
        if p is None:
            raise ValueError("add_decayed_weights requires params")
        return u + weight_decay * p.to(u.dtype)

    return _stateless(leaf)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Apply each transformation in turn. Per leaf (``begin``) when every
    member works per leaf."""
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    def begin(state):
        leaves, new_state = [], []
        for t, s in zip(transforms, state):
            leaf, s = t.begin(s)
            leaves.append(leaf)
            new_state.append(s)

        def leaf(u, p, path):
            for fn in leaves:
                u = fn(u, p, path)
            return u

        return leaf, tuple(new_state)

    per = all(t.begin is not None for t in transforms)
    return GradientTransformation(init, update, begin if per else None)


# ---------------------------------------------------------------------------
# Norms, clipping, application
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """``sqrt`` of the sum of the leaves' sums of squares, the leaves in
    sorted-key order (or in the order of a list of leaves), rounded to
    float32.

    The reference sums float32 squares, which overflow once the norm passes
    ~1.8e19. Under the reference's initializer the gradients of
    phi4-mini-3.8b grow about 4.6x per layer (a norm of 3.6e7 at 8 layers),
    past that at 32 layers, where the float32 norm is inf and the clip
    zeroes every update. The port sums in float64 instead; below the
    overflow the two agree to float32 rounding."""
    leaves = tree if isinstance(tree, list) else \
        [x for _, x in tree_items(tree)]
    total = None
    for x in leaves:
        sq = torch.square(torch.linalg.vector_norm(x, dtype=torch.float64))
        total = sq if total is None else total + sq
    return torch.zeros(()) if total is None else \
        torch.sqrt(total).to(torch.float32)


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-9))`` in float32. The division is by a
    tensor: PyTorch computes ``float / tensor`` as a product with the
    tensor's reciprocal, which rounds twice."""
    num = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(torch.div(num, norm + 1e-9), max=1.0)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by ``clip_factor(global_norm(updates))``, the
    updates upcast to float32 first (the reference's float32 factor
    promotes them). Needs the whole tree: it has no per-leaf ``begin``."""
    def update(updates, state, params=None):
        factor = clip_factor(global_norm(updates), max_norm)
        return tree_map(lambda u: u.float() * factor, updates), state

    return GradientTransformation(lambda params: (), update)


def apply_update(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``p + u`` IN PLACE with the reference's rounding: the update is cast
    to p's type first, then added in p's type."""
    with torch.no_grad():
        return p.copy_(p + u.to(p.dtype))


def apply_updates(params, updates):
    """``params + updates`` as new tensors, each update cast to its
    parameter's type first, as the reference does."""
    return tree_from_items(
        (path, p + tree_get(updates, path).to(p.dtype))
        for path, p in tree_items(params))
