"""Cross-session experience sharing for fleet tuning (DIAL, PAPERS.md).

The fleet's grid runs many sessions per workload x objective *cell* (one
per seed). Independent sessions rediscover the same correlated response
surface N times over; sharing amortizes exploration across the cell, which
is the paper's real cost metric: steps (tuning time) to the gain.

Three composable, default-off modes, configured by ``SharingConfig``:

* ``shared_replay``: the cell keeps ONE merged FIFO replay window instead of
  k independent ones (``BatchedReplayBuffer(groups=...)``); every member
  samples its minibatches from it, so each learner sees k x the transitions
  per env step and the replay bytes per session drop k x.
* ``avg_every``: every that many fleet steps, the actor, critic and target
  parameters are averaged over the cell inside the per-step body
  (``avg_opt_state`` extends this to the Adam moments). ``None`` (or
  ``math.inf``) disables averaging.
* ``observation_scopes``: DIAL-style local-metric observation: sessions see
  only metrics whose scope is in this tuple (e.g. ``("OSC",)`` for a
  client-side tuner); the objective and reward still read the full state,
  only the *learner's* observation is masked.

``normalize_sharing`` canonicalizes a fully-off config to ``None``, so that
"sharing off" runs exactly the path of code that never heard of sharing.

Sharing composes with ``core.resilience``: in a resilient cell the mask that
gates merged-FIFO writes and the cell mean narrows to ``active & ~corrupted
& ~degraded``, so one member's NaN never reaches the cell's window or its
averaged parameters, while the degraded member keeps running as a frozen
incumbent.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple


class SharingConfig(NamedTuple):
    """Hashable; checkpoints store it."""

    shared_replay: bool = False
    avg_every: Optional[int] = None
    avg_opt_state: bool = False
    observation_scopes: Optional[Tuple[str, ...]] = None

    @property
    def averaging(self) -> bool:
        return self.avg_every is not None

    @property
    def any_on(self) -> bool:
        return (self.shared_replay or self.averaging
                or self.observation_scopes is not None)

    @property
    def cells(self) -> bool:
        """Whether a mode runs on cells of sessions (merged replay or the
        cell mean), as opposed to observation scopes alone."""
        return self.shared_replay or self.averaging


def normalize_sharing(sharing) -> Optional[SharingConfig]:
    """Canonical ``SharingConfig`` or ``None`` when every mode is off.

    ``avg_every=math.inf`` means "never average" and canonicalizes to
    ``None`` averaging; ``observation_scopes`` becomes a sorted tuple so two
    spellings of the same scope set compare equal."""
    if sharing is None:
        return None
    if not isinstance(sharing, SharingConfig):
        raise TypeError(f"expected SharingConfig or None, got {sharing!r}")
    avg = sharing.avg_every
    if avg is not None and (avg == math.inf or avg <= 0):
        avg = None
    elif avg is not None:
        avg = int(avg)
    scopes = sharing.observation_scopes
    if scopes is not None:
        scopes = tuple(sorted(str(s) for s in scopes))
    out = SharingConfig(shared_replay=bool(sharing.shared_replay),
                        avg_every=avg,
                        avg_opt_state=bool(sharing.avg_opt_state and
                                           avg is not None),
                        observation_scopes=scopes)
    return out if out.any_on else None


def resolve_obs_mask(sharing, metric_specs, state_metrics):
    """``sharing.observation_scopes`` resolved against an env's metric
    specs: a 0/1 float tuple over the k state metrics (None when the mode
    is off)."""
    sharing = normalize_sharing(sharing)
    if sharing is None or sharing.observation_scopes is None:
        return None
    from repro_torch.envs.metrics import scope_mask
    return tuple(float(v) for v in scope_mask(
        metric_specs, state_metrics, sharing.observation_scopes))
