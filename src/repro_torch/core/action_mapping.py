"""Action <-> configuration mapping (paper §II-C-1, "Action Mapping").

The DDPG actor emits actions in [0,1]^m. Each coordinate is inverse-mapped to the
parameter's real range:

  continuous:  lambda_i = a(i) * (max - min) + min
  discrete:    lambda_i = floor(a(i) * (max - min) + min + 0.5)

Beyond the paper's two kinds, realistic DFS parameter spaces (DIAL's client-side
knobs, CARAT's RPC/cache co-tuning) mix several more; all reduce to the paper's
discrete formula over an index space:

  choice / categorical:  index the explicit value list (e.g. power-of-two
                         stripe sizes, service-thread counts)
  boolean:               {False, True} at the 0.5 threshold (e.g. checksums)
  log2_int:              integer powers of two between minimum and maximum,
                         uniform in log2 (e.g. max_rpcs_in_flight 1..256)

Box constraints (paper §II-A, C_i := lambda_j ⊕ B_i) are enforced by
construction (the map's image is the box) and validated for externally supplied
configs. Every kind has a vectorized unit<->value mapping
(``from_unit_batch``/``to_unit_batch``); the scalar maps are the N == 1 case of
the batch maps, so the fleet's vectorized round-trip and the single-session
path agree by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

#: "categorical" is the unordered spelling of "choice" — same index mapping,
#: kept distinct in ``kind`` so spaces document intent (DIAL/CARAT knobs).
_LIST_KINDS = ("choice", "categorical")
KINDS = ("continuous", "discrete", "boolean", "log2_int") + _LIST_KINDS


def _is_pow2(v) -> bool:
    v = int(v)
    return v > 0 and (v & (v - 1)) == 0


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One tunable (static) parameter."""

    name: str
    kind: str  # one of KINDS
    minimum: float = 0.0
    maximum: float = 1.0
    values: tuple = ()  # for list kinds: explicit, ordered value list
    default: Any = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown parameter kind {self.kind!r}")
        if self.kind in _LIST_KINDS:
            if len(self.values) < 1:
                raise ValueError(f"{self.kind} parameter {self.name} needs values")
        elif self.kind == "log2_int":
            if not (_is_pow2(self.minimum) and _is_pow2(self.maximum)):
                raise ValueError(
                    f"{self.name}: log2_int bounds must be powers of two")
            if self.maximum < self.minimum:
                raise ValueError(f"{self.name}: max < min")
        elif self.kind != "boolean" and self.maximum < self.minimum:
            raise ValueError(f"{self.name}: max < min")

    # -- size ----------------------------------------------------------------

    @property
    def cardinality(self) -> Optional[int]:
        """Number of distinct values; None for continuous parameters."""
        if self.kind == "continuous":
            return None
        if self.kind == "discrete":
            return int(self.maximum - self.minimum) + 1
        if self.kind == "boolean":
            return 2
        if self.kind == "log2_int":
            return self._log2_span()[1] - self._log2_span()[0] + 1
        return len(self.values)

    def _log2_span(self) -> tuple:
        return int(np.log2(int(self.minimum))), int(np.log2(int(self.maximum)))

    # -- vectorized unit <-> value maps --------------------------------------

    def from_unit_batch(self, a: np.ndarray) -> list:
        """Paper's inverse mapping, vectorized: [N] unit coords -> N values.

        Returns a plain Python list so config dicts hold native types
        (int/float/bool/whatever ``values`` holds), matching the scalar path.
        """
        a = np.clip(np.asarray(a, dtype=float), 0.0, 1.0)
        if self.kind == "continuous":
            return (a * (self.maximum - self.minimum) + self.minimum).tolist()
        if self.kind == "discrete":
            v = np.floor(a * (self.maximum - self.minimum) + self.minimum + 0.5)
            return np.clip(v, self.minimum, self.maximum).astype(int).tolist()
        if self.kind == "boolean":
            return [bool(x) for x in (a >= 0.5)]
        if self.kind == "log2_int":
            e_lo, e_hi = self._log2_span()
            idx = np.clip(np.floor(a * (e_hi - e_lo) + 0.5), 0, e_hi - e_lo)
            return [int(2 ** (e_lo + int(i))) for i in idx]
        # list kinds: the index space [0, len-1] is the discrete range
        k = len(self.values)
        idx = np.clip(np.floor(a * (k - 1) + 0.5), 0, k - 1).astype(int)
        return [self.values[i] for i in idx]

    def to_unit_batch(self, values: Sequence) -> np.ndarray:
        """Forward map, vectorized: N values -> [N] unit coords."""
        if self.kind in _LIST_KINDS:
            denom = max(1, len(self.values) - 1)
            return np.array([self.values.index(v) / denom for v in values],
                            np.float32)
        if self.kind == "boolean":
            return np.array([1.0 if v else 0.0 for v in values], np.float32)
        if self.kind == "log2_int":
            e_lo, e_hi = self._log2_span()
            if e_hi == e_lo:
                return np.zeros(len(values), np.float32)
            e = np.log2(np.asarray(values, dtype=float))
            return ((e - e_lo) / (e_hi - e_lo)).astype(np.float32)
        if self.maximum == self.minimum:
            return np.zeros(len(values), np.float32)
        v = np.asarray(values, dtype=float)
        return ((v - self.minimum) / (self.maximum - self.minimum)).astype(
            np.float32)

    # -- scalar maps (the N == 1 case of the batch maps) ---------------------

    def from_unit(self, a: float):
        """Paper's inverse mapping for a single coordinate a in [0,1]."""
        return self.from_unit_batch(np.array([a]))[0]

    def to_unit(self, value) -> float:
        """Forward map (used to seed the buffer with known configs)."""
        return float(self.to_unit_batch([value])[0])

    def values_from_indices(self, idx: np.ndarray) -> list:
        """Quantization indices -> native parameter values (the index
        ``from_unit_batch`` would land on, as ``coord_maps``' ``idx``
        computes it). Quantized kinds only."""
        idx = np.asarray(idx)
        if self.kind == "continuous":
            raise ValueError(
                f"{self.name}: continuous parameters have no index space")
        if self.kind == "discrete":
            return (idx.astype(int) + int(self.minimum)).tolist()
        if self.kind == "boolean":
            return [bool(i) for i in idx]
        if self.kind == "log2_int":
            e_lo = self._log2_span()[0]
            return [int(2 ** (e_lo + int(i))) for i in idx]
        return [self.values[int(i)] for i in idx]

    # -- validation ----------------------------------------------------------

    def validate(self, value) -> bool:
        if self.kind in _LIST_KINDS:
            return value in self.values
        if self.kind == "boolean":
            return isinstance(value, (bool, np.bool_)) or value in (0, 1)
        if self.kind == "log2_int":
            return (float(value).is_integer() and _is_pow2(value)
                    and self.minimum <= value <= self.maximum)
        if self.kind == "discrete":
            return float(value).is_integer() and self.minimum <= value <= self.maximum
        return self.minimum <= value <= self.maximum


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """The m-dimensional static-parameter space Lambda (paper §II-A)."""

    specs: tuple

    def __post_init__(self):
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate parameter names")

    @property
    def names(self) -> list:
        return [s.name for s in self.specs]

    @property
    def dim(self) -> int:
        return len(self.specs)

    # -- unit <-> config, scalar and vectorized ------------------------------

    def to_config(self, action: Sequence[float]) -> dict:
        if len(action) != self.dim:
            raise ValueError(f"action dim {len(action)} != param dim {self.dim}")
        return self.to_configs(np.asarray(action, dtype=float)[None, :])[0]

    def to_configs(self, actions: np.ndarray) -> list:
        """Vectorized inverse map: [N, m] unit actions -> N config dicts."""
        actions = np.asarray(actions, dtype=float)
        if actions.ndim != 2 or actions.shape[1] != self.dim:
            raise ValueError(
                f"actions shape {actions.shape} != (N, {self.dim})")
        columns = [s.from_unit_batch(actions[:, j])
                   for j, s in enumerate(self.specs)]
        return [dict(zip(self.names, row)) for row in zip(*columns)]

    def to_action(self, config: dict) -> np.ndarray:
        return self.to_actions([config])[0]

    def to_actions(self, configs: Sequence[dict]) -> np.ndarray:
        """Vectorized forward map: N config dicts -> [N, m] unit actions."""
        columns = [s.to_unit_batch([c[s.name] for c in configs])
                   for s in self.specs]
        return np.stack(columns, axis=-1).astype(np.float32)

    # -- defaults / validation / search support ------------------------------

    def default_config(self) -> dict:
        out = {}
        for s in self.specs:
            if s.default is not None:
                out[s.name] = s.default
            elif s.kind in _LIST_KINDS:
                out[s.name] = s.values[0]
            else:
                out[s.name] = s.from_unit(0.0)
        return out

    def validate(self, config: dict) -> bool:
        return all(s.validate(config[s.name]) for s in self.specs)

    # -- compact (index) trace support ---------------------------------------

    @property
    def is_quantized(self) -> bool:
        """True when every parameter has finitely many values: the episode
        engine and the pure env models need it (``coord_maps``)."""
        return all(s.cardinality is not None for s in self.specs)

    def index_dtype(self) -> np.dtype:
        """Smallest unsigned dtype holding every knob's quantization index.
        Indices are computed in float32 (``coord_maps``), exact only up to
        2**24, so a larger knob is an error, not a wider dtype."""
        if not self.is_quantized:
            raise ValueError("continuous spaces have no index trace encoding")
        top = max(s.cardinality - 1 for s in self.specs)
        if top > 2 ** 24:
            raise ValueError(
                f"knob cardinality {top + 1} exceeds the exact-integer range "
                f"of the float32 index computation (2**24); the compact "
                f"index trace cannot represent this space losslessly")
        for dt in (np.uint8, np.uint16):
            if top <= np.iinfo(dt).max:
                return np.dtype(dt)
        return np.dtype(np.uint32)

    def configs_from_indices(self, idx: np.ndarray) -> list:
        """[N, m] quantization indices -> N config dicts (the inverse of
        ``coord_maps``' ``idx``)."""
        idx = np.asarray(idx)
        if idx.ndim != 2 or idx.shape[1] != self.dim:
            raise ValueError(f"indices shape {idx.shape} != (N, {self.dim})")
        columns = [s.values_from_indices(idx[:, j])
                   for j, s in enumerate(self.specs)]
        return [dict(zip(self.names, row)) for row in zip(*columns)]

    def grid_axes(self, points_per_dim: int) -> list:
        """Per-dimension unit grids, capped at each parameter's cardinality.

        A boolean axis contributes 2 points, an 11-value log2_int axis at most
        11 — never ``points_per_dim`` redundant copies — so grids over
        mixed-type spaces enumerate distinct configurations only.
        """
        axes = []
        for s in self.specs:
            n = points_per_dim
            if s.cardinality is not None:
                n = min(n, s.cardinality)
            axes.append(np.linspace(0.0, 1.0, max(2, n)) if n > 1
                        else np.array([0.0]))
        return axes

    def grid(self, points_per_dim: int) -> list:
        """Cartesian grid of configs (used by the grid-search baseline)."""
        mesh = np.meshgrid(*self.grid_axes(points_per_dim), indexing="ij")
        flat = np.stack([m.reshape(-1) for m in mesh], axis=-1)
        return self.to_configs(flat)


def _fma(a, b: float, c: float):
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend contracts
    the reference's quantization expressions (``b`` and ``c`` are float32
    constants folded from the Python expression)."""
    import torch

    from repro_torch.random import _fma_f32

    def const(x):
        return torch.tensor(x, dtype=torch.float32, device=a.device)

    return _fma_f32(a, const(b), const(c))


def _recip(d: float) -> float:
    """float32 ``1 / d``: XLA compiles a division by a constant as a
    product with its rounded reciprocal."""
    return float(np.float32(1.0 / d))


def coord_maps(space: ParamSpace) -> list:
    """Per-coordinate torch versions of the paper's inverse action map, the
    twin of the reference's ``jax_coord_maps``.

    Returns one ``fn(a) -> dict`` per parameter; ``a`` is a float32 tensor
    of unit coordinates of any shape, and every value returned is a float32
    tensor of that shape. Keys:

      value  decoded parameter value (booleans as 0/1)
      idx    quantization index (a float32 integer)
      q      canonical unit coordinate of the decoded value
      log2   log2(value) where meaningful (log2_int, and list kinds whose
             values are all powers of two); absent otherwise

    Rounding follows the reference's compiled code: ``a * span + lo + 0.5``
    is one fused multiply-add ``fma(a, span, lo + 0.5)``, and ``q`` is the
    index times the rounded reciprocal of the span. Only quantized kinds are
    supported (``ParamSpace.is_quantized``).
    """
    import torch

    maps = []
    for spec in space.specs:
        if spec.cardinality is None:
            raise ValueError(
                f"{spec.name}: continuous parameters have no exact in-graph "
                "quantization; use the host tuning engine for this space")

        def make(spec=spec):
            card = spec.cardinality

            def table(values):
                return lambda idx: torch.tensor(
                    values, dtype=torch.float32,
                    device=idx.device)[idx.long()]

            if spec.kind == "boolean":
                def fn(a):
                    idx = (a >= 0.5).to(torch.float32)
                    return {"value": idx, "idx": idx, "q": idx}
                return fn
            if spec.kind == "discrete":
                lo, hi = float(spec.minimum), float(spec.maximum)

                def fn(a):
                    v = torch.clamp(torch.floor(_fma(a, hi - lo, lo + 0.5)),
                                    lo, hi)
                    idx = v - lo
                    return {"value": v, "idx": idx,
                            "q": idx * _recip(max(1.0, hi - lo))}
                return fn
            if spec.kind == "log2_int":
                e_lo, e_hi = spec._log2_span()
                values = table([float(2 ** e)
                                for e in range(e_lo, e_hi + 1)])

                def fn(a):
                    idx = torch.clamp(torch.floor(_fma(a, e_hi - e_lo, 0.5)),
                                      0, e_hi - e_lo)
                    return {"value": values(idx), "idx": idx,
                            "q": idx * _recip(max(1, e_hi - e_lo)),
                            "log2": idx + e_lo}
                return fn
            try:
                values = table([float(v) for v in spec.values])
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"{spec.name}: in-graph maps need numeric values") from e
            log2_values = None
            if all(float(v) > 0 and float(v).is_integer() and _is_pow2(v)
                   for v in spec.values):
                log2_values = table([float(int(v).bit_length() - 1)
                                     for v in spec.values])

            def fn(a):
                idx = torch.clamp(torch.floor(_fma(a, card - 1, 0.5)), 0,
                                  card - 1)
                out = {"value": values(idx), "idx": idx,
                       "q": idx * _recip(max(1, card - 1))}
                if log2_values is not None:
                    out["log2"] = log2_values(idx)
                return out
            return fn

        maps.append(make())
    return maps
