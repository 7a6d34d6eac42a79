"""Typed, validated configuration for the ECG serving layer.

Port of ``repro/serve/config.py``.  One frozen :class:`ServeConfig`, following the :class:`~repro_torch.solver.
SolverConfig` conventions (validate at construction, coerce convenient
spellings, cheap ``dataclasses.replace`` derivation): the solver template
every registered operator is built with, the registry byte budget, the
warm-start cache location, and the batching/backpressure policy.
"""

from __future__ import annotations

import dataclasses

from repro_torch.serve.packing import PackingConfig
from repro_torch.solver.config import SolverConfig


def _default_solver() -> SolverConfig:
    # rankrev keeps batched requests safe by default: a localized or
    # near-degenerate RHS produces rank-deficient splittings, and a server
    # cannot pre-screen what clients send
    return SolverConfig(t=4, adaptive="rankrev")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Configuration of one :class:`~repro_torch.serve.ECGServer`.

    solver:         the :class:`~repro_torch.solver.SolverConfig` template each
                    registered operator's session is built from (dict /
                    None spellings coerced).  Warm-start loads override its
                    ``tune.tuned`` / ``adaptive.select`` fields per
                    operator.
    registry_bytes: LRU byte budget of the operator registry, measured in
                    CSR bytes (:func:`~repro_torch.serve.operator_nbytes`).  The
                    most recently used session always survives, even when
                    it alone exceeds the budget.
    cache_dir:      directory for the disk-backed warm-start cache (tuning
                    + t-selection JSON per operator); ``None`` disables
                    persistence.
    max_batch:      coalescing limit — a per-operator group of this many
                    distinct pending requests is dispatched eagerly at
                    ``submit`` time; ``flush()`` drains regardless.
    max_wait_s:     age-based flush: a ``submit`` that finds requests
                    older than this drains the queue first.  ``0`` (the
                    default) disables the clock — batches close on
                    ``max_batch`` or an explicit ``flush()`` only, which
                    keeps request traces deterministic.
    max_pending:    bounded-queue backpressure: a ``submit`` beyond this
                    many pending requests raises
                    :class:`~repro_torch.serve.ServeOverloaded` instead of
                    growing the queue without bound.
    dedup:          share one solve among concurrent requests with
                    identical (operator, b, x0) payloads — cross-request
                    result reuse, bit-identical by construction.
    packing:        the opt-in width-packing policy
                    (:class:`~repro_torch.serve.PackingConfig`; a pack-mode
                    string or dict coerces).  ``pack="width"`` coalesces
                    compatible requests into one enlarged block solve with
                    per-request retirement — higher req/s, measured-relres
                    contract instead of bit-identity.  The default
                    (``pack="off"``) changes nothing.
    """

    solver: SolverConfig = dataclasses.field(default_factory=_default_solver)
    registry_bytes: int = 256 * 1024 * 1024
    cache_dir: str | None = None
    max_batch: int = 8
    max_wait_s: float = 0.0
    max_pending: int = 256
    dedup: bool = True
    packing: PackingConfig = dataclasses.field(default_factory=PackingConfig)

    def __post_init__(self):
        object.__setattr__(self, "solver", SolverConfig.coerce(self.solver))
        if not isinstance(self.registry_bytes, int) or self.registry_bytes < 1:
            raise ValueError(
                f"registry_bytes must be an int >= 1, got {self.registry_bytes!r}"
            )
        if not isinstance(self.max_batch, int) or self.max_batch < 1:
            raise ValueError(f"max_batch must be an int >= 1, got {self.max_batch!r}")
        if not self.max_wait_s >= 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s!r}")
        if not isinstance(self.max_pending, int) or self.max_pending < 1:
            raise ValueError(
                f"max_pending must be an int >= 1, got {self.max_pending!r}"
            )
        if self.cache_dir is not None and not isinstance(self.cache_dir, str):
            raise ValueError(f"cache_dir must be a str or None, got {self.cache_dir!r}")
        object.__setattr__(self, "dedup", bool(self.dedup))
        object.__setattr__(self, "packing", PackingConfig.coerce(self.packing))

    @classmethod
    def coerce(cls, value) -> "ServeConfig":
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(
            f"config must be a ServeConfig or dict of its fields, got {type(value)}"
        )

    def replace(self, **overrides) -> "ServeConfig":
        """Return a new config with ``overrides`` applied (field names
        only; for solver-template tweaks compose with
        ``SolverConfig.replace``)."""
        own = {f.name for f in dataclasses.fields(self)}
        unknown = set(overrides) - own
        if unknown:
            raise ValueError(
                f"unknown ServeConfig override(s) {sorted(unknown)}; "
                f"expected one of {sorted(own)}"
            )
        return dataclasses.replace(self, **overrides)
