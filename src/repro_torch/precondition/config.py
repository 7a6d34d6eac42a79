"""Typed, validated preconditioner configuration.

:class:`PreconditionConfig` is the sixth sub-config of
:class:`~repro_torch.solver.config.SolverConfig` — it selects and parameterizes
the preconditioner the solve loop applies, without adding a single keyword
argument to the solver API.  Like the other sub-configs it is a frozen
dataclass, validates at construction, and coerces the convenient string
spelling (``precondition="block_jacobi"``).

Four kinds ship (built and applied by :mod:`repro_torch.precondition.build`):

* ``"none"``         — identity; the solve is bit-identical to an
                       unpreconditioned build.
* ``"block_jacobi"`` — block-diagonal M from the operator's own row blocks
                       (the partition's per-rank slot ranges distributed, a
                       uniform ``block`` split sequentially); applies are
                       batched triangular solves against host-Cholesky
                       factors, local to every rank.
* ``"chebyshev"``    — degree-``degree`` Chebyshev polynomial in A on an
                       eigenvalue interval; ``eig_bounds=None`` estimates
                       λmax by power iteration at build time and sets
                       λmin = λmax / ``eig_ratio``.  Applies cost
                       ``degree - 1`` extra SpMBVs (p2p only — no psum).
* ``"inexact"``      — iteration-varying weighted-Jacobi sweeps: the
                       flexible-ECG path (Moufawad arXiv:2305.19013).  The
                       classic scheme runs it with a periodic residual
                       reseed (``reseed``) — its direction chain never
                       re-reads the residual, so a varying M⁻¹ₖ needs the
                       flexible restart; s-step reseeds every block by
                       construction; pipelined cannot reseed at all and
                       rejects this kind.
"""

from __future__ import annotations

import dataclasses

PRECONDITIONS = ("none", "block_jacobi", "chebyshev", "inexact")


def _freeze(cls, **updates):
    for k, v in updates.items():
        object.__setattr__(cls, k, v)


@dataclasses.dataclass(frozen=True)
class PreconditionConfig:
    """Preconditioner selection + knobs (see module docstring).

    kind:        ``none | block_jacobi | chebyshev | inexact``.
    block:       block-Jacobi block size (rows per diagonal block).
    degree:      Chebyshev polynomial degree (>= 1; applies cost
                 ``degree - 1`` SpMBVs each).
    eig_bounds:  explicit ``(lambda_min, lambda_max)`` Chebyshev interval;
                 ``None`` = estimate at build time.
    eig_ratio:   λmax/λmin ratio assumed when only λmax is estimated.
    power_iters: power-iteration count of the build-time λmax estimate.
    sweeps:      weighted-Jacobi sweep count of the inexact kind (its
                 damping varies with the iteration index — that
                 variability is what makes it exercise the flexible path).
    omega:       weighted-Jacobi damping factor of the inexact kind.
    reseed:      flexible-restart period of the inexact kind under the
                 classic scheme: every that-many iterations the direction
                 chain reseeds from the preconditioned residual (costs no
                 collective; too small a period starves the chain of
                 conjugate directions — 8 is a robust default).
    """

    kind: str = "none"
    block: int = 32
    degree: int = 4
    eig_bounds: tuple[float, float] | None = None
    eig_ratio: float = 30.0
    power_iters: int = 25
    sweeps: int = 2
    omega: float = 2.0 / 3.0
    reseed: int = 8

    def __post_init__(self):
        if self.kind not in PRECONDITIONS:
            raise ValueError(
                f"unknown preconditioner kind {self.kind!r}; "
                f"expected one of {PRECONDITIONS}"
            )
        if not isinstance(self.block, int) or self.block < 1:
            raise ValueError(f"block must be an int >= 1, got {self.block!r}")
        if not isinstance(self.degree, int) or self.degree < 1:
            raise ValueError(f"degree must be an int >= 1, got {self.degree!r}")
        if self.eig_bounds is not None:
            eb = tuple(float(x) for x in self.eig_bounds)
            if len(eb) != 2 or not (0 < eb[0] < eb[1]):
                raise ValueError(
                    f"eig_bounds must be (lambda_min, lambda_max) with "
                    f"0 < lambda_min < lambda_max, got {self.eig_bounds!r}"
                )
            _freeze(self, eig_bounds=eb)
        if not self.eig_ratio > 1:
            raise ValueError(f"eig_ratio must be > 1, got {self.eig_ratio!r}")
        if not isinstance(self.power_iters, int) or self.power_iters < 1:
            raise ValueError(
                f"power_iters must be an int >= 1, got {self.power_iters!r}"
            )
        if not isinstance(self.sweeps, int) or self.sweeps < 1:
            raise ValueError(f"sweeps must be an int >= 1, got {self.sweeps!r}")
        if not 0 < self.omega <= 1:
            raise ValueError(f"omega must be in (0, 1], got {self.omega!r}")
        if not isinstance(self.reseed, int) or self.reseed < 2:
            raise ValueError(f"reseed must be an int >= 2, got {self.reseed!r}")

    @property
    def active(self) -> bool:
        return self.kind != "none"

    @classmethod
    def coerce(cls, value) -> "PreconditionConfig":
        """Normalize the accepted spellings into a PreconditionConfig."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        if isinstance(value, str):
            return cls(kind=value)
        raise TypeError(
            f"precondition must be a PreconditionConfig, a kind string, a "
            f"dict of PreconditionConfig fields, or None; got {type(value)}"
        )
