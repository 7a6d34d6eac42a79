"""Typed, validated configuration for the ECG solver handle.

Port of ``repro/solver/config.py``: the same fields, defaults, validation
and JSON dicts (a ``machine``, a ``tuned`` config and a ``select`` included,
with the reference's field names), so one ``SolverConfig`` serialises to
the same dict in both packages.

One frozen :class:`SolverConfig` replaces the ~20 loosely-typed keyword
arguments of the legacy one-shot spellings,
:func:`repro_torch.core.ecg.ecg_solve`,
:func:`repro_torch.sparse.spmbv.distributed_ecg` and
:func:`repro_torch.sparse.spmbv.make_distributed_spmbv` (the last two map
their arguments onto it in ``repro_torch.sparse.spmbv._build_legacy_solver``).
It is composed of orthogonal sub-configs, one per subsystem:

* :class:`CommConfig`   — the node-aware exchange (strategy, overlap,
  col-split, machine parameters) → ``repro_torch.core.node_aware`` + the
  interior/boundary schedule of ``repro_torch.sparse.spmbv``.
* :class:`KernelConfig` — the local compute formulation (backend, Block-ELL
  tile) → ``repro_torch.kernels``.
* :class:`TuneConfig`   — setup-time autotuning (mode, or a precomputed
  :class:`~repro_torch.tune.TunedConfig`) → ``repro_torch.tune``.
* :class:`AdaptiveConfig` — the in-solve width controller and ``t="auto"``
  selection knobs → ``repro_torch.adaptive``.
* :class:`MethodConfig` — the iteration scheme (classic / pipelined /
  s-step and its knobs) → ``repro_torch.core.methods``.
* :class:`~repro_torch.precondition.PreconditionConfig` — the preconditioner
  (none / block_jacobi / chebyshev / inexact) → ``repro_torch.precondition``.

Validation happens at construction: a bad strategy/backend/mode raises
``ValueError`` immediately, not three layers down inside a traced solve.
String shorthands from the legacy API are *coerced* into their typed form
(``adaptive="reduce"`` becomes a resolved
:class:`~repro_torch.adaptive.ReductionPolicy`; ``tune="model"`` becomes
``TuneConfig(mode="model")``), so after ``__post_init__`` every field holds
exactly one well-typed value.

All four sub-configs (and ``SolverConfig`` itself) are frozen dataclasses:
hashable, comparable, safe to share between handles, and cheap to rebuild
with :meth:`SolverConfig.replace`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.precondition.config import PreconditionConfig

STRATEGIES = ("standard", "2step", "3step", "optimal")
BACKENDS = ("jnp", "pallas")
TUNE_MODES = ("off", "model", "model:structural", "measure")
METHODS = ("classic", "pipelined", "sstep")


def _freeze(cls, **updates):
    """object.__setattr__-based update for frozen-dataclass __post_init__."""
    for k, v in updates.items():
        object.__setattr__(cls, k, v)


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Node-aware exchange configuration.

    strategy:  point-to-point exchange strategy (paper §4): one of
               ``standard | 2step | 3step | optimal``.
    overlap:   hide the halo-exchange rounds behind interior SpMBV compute
               (interior/boundary split schedule).
    col_split: wide-halo column-split factor for the nodal-optimal strategy
               (must divide t); ``None`` = §4.3 byte model decides.
    machine:   :class:`~repro.core.machines.MachineParams` the byte models
               use; ``None`` = per-mode default (TPU-v5e for the models).
    """

    strategy: str = "standard"
    overlap: bool = False
    col_split: int | None = None
    machine: Any = None

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown exchange strategy {self.strategy!r}; "
                f"expected one of {STRATEGIES}"
            )
        if self.col_split is not None and (
            not isinstance(self.col_split, int) or self.col_split < 1
        ):
            raise ValueError(f"col_split must be a positive int, got {self.col_split!r}")
        _freeze(self, overlap=bool(self.overlap))


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Local-compute configuration.

    backend:   ``"jnp"`` (plain torch ops: scalar-gather CSR SpMBV and
               unfused Gram products and updates) or ``"pallas"`` (the
               hand-written CUDA kernels: Block-ELL SpMBV, fused Gram
               product, fused tail; their plain torch versions on CPU
               tensors).  The reference's spellings are kept so that one
               config means the same thing in both packages.
    ell_block: Block-ELL tile shape — an int for square tiles or an explicit
               ``(br, bc)`` pair; normalized to a tuple.
    """

    backend: str = "jnp"
    ell_block: int | tuple[int, int] = (8, 8)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}"
            )
        blk = self.ell_block
        if isinstance(blk, int):
            blk = (blk, blk)
        blk = tuple(int(x) for x in blk)
        if len(blk) != 2 or any(x < 1 for x in blk):
            raise ValueError(f"ell_block must be a positive int or (br, bc), got {self.ell_block!r}")
        _freeze(self, ell_block=blk)


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Setup-time autotuning configuration.

    mode:   ``"off"`` (use the explicit :class:`CommConfig`/
            :class:`KernelConfig` values), ``"model"`` (paper's analytic
            max-rate models), ``"model:structural"`` (executor-structural:
            plan dispatches + moved bytes), or ``"measure"`` (setup-time
            microbenchmarks on the mesh).
    tuned:  a precomputed :class:`~repro_torch.tune.TunedConfig` to apply verbatim
            (e.g. loaded back from ``TunedConfig.from_json``); wins over
            ``mode``.
    """

    mode: str = "off"
    tuned: Any = None

    def __post_init__(self):
        if self.mode not in TUNE_MODES:
            raise ValueError(
                f"unknown tune mode {self.mode!r}; expected one of {TUNE_MODES}"
            )
        if self.tuned is not None and not hasattr(self.tuned, "strategy"):
            raise TypeError(
                f"tuned must be a repro_torch.tune.TunedConfig, got {type(self.tuned)}"
            )

    @classmethod
    def coerce(cls, value) -> "TuneConfig":
        """Normalize the accepted spellings into a TuneConfig."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        if isinstance(value, str):
            return cls(mode=value)
        if hasattr(value, "strategy") and hasattr(value, "ell_block"):
            return cls(mode=getattr(value, "mode", "off"), tuned=value)
        raise TypeError(
            f"tune must be a TuneConfig, a mode string, a TunedConfig, or a "
            f"dict of TuneConfig fields; got {type(value)}"
        )

    @property
    def active(self) -> bool:
        return self.tuned is not None or self.mode != "off"


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """In-solve width controller and ``t="auto"`` selection knobs.

    policy:       a resolved :class:`~repro.adaptive.ReductionPolicy`, or
                  None (fixed width).  String shorthands (``"rankrev"`` /
                  ``"reduce"`` / ``"reduce+restart"``) are coerced at
                  construction.  ``policy="off"`` also resolves to None but
                  records ``explicit_off`` — ``t="auto"`` normally implies
                  the rankrev breakdown guard, and only an *explicit* off
                  suppresses it (mirroring the legacy solvers).
    t_candidates: candidate enlarging factors ranked by ``t="auto"``.
    select:       a precomputed :class:`~repro.adaptive.TSelection` to use
                  instead of running the probes.
    probe_iters:  iteration budget per ``t="auto"`` probe.
    probe_rtol:   early-stop tolerance of the probe: stop once the fitted
                  per-iteration decay rate is stable within this relative
                  tolerance on consecutive iterations (0 = always run the
                  full ``probe_iters``).
    """

    policy: Any = None
    t_candidates: tuple[int, ...] = (1, 2, 4, 8, 16)
    select: Any = None
    probe_iters: int = 8
    probe_rtol: float = 0.01
    explicit_off: bool = False

    def __post_init__(self):
        from repro_torch.adaptive.reduce import resolve_policy

        # explicit_off tracks the *latest* policy request: a new "off" sets
        # it, any other concrete policy clears it (so replace(policy=...)
        # on a formerly-off config is not sticky), and policy=None (no
        # request) carries the existing flag through replace().
        if self.policy == "off":
            explicit_off = True
        elif self.policy is not None:
            explicit_off = False
        else:
            explicit_off = bool(self.explicit_off)
        _freeze(
            self,
            policy=resolve_policy(self.policy),
            t_candidates=tuple(int(t) for t in self.t_candidates),
            explicit_off=explicit_off,
        )
        if self.probe_iters < 2:
            raise ValueError(f"probe_iters must be >= 2, got {self.probe_iters}")
        if self.probe_rtol < 0:
            raise ValueError(f"probe_rtol must be >= 0, got {self.probe_rtol}")

    @classmethod
    def coerce(cls, value) -> "AdaptiveConfig":
        from repro_torch.adaptive.reduce import ReductionPolicy

        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        if isinstance(value, (str, ReductionPolicy)):
            return cls(policy=value)
        raise TypeError(
            f"adaptive must be an AdaptiveConfig, a policy (or its string "
            f"shorthand), a dict of AdaptiveConfig fields, or None; "
            f"got {type(value)}"
        )


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    """Iteration-scheme configuration (see :mod:`repro.core.methods`).

    name:      ``"classic"`` (the paper's two-psum §3.1 iteration),
               ``"pipelined"`` (same collectives, packed Gram reduction
               overlapped with the SpMBV exchange via the AZ recurrence), or
               ``"sstep"`` (s SpMBV sweeps per collective pair,
               rank-revealing safeguarded).
    s:         inner-step count of the s-step scheme (psums amortize to
               2/s per effective iteration); must stay 1 for other methods.
    depth:     pipeline depth; only depth-1 (one iteration of overlap, the
               AZ recurrence) is implemented.
    reorth:    s-step per-block Cholesky-QR2 second pass — one extra (st)²
               psum per block, for matrices where a single pivoted
               factorization leaves too much A-orthogonality on the table.
    rank_rtol: pivot threshold override for method-mandated rank-revealing
               factorizations (None = the policy's threshold, else the
               dtype default).
    """

    name: str = "classic"
    s: int = 1
    depth: int = 1
    reorth: bool = False
    rank_rtol: float | None = None

    def __post_init__(self):
        if self.name not in METHODS:
            raise ValueError(
                f"unknown method {self.name!r}; expected one of {METHODS}"
            )
        if not isinstance(self.s, int) or self.s < 1:
            raise ValueError(f"s must be an int >= 1, got {self.s!r}")
        if self.s != 1 and self.name != "sstep":
            raise ValueError(
                f"s={self.s} only applies to method 'sstep' (got method "
                f"{self.name!r}); classic/pipelined have no inner-step count"
            )
        if self.depth != 1:
            raise ValueError(
                f"only depth-1 pipelining (the AZ recurrence) is implemented, "
                f"got depth={self.depth!r}"
            )
        if self.reorth and self.name != "sstep":
            raise ValueError(
                "reorth (per-block Cholesky-QR2) only applies to method 'sstep'"
            )
        if self.rank_rtol is not None and not self.rank_rtol > 0:
            raise ValueError(f"rank_rtol must be > 0 or None, got {self.rank_rtol!r}")
        _freeze(self, reorth=bool(self.reorth))

    @classmethod
    def coerce(cls, value) -> "MethodConfig":
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        if isinstance(value, str):
            return cls(name=value)
        raise TypeError(
            f"method must be a MethodConfig, a method name, a dict of "
            f"MethodConfig fields, or None; got {type(value)}"
        )


#: Flat override spellings accepted by ``SolverConfig.replace`` /
#: ``ECGSolver.with_config`` — each maps to (sub-config field, field name).
_FLAT_FIELDS = {
    "strategy": ("comm", "strategy"),
    "overlap": ("comm", "overlap"),
    "col_split": ("comm", "col_split"),
    "machine": ("comm", "machine"),
    "backend": ("kernel", "backend"),
    "ell_block": ("kernel", "ell_block"),
    "tune_mode": ("tune", "mode"),
    "tuned": ("tune", "tuned"),
    "policy": ("adaptive", "policy"),
    "t_candidates": ("adaptive", "t_candidates"),
    "select": ("adaptive", "select"),
    "probe_iters": ("adaptive", "probe_iters"),
    "probe_rtol": ("adaptive", "probe_rtol"),
    "s": ("method", "s"),
    "depth": ("method", "depth"),
    "reorth": ("method", "reorth"),
    "block": ("precondition", "block"),
    "degree": ("precondition", "degree"),
    "eig_bounds": ("precondition", "eig_bounds"),
    "eig_ratio": ("precondition", "eig_ratio"),
    "power_iters": ("precondition", "power_iters"),
    "sweeps": ("precondition", "sweeps"),
    "omega": ("precondition", "omega"),
    "reseed": ("precondition", "reseed"),
}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The one config every ECG subsystem reads.

    t:         enlarging factor (int >= 1), or ``"auto"`` to pick it at
               build time from the iterations-vs-cost model.
    tol:       convergence tolerance on the residual norm.
    max_iters: iteration cap of the solve loop.
    comm/kernel/tune/adaptive: the four sub-configs (see their docs).  The
               constructor coerces convenient spellings: ``tune="model"``,
               ``tune=TunedConfig``, ``adaptive="reduce"``,
               ``adaptive=ReductionPolicy`` all normalize to typed fields.
    """

    t: int | str = 8
    tol: float = 1e-8
    max_iters: int = 1000
    comm: CommConfig = dataclasses.field(default_factory=CommConfig)
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    tune: TuneConfig = dataclasses.field(default_factory=TuneConfig)
    adaptive: AdaptiveConfig = dataclasses.field(default_factory=AdaptiveConfig)
    method: MethodConfig = dataclasses.field(default_factory=MethodConfig)
    precondition: PreconditionConfig = dataclasses.field(
        default_factory=PreconditionConfig
    )

    def __post_init__(self):
        if isinstance(self.t, str):
            if self.t != "auto":
                raise ValueError(f"t must be an int >= 1 or 'auto', got {self.t!r}")
        elif not isinstance(self.t, int) or self.t < 1:
            raise ValueError(f"t must be an int >= 1 or 'auto', got {self.t!r}")
        if not self.tol >= 0:
            raise ValueError(f"tol must be >= 0, got {self.tol!r}")
        if not isinstance(self.max_iters, int) or self.max_iters < 1:
            raise ValueError(f"max_iters must be an int >= 1, got {self.max_iters!r}")
        comm = self.comm if isinstance(self.comm, CommConfig) else CommConfig(**self.comm)
        kernel = (
            self.kernel if isinstance(self.kernel, KernelConfig)
            else KernelConfig(**self.kernel) if isinstance(self.kernel, dict)
            else KernelConfig(backend=self.kernel)
        )
        _freeze(
            self,
            comm=comm,
            kernel=kernel,
            tune=TuneConfig.coerce(self.tune),
            adaptive=AdaptiveConfig.coerce(self.adaptive),
            method=MethodConfig.coerce(self.method),
            precondition=PreconditionConfig.coerce(self.precondition),
        )
        policy = self.adaptive.policy
        if (
            self.method.name == "pipelined"
            and policy is not None
            and policy.restart
        ):
            raise ValueError(
                "method 'pipelined' cannot run a restart policy: re-enlarging "
                "would need an extra in-loop SpMBV to rebuild the AZ "
                "recurrence; use adaptive='reduce' (or method='classic')"
            )
        if self.method.name == "pipelined" and self.precondition.kind == "inexact":
            raise ValueError(
                "method 'pipelined' cannot run the iteration-varying "
                "'inexact' preconditioner: a varying M needs the flexible "
                "residual reseed, and rebuilding the AZ recurrence for a "
                "reseeded Z would need an extra in-loop SpMBV; use "
                "method='classic' (periodic reseed) or 'sstep' (reseeds "
                "every block), or a fixed preconditioner kind"
            )

    def replace(self, **overrides) -> "SolverConfig":
        """Return a new config with ``overrides`` applied.

        Accepts both sub-config values (``comm=CommConfig(...)``) and the
        flat spellings of their fields (``strategy="3step"``,
        ``backend="pallas"``, ``tune_mode="model"``, ``policy="reduce"`` …);
        unknown names raise ``ValueError`` listing the accepted keys.
        """
        top: dict = {}
        nested: dict[str, dict] = {}
        own = {f.name for f in dataclasses.fields(self)}
        for key, value in overrides.items():
            if key == "method" and isinstance(value, str):
                # replace(method="sstep", s=4) — route the string through the
                # nested dict so it composes with the flat s/depth/reorth
                nested.setdefault("method", {})["name"] = value
            elif key == "precondition" and isinstance(value, str):
                # replace(precondition="block_jacobi", block=64) — same
                # routing so the kind string composes with the flat knobs
                nested.setdefault("precondition", {})["kind"] = value
            elif key in _FLAT_FIELDS:
                sub, field = _FLAT_FIELDS[key]
                nested.setdefault(sub, {})[field] = value
            elif key in own:
                top[key] = value
            else:
                raise ValueError(
                    f"unknown config override {key!r}; expected a SolverConfig "
                    f"field ({sorted(own)}) or a flat sub-config field "
                    f"({sorted(_FLAT_FIELDS)})"
                )
        for sub, fields in nested.items():
            if sub in top:
                raise ValueError(
                    f"cannot combine {sub}= with flat overrides of its fields "
                    f"({sorted(fields)}) in one replace() call"
                )
            current = getattr(self, sub)
            if sub == "tune":
                current = TuneConfig.coerce(current)
            top[sub] = dataclasses.replace(current, **fields)
        return dataclasses.replace(self, **top)

    @classmethod
    def coerce(cls, value) -> "SolverConfig":
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"config must be a SolverConfig or dict, got {type(value)}")

    def to_json(self) -> str:
        """Serialize the full solver spec to a JSON string.

        Lossless: composes the existing :meth:`repro.tune.TunedConfig` and
        :meth:`repro.adaptive.TSelection` round-trips plus the resolved
        :class:`~repro.adaptive.ReductionPolicy`, :class:`MachineParams`,
        and :class:`MethodConfig`, so a cached spec feeds straight back
        through :meth:`from_json` — fixed point asserted in the test suite.
        """
        import json

        return json.dumps(solverconfig_to_dict(self))

    @classmethod
    def from_json(cls, data) -> "SolverConfig":
        """Inverse of :meth:`to_json`; accepts the JSON string or the
        already-parsed dict."""
        import json

        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        return solverconfig_from_dict(data)


def solverconfig_to_dict(cfg: SolverConfig) -> dict:
    """JSON-safe dict form of a SolverConfig (see ``SolverConfig.to_json``)."""
    from repro_torch.tune.autotune import tunedconfig_to_dict

    machine = cfg.comm.machine
    policy = cfg.adaptive.policy
    select = cfg.adaptive.select
    tuned = cfg.tune.tuned
    return dict(
        t=cfg.t,
        tol=float(cfg.tol),
        max_iters=int(cfg.max_iters),
        comm=dict(
            strategy=cfg.comm.strategy,
            overlap=cfg.comm.overlap,
            col_split=cfg.comm.col_split,
            machine=None if machine is None else dataclasses.asdict(machine),
        ),
        kernel=dict(
            backend=cfg.kernel.backend,
            ell_block=list(cfg.kernel.ell_block),
        ),
        tune=dict(
            mode=cfg.tune.mode,
            tuned=None if tuned is None else tunedconfig_to_dict(tuned),
        ),
        adaptive=dict(
            policy=None if policy is None else dataclasses.asdict(policy),
            t_candidates=list(cfg.adaptive.t_candidates),
            select=None if select is None else _tselection_dict(select),
            probe_iters=int(cfg.adaptive.probe_iters),
            probe_rtol=float(cfg.adaptive.probe_rtol),
            explicit_off=bool(cfg.adaptive.explicit_off),
        ),
        method=dataclasses.asdict(cfg.method),
        precondition=_precondition_dict(cfg.precondition),
    )


def _precondition_dict(pc: PreconditionConfig) -> dict:
    d = dataclasses.asdict(pc)
    if d.get("eig_bounds") is not None:
        d["eig_bounds"] = list(d["eig_bounds"])  # JSON has no tuples
    return d


def _tselection_dict(select) -> dict:
    from repro_torch.adaptive.select_t import tselection_to_dict

    return tselection_to_dict(select)


def solverconfig_from_dict(d: dict) -> SolverConfig:
    """Inverse of :func:`solverconfig_to_dict`."""
    from repro_torch.adaptive.reduce import ReductionPolicy
    from repro_torch.adaptive.select_t import tselection_from_dict
    from repro_torch.core.machines import MachineParams
    from repro_torch.tune.autotune import tunedconfig_from_dict

    comm = dict(d["comm"])
    if comm.get("machine") is not None:
        comm["machine"] = MachineParams(**comm["machine"])
    kernel = dict(d["kernel"])
    kernel["ell_block"] = tuple(kernel["ell_block"])
    tune = dict(d["tune"])
    if tune.get("tuned") is not None:
        tune["tuned"] = tunedconfig_from_dict(tune["tuned"])
    adaptive = dict(d["adaptive"])
    if adaptive.get("policy") is not None:
        adaptive["policy"] = ReductionPolicy(**adaptive["policy"])
    if adaptive.get("select") is not None:
        adaptive["select"] = tselection_from_dict(adaptive["select"])
    adaptive["t_candidates"] = tuple(adaptive["t_candidates"])
    precondition = dict(d.get("precondition") or {})
    if precondition.get("eig_bounds") is not None:
        precondition["eig_bounds"] = tuple(precondition["eig_bounds"])
    return SolverConfig(
        t=d["t"],
        tol=d["tol"],
        max_iters=d["max_iters"],
        comm=CommConfig(**comm),
        kernel=KernelConfig(**kernel),
        tune=TuneConfig(**tune),
        adaptive=AdaptiveConfig(**adaptive),
        method=MethodConfig(**d["method"]),
        precondition=PreconditionConfig(**precondition),
    )
