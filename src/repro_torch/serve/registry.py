"""Operator registry: build each ECGSolver session exactly once.

Port of ``repro/serve/registry.py``.  The registry is the serving layer's
answer to the paper's §4 premise — setup cost (partitioning, exchange
planning, tuning, Block-ELL conversion) is paid once per *operator*, then
amortized across every request that names it.  Operators are keyed by
content fingerprint (:func:`~repro_torch.serve.fingerprint_csr`), so
clients never hold handles: re-sending the same CSR (even with rows
assembled in a different entry order) lands on the already-built session.
The fingerprint is computed at every lookup, as the reference does; on a
CSR on the card that includes a host copy of its arrays.

Eviction is LRU under a byte budget counted in CSR bytes
(:func:`~repro_torch.serve.operator_nbytes`); the most recently used entry
always survives, even when it alone exceeds the budget — a server must
never evict the session it is about to solve with.

Every build consults the :class:`~repro_torch.serve.cache.WarmStartCache` (when
configured): a hit feeds the persisted ``TunedConfig``/``TSelection``
back through ``SolverConfig.replace(tuned=..., select=...)``, so the
rebuilt session skips its convergence probes and tuner evaluation — a
restarted server re-tunes **zero** operators; a miss stores this build's
outcome for the next restart.

Sequential builds with ``backend="pallas"`` also produce CSR→Block-ELL
conversion artifacts (``ECGSolver.conversion["arrays"]``).  The registry
keeps those *device tensors* in a small in-memory side table that survives
LRU eviction of the session itself — a re-admitted evicted operator
rebuilds with **zero re-conversions** (``conv_reused``) — and persists the
JSON tile-analysis *meta* in the warm-start cache, so even a restarted
process skips the analysis pass (``conv_analyzed=False``).  A distributed
build's artifacts (the per-rank Block-ELL arrays) are not harvested, as
the reference harvests none.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

from repro_torch.launch.mesh import refuse_unstacked
from repro_torch.observe.tracer import coerce_tracer
from repro_torch.serve.cache import WarmStartCache, config_digest, mesh_tag
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.fingerprint import fingerprint_csr, operator_nbytes


@dataclasses.dataclass
class _Entry:
    solver: object
    nbytes: int


class OperatorRegistry:
    """Fingerprint-keyed LRU of built :class:`~repro_torch.solver.ECGSolver`
    sessions (see module docstring).

    Counters: ``hits`` / ``misses`` (lookups vs builds), ``evictions``,
    and per-build records ``build_records`` — dicts with the fingerprint,
    whether the warm-start cache answered (``warm``), and the build wall
    time (``build_s``, the cold-vs-warm latency the benchmark reports).
    """

    #: cap of the in-memory conversion-array side table — device tensors of
    #: the Block-ELL layout are a few× the CSR bytes, so the table is kept
    #: small and LRU'd independently of the session registry
    _CONV_CAP = 64

    def __init__(self, config: ServeConfig | None = None, mesh=None,
                 tracer=None, device=None):
        # the server's batches and packs stack every rank on one device
        refuse_unstacked(mesh, "the serving layer")
        self.config = ServeConfig.coerce(config)
        self.mesh = mesh
        # every session is built on this device (the mesh's with a mesh;
        # "cuda" by default, as ECGSolver.build)
        self.device = device
        self._tracer = coerce_tracer(tracer)
        self._entries: OrderedDict[str, _Entry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.build_records: list[dict] = []
        self._conv_arrays: OrderedDict[str, dict] = OrderedDict()
        self._cache = (
            WarmStartCache(self.config.cache_dir)
            if self.config.cache_dir is not None else None
        )
        self._cfg_digest = config_digest(self.config.solver)
        self._mesh_tag = mesh_tag(mesh)

    # ------------------------------------------------------------- lookup
    def fingerprint(self, a) -> str:
        return fingerprint_csr(a)

    def get(self, a, fingerprint: str | None = None):
        """Return ``(fingerprint, solver)`` for operator ``a``, building
        (and possibly evicting) on a miss."""
        key = fingerprint if fingerprint is not None else fingerprint_csr(a)
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._tracer.counter("registry.hits", self.hits,
                                 fingerprint=key[:12])
            self._entries.move_to_end(key)
            return key, entry.solver
        self.misses += 1
        self._tracer.counter("registry.misses", self.misses,
                             fingerprint=key[:12])
        solver, warm, build_s = self._build(a, key)
        self._entries[key] = _Entry(solver=solver, nbytes=operator_nbytes(a))
        self.build_records.append(dict(
            fingerprint=key, warm=warm, build_s=build_s,
            n=int(a.shape[0]), t=int(solver.t),
            conv_analyzed=bool(solver.stats.conv_analyzed),
            conv_reused=bool(solver.stats.conv_reused),
        ))
        self._evict()
        return key, solver

    # ------------------------------------------------------------- builds
    def _build(self, a, key: str):
        from repro_torch.solver import ECGSolver

        cfg = self.config.solver
        warm = False
        conv_meta = None
        if self._cache is not None:
            warm, tuned, select, conv_meta = self._cache.load(
                key, self._cfg_digest, self._mesh_tag
            )
            overrides = {}
            if tuned is not None:
                overrides["tuned"] = tuned
            if select is not None:
                overrides["select"] = select
            if overrides:
                cfg = cfg.replace(**overrides)
        conversion = None
        conv_arrays = self._conv_arrays.get(key)
        if conv_arrays is not None or conv_meta is not None:
            conversion = dict(arrays=conv_arrays, meta=conv_meta)
        # build_s keeps its own perf_counter timing (the cold-vs-warm
        # latency the stats report); the tracer gets the same interval as
        # a serve/build span — nested build-phase spans come from the
        # solver's own instrumentation
        with self._tracer.span("serve/build", cat="serve",
                               fingerprint=key[:12], warm=warm):
            t0 = time.perf_counter()
            solver = ECGSolver.build(a, self.mesh, cfg,
                                     conversion=conversion,
                                     tracer=self._tracer, device=self.device)
            build_s = time.perf_counter() - t0
        self._tracer.counter(
            "registry.builds", len(self.build_records) + 1, warm=warm
        )
        self._harvest_conversion(key, solver, warm, conv_meta)
        if self._cache is not None and not warm:
            self._cache.store(
                key, self._cfg_digest, self._mesh_tag,
                solver.tuned, solver.selection,
                conversion=self._solver_conv_meta(solver),
            )
        return solver, warm, build_s

    @staticmethod
    def _solver_conv_meta(solver):
        conv = solver.conversion
        return None if conv is None or "arrays" not in conv else conv["meta"]

    def _harvest_conversion(self, key: str, solver, warm: bool, conv_meta):
        """Remember a build's Block-ELL artifacts: device arrays in the
        in-memory side table (survives session eviction), tile meta in the
        warm-start cache (survives restarts — stored as an in-place upgrade
        when a pre-conversion warm entry lacked it)."""
        if self._solver_conv_meta(solver) is None:
            return
        self._conv_arrays[key] = solver.conversion["arrays"]
        self._conv_arrays.move_to_end(key)
        while len(self._conv_arrays) > self._CONV_CAP:
            self._conv_arrays.popitem(last=False)
        if self._cache is not None and warm and conv_meta is None:
            self._cache.store(
                key, self._cfg_digest, self._mesh_tag,
                solver.tuned, solver.selection,
                conversion=solver.conversion["meta"],
            )

    # ----------------------------------------------------------- eviction
    def _evict(self):
        budget = self.config.registry_bytes
        while len(self._entries) > 1 and self.total_bytes > budget:
            self._entries.popitem(last=False)  # oldest-used first
            self.evictions += 1

    # -------------------------------------------------------------- state
    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._entries

    def fingerprints(self) -> list[str]:
        """Resident fingerprints, least- to most-recently used."""
        return list(self._entries)

    def stats(self) -> dict:
        """JSON-safe counter snapshot (composes the per-session
        :class:`~repro_torch.solver.handle.SolverStats` of every resident
        solver)."""
        return dict(
            hits=self.hits, misses=self.misses, evictions=self.evictions,
            resident=len(self._entries), resident_bytes=self.total_bytes,
            builds=[dict(r) for r in self.build_records],
            warm_builds=sum(1 for r in self.build_records if r["warm"]),
            cold_builds=sum(1 for r in self.build_records if not r["warm"]),
            conv_analyzed=sum(
                1 for r in self.build_records if r.get("conv_analyzed")
            ),
            conv_reused=sum(
                1 for r in self.build_records if r.get("conv_reused")
            ),
            conv_resident=len(self._conv_arrays),
            solver_traces={
                f: e.solver.stats.traces for f, e in self._entries.items()
            },
            solver_solves={
                f: e.solver.stats.solves for f, e in self._entries.items()
            },
        )
