"""Automatic enlarging-factor selection (``t="auto"``).

The paper's central trade-off — more search directions buy fewer iterations
at a higher per-iteration cost — is closed here at setup time:

    total_cost(t)  =  iters(t) · T_iter(t)

* **iters(t)** — an iterations-to-convergence model.  ``mode="probe"``
  calibrates it from a few real ECG iterations per candidate (geometric fit
  of the observed residual decay); ``mode="kappa"`` uses the CG bound
  ``½·√(κ/t)·ln(2·r₀/tol)`` with a power-iteration condition estimate —
  no solver probes, but cruder.
* **T_iter(t)** — composed from :mod:`repro_torch.tune`'s per-iteration cost
  models: the tuner's best (strategy × tile × overlap) SpMBV time at this t,
  the §3.1 collective model (t² + 3t² floats), and the γ-weighted local
  flops of eq. (3.3) minus the SpMBV term the tuner already covers.
  ``tune_mode`` selects the tuner's exchange model — pass
  ``"model:structural"`` on host/TPU backends so strategy ranking follows
  the executor-structural cost (plan dispatches + moved bytes).

Post-reduction byte savings: the probes run with the adaptive controller,
so when a candidate's splitting loses directions mid-probe (rank drops or
stagnation), the *observed average active width* discounts that candidate's
exchange-byte term — the width-aware executor really will move fewer bytes
after the reduction, and the ranking accounts for it.

``select_t`` ranks the candidate widths and returns a :class:`TSelection`;
the solver handle accepts ``t="auto"`` and records the selection on
``SolveResult.selection`` (and ``TunedConfig.selection`` for the tuned
distributed path).

Port of ``repro/adaptive/select_t.py``: the same models, the same probe
(one :meth:`~repro_torch.core.ecg.ECGRunner.step` at a time under the
controller, with the same early stop) and the same JSON.  Departures in
form: vectors are torch tensors on the matrix's device (the probe's
right-hand side is moved there); :func:`estimate_condition` takes that
``device``; and :func:`select_t` partitions the matrix once (when no
``pm`` is given) and hands the partition to every candidate's tuning, so
the tuner's per-partition caches (tile statistics, interior fractions)
serve every candidate t — the reference partitions anew per candidate,
with the same result.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# NOTE: repro_torch.core.ecg / repro_torch.tune are imported lazily inside the
# functions below — core.ecg imports repro_torch.adaptive for the
# rank-revealing path, so a module-level import here would be circular.

#: Candidate enlarging factors ranked by default.
DEFAULT_CANDIDATES = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class TSelection:
    """Result of automatic t selection.

    table maps each candidate t to
    ``{"rate", "est_iters", "iter_cost_s", "total_cost_s"}`` —
    the calibrated per-iteration residual decay, the modeled iterations to
    ``tol``, the modeled per-iteration seconds, and their product.
    """

    t: int
    candidates: tuple
    table: dict
    tol: float
    mode: str          # "probe" | "kappa"
    probe_iters: int = 0
    configs: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)
    # iterations each candidate's probe actually ran before the fitted rate
    # stabilized (early stop) — {t: iters}; empty for mode="kappa"
    probe_iters_used: dict = dataclasses.field(default_factory=dict)

    @property
    def total_cost(self) -> float:
        return self.table[self.t]["total_cost_s"]

    def to_json(self) -> str:
        """Serialize to a JSON string; lossless round trip via
        :meth:`from_json` (used to cache selections on disk next to
        :meth:`repro_torch.tune.TunedConfig.to_json`)."""
        import json

        return json.dumps(tselection_to_dict(self))

    @classmethod
    def from_json(cls, data) -> "TSelection":
        """Inverse of :meth:`to_json`; accepts the JSON string or the
        already-parsed dict."""
        import json

        if isinstance(data, (str, bytes)):
            data = json.loads(data)
        return tselection_from_dict(data)

    def summary(self) -> str:
        lines = [f"t=auto[{self.mode}] -> t={self.t} (tol={self.tol:g})"]
        for t in self.candidates:
            row = self.table[t]
            mark = " <-- chosen" if t == self.t else ""
            act = row.get("avg_active", t)
            red = f" act~{act:.1f}" if act < t else ""
            used = self.probe_iters_used.get(t)
            probed = (
                f" probe={used}/{self.probe_iters}"
                if used is not None and used < self.probe_iters else ""
            )
            lines.append(
                f"  t={t:>2}: rate={row['rate']:.4f} iters~{row['est_iters']:>5} "
                f"iter={row['iter_cost_s']*1e6:8.1f}us "
                f"total={row['total_cost_s']*1e3:8.2f}ms{red}{probed}{mark}"
            )
        return "\n".join(lines)


def tselection_to_dict(sel: "TSelection") -> dict:
    """JSON-safe dict form of a TSelection (int keys stringified)."""
    from repro_torch.tune.autotune import tunedconfig_to_dict

    return dict(
        t=sel.t,
        candidates=list(sel.candidates),
        table={str(t): dict(row) for t, row in sel.table.items()},
        tol=sel.tol,
        mode=sel.mode,
        probe_iters=sel.probe_iters,
        probe_iters_used={str(t): int(v) for t, v in sel.probe_iters_used.items()},
        configs={str(t): tunedconfig_to_dict(cfg) for t, cfg in sel.configs.items()},
    )


def tselection_from_dict(d: dict) -> "TSelection":
    """Inverse of :func:`tselection_to_dict` (int keys restored)."""
    from repro_torch.tune.autotune import tunedconfig_from_dict

    return TSelection(
        t=int(d["t"]),
        candidates=tuple(int(t) for t in d["candidates"]),
        table={int(t): dict(row) for t, row in d["table"].items()},
        tol=float(d["tol"]),
        mode=str(d["mode"]),
        probe_iters=int(d.get("probe_iters", 0)),
        probe_iters_used={
            int(t): int(v) for t, v in d.get("probe_iters_used", {}).items()
        },
        configs={
            int(t): tunedconfig_from_dict(cfg)
            for t, cfg in d.get("configs", {}).items()
        },
    )


# ------------------------------------------------------- iterations models
def _fit_rate(hist) -> tuple[float | None, np.ndarray]:
    """Geometric per-iteration decay fit over the finite positive prefix of a
    residual history; (None, h) when fewer than two usable points exist."""
    h = np.asarray(hist, dtype=np.float64)
    h = h[np.isfinite(h)]
    h = h[h > 0.0]
    if len(h) < 2:
        return None, h
    return float((h[-1] / h[0]) ** (1.0 / (len(h) - 1))), h


def probe_decay_rate(
    a_apply,
    b,
    t: int,
    probe_iters: int = 8,
    mapping: str = "contiguous",
    adaptive: object = "rankrev",
    rtol: float = 0.01,
    min_iters: int = 4,
) -> tuple[float, float, float, int]:
    """Run up to ``probe_iters`` real ECG iterations at width t and fit a
    geometric per-iteration residual decay rate ρ; returns
    (ρ, r₀ norm, avg active width observed, iterations actually run).

    The probe drives the :class:`~repro_torch.core.ecg.ECGRunner` one iteration at
    a time and **stops early** once the fitted rate has stabilized: after at
    least ``min_iters`` iterations, when the fit over k iterations agrees
    with the fit over k−1 within relative tolerance ``rtol``, the remaining
    probe budget is skipped (``rtol=0`` disables early stopping).  The
    number of iterations actually run is recorded as ``probe_iters_used``
    on the :class:`TSelection`.

    The probe runs with the adaptive controller (default ``"rankrev"``) so a
    rank-deficient splitting (e.g. t exceeding the number of nonzero
    subdomains) degrades gracefully instead of poisoning the calibration
    with NaNs — and so the observed reduction trace can discount the
    exchange-byte cost of candidates that will not sustain the full width.
    """
    from repro_torch.adaptive.reduce import resolve_policy
    from repro_torch.core.ecg import make_ecg_runner
    from repro_torch.core.enlarging import split_residual

    # the probe always needs a controller: "off"/None would leave the active
    # trace unset and a deficient splitting would NaN the fit
    policy = resolve_policy("rankrev" if adaptive in (None, "off") else adaptive)
    runner = make_ecg_runner(
        a_apply, t, tol=0.0, max_iters=probe_iters,
        split=lambda r_, t_: split_residual(r_, t_, mapping), policy=policy,
    )
    # the carry's residual norm is a host float, so each step syncs once:
    # the per-iteration host sync is inherent to the early-stop decision
    carry = runner.init(b, torch.zeros_like(b))
    used = 0
    rho = prev_rho = None
    if not carry["bd"]:
        for k in range(probe_iters):
            new = runner.step(carry)
            if not math.isfinite(new["rn"]):
                break  # breakdown: keep the last finite iterate's history
            carry = new
            used = k + 1
            rho, _ = _fit_rate(_host(carry["hist"][: used + 1]))
            if float(carry["rn"]) <= 0.0:
                break  # converged exactly inside the probe
            if (
                rtol > 0.0
                and used >= min_iters
                and rho is not None
                and prev_rho is not None
                and abs(rho / prev_rho - 1.0) <= rtol
            ):
                break  # fitted rate stabilized — skip the rest of the budget
            prev_rho = rho
    ah = np.asarray(carry["ahist"][: used + 1])
    ah = ah[ah >= 0]
    avg_active = float(ah.mean()) if len(ah) else float(t)
    rho, h = _fit_rate(_host(carry["hist"][: used + 1]))
    if rho is None:
        # converged (or broke down) inside the first probe iteration
        return 1e-8, float(h[0]) if len(h) else 0.0, avg_active, used
    return float(np.clip(rho, 1e-8, 1.0 - 1e-12)), float(h[0]), avg_active, used


def estimate_condition(a_apply, n: int, iters: int = 50, seed: int = 0,
                       device="cpu") -> float:
    """Power-iteration estimate of κ(A) for SPD A (λmax, then λmax of
    λmax·I − A for λmin).  A coarse but probe-free calibration input.
    The iteration vectors are float64 tensors on ``device``."""
    rng = np.random.default_rng(seed)

    def lam_max(apply_fn):
        v = torch.as_tensor(rng.standard_normal(n), device=device)
        v = v / torch.linalg.norm(v)
        lam = 1.0
        for _ in range(iters):
            w = apply_fn(v)
            lam = float(torch.dot(v, w))
            nw = torch.linalg.norm(w)
            v = w / torch.clamp(nw, min=1e-300)
        return max(lam, 0.0)

    a_vec = lambda v: a_apply(v[:, None])[:, 0]
    lmax = lam_max(a_vec)
    if lmax == 0.0:
        return 1.0
    lmin = lmax - lam_max(lambda v: lmax * v - a_vec(v))
    return lmax / max(lmin, lmax * 1e-14)


def iters_from_condition(kappa: float, t: int, tol_ratio: float) -> float:
    """CG bound ½·√κ_eff·ln(2/tol_ratio) with the enlarged effective
    condition κ_eff ≈ κ/t (the paper's Fig 3.2 regime: iteration count
    shrinks roughly like √t)."""
    tol_ratio = min(max(tol_ratio, 1e-300), 1.0)
    return 0.5 * math.sqrt(kappa / max(t, 1)) * math.log(2.0 / tol_ratio) + 1.0


# ------------------------------------------------------ per-iteration cost
def iteration_cost(
    a,
    t: int,
    machine=None,
    n_nodes: int = 1,
    ppn: int = 1,
    pm=None,
    backend: str = "jnp",
    tune_mode: str = "model",
    method: str = "classic",
    s: int = 1,
    reorth: bool = False,
):
    """Modeled seconds for one *effective* ECG iteration at width t: the
    tuner's best SpMBV config + the scheme's synchronization term
    (:func:`repro_torch.tune.method_sync_cost` — for ``method="classic"`` exactly
    the §3.1 collective model) + γ·(local non-SpMBV flops).

    ``tune_mode`` selects the tuner's exchange model (``"model"`` analytic
    max-rate, ``"model:structural"`` plan dispatches + moved bytes);
    ``method``/``s``/``reorth`` select the iteration scheme whose collective
    and local-work accounting is charged (classic is the default and
    reproduces the original cost exactly).

    Returns ``(seconds, TunedConfig)`` — the config is the same object
    :func:`repro_torch.sparse.spmbv.make_distributed_spmbv` (``tune=cfg``)
    would apply, so a ``t="auto"``
    choice and the executed plan can never drift apart.
    """
    from repro_torch.core.ecg import ECGOperationCounts
    from repro_torch.tune import tune as run_tune
    from repro_torch.tune.autotune import _method_local_flops, method_sync_cost

    cfg = run_tune(
        a, t=t, machine=machine, n_nodes=n_nodes, ppn=ppn,
        pm=pm, backend=backend, mode=tune_mode,
    )
    machine = cfg.machine
    p = n_nodes * ppn
    spmbv = cfg.predicted["best"]
    counts = ECGOperationCounts(n=a.shape[0], nnz=a.nnz, p=p, t=t)
    local_flops = _method_local_flops(method, counts, s=s, reorth=reorth)
    collective = (
        method_sync_cost(
            method, t, p, machine, s=s, reorth=reorth, t_spmbv_window=spmbv
        )
        if p > 1
        else 0.0
    )
    return spmbv + machine.gamma * local_flops + collective, cfg


def _reduced_p2p(cfg, t: int, avg_active: float) -> float:
    """Exchange cost discounted to the probe-observed average active width.

    The width-aware executor moves ``avg_active/t`` of the full-width bytes
    after reduction events, so a candidate whose splitting cannot sustain
    its width should not be charged full-width exchange bytes.  With the
    structural model the byte and dispatch terms are separated exactly
    (``predicted["plan_stats"]``); with the analytic model the whole p2p
    term is scaled — its byte terms are linear in t, so this is first-order.
    """
    machine = cfg.machine
    frac = min(max(avg_active / max(t, 1), 0.0), 1.0)
    stats = cfg.predicted.get("plan_stats")
    if stats is not None and cfg.strategy in stats:
        st = stats[cfg.strategy]
        disp = st["dispatches"] * machine.dispatch_overhead
        return disp + frac * (
            st["wire_bytes"] / machine.R_b + st["local_bytes"] / machine.R_bl
        )
    return cfg.predicted["p2p"][cfg.strategy] * frac


# --------------------------------------------------------------- selection
def select_t(
    a,
    b=None,
    candidates=DEFAULT_CANDIDATES,
    tol: float = 1e-8,
    machine=None,
    n_nodes: int = 1,
    ppn: int = 1,
    pm=None,
    backend: str = "jnp",
    mode: str = "probe",
    probe_iters: int = 8,
    mapping: str = "contiguous",
    a_apply=None,
    tune_mode: str = "model",
    adaptive: object = "rankrev",
    probe_rtol: float = 0.01,
    method: str = "classic",
    s: int = 1,
    reorth: bool = False,
) -> TSelection:
    """Rank candidate enlarging factors and pick the modeled-cheapest one.

    a:        CSRMatrix (drives the tuner's cost model and default probes).
    b:        right-hand side — required for ``mode="probe"``.
    mode:     "probe" calibrates iters(t) from up to ``probe_iters`` real ECG
              iterations per candidate; "kappa" from a condition estimate.
    a_apply:  optional SpMBV override for the probes (defaults to the
              sequential CSR product — the iteration *count* does not depend
              on the execution backend, only on the math).
    tune_mode: exchange model for the per-iteration cost ("model" analytic,
              "model:structural" executor-structural).
    adaptive: controller the probes run with; when the probe observes a
              reduced average active width, the candidate's exchange-byte
              cost is discounted to it (see :func:`_reduced_p2p`).
    probe_rtol: early-stop tolerance of the probes — a candidate's probe
              stops as soon as its fitted decay rate is stable within this
              relative tolerance (0 disables; the iterations actually run
              are recorded in ``TSelection.probe_iters_used``).
    method/s/reorth: the iteration scheme whose per-effective-iteration cost
              is charged (see :mod:`repro_torch.core.methods`).  The probes always
              run the classic scheme — all three schemes walk the same
              enlarged Krylov space, so the calibrated decay rate carries
              over to first order while the probe stays cheap.
    """
    from repro_torch.sparse.csr import csr_spmbv
    from repro_torch.sparse.partition import partition_csr

    n = a.shape[0]
    cands = sorted({int(t) for t in candidates if 1 <= int(t) <= n})
    if not cands:
        raise ValueError(f"no valid candidates in {candidates!r} for n={n}")
    if mode not in ("probe", "kappa"):
        raise ValueError(f"unknown selection mode {mode!r}")
    if mode == "probe" and b is None:
        raise ValueError('select_t(mode="probe") needs the right-hand side b')
    if a_apply is None:
        a_apply = lambda v: csr_spmbv(a, v)
    if b is not None:
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
        b = b.to(device=a.device, dtype=torch.promote_types(b.dtype, a.data.dtype))
    # one partition for every candidate's tuning (see the module docstring)
    pm = pm or partition_csr(a, n_nodes * ppn)

    if mode == "kappa":
        kappa = estimate_condition(a_apply, n, device=a.device)
        rn0 = float(torch.linalg.norm(b)) if b is not None else 1.0

    table, configs, iters_used = {}, {}, {}
    best_t, best_cost = cands[0], math.inf
    for t in cands:
        if mode == "probe":
            rate, rn0, avg_active, used = probe_decay_rate(
                a_apply, b, t, probe_iters=probe_iters,
                mapping=mapping, adaptive=adaptive, rtol=probe_rtol,
            )
            iters_used[t] = used
            est = _iters_to_tol(rate, rn0, tol, n)
        else:
            avg_active = float(t)
            rate = math.exp(-1.0 / max(iters_from_condition(kappa, t, 1.0 / math.e), 1.0))
            est = min(int(math.ceil(iters_from_condition(kappa, t, tol / max(rn0, tol)))), n)
        cost, cfg = iteration_cost(
            a, t, machine=machine, n_nodes=n_nodes, ppn=ppn, pm=pm,
            backend=backend, tune_mode=tune_mode,
            method=method, s=s, reorth=reorth,
        )
        if avg_active < t and n_nodes * ppn > 1 and not cfg.overlap:
            # post-reduction byte savings: the width-aware exchange moves
            # avg_active/t of the full-width bytes once directions retire
            # (blocking schedules only — an overlapped exchange is already
            # hidden behind interior compute, so there is nothing to save)
            full_p2p = cfg.predicted["p2p"][cfg.strategy]
            cost = cost - full_p2p + _reduced_p2p(cfg, t, avg_active)
        total = est * cost
        table[t] = dict(
            rate=rate, est_iters=est, iter_cost_s=cost, total_cost_s=total,
            avg_active=avg_active,
        )
        configs[t] = cfg
        if total < best_cost:
            best_t, best_cost = t, total
    return TSelection(
        t=best_t, candidates=tuple(cands), table=table, tol=tol, mode=mode,
        probe_iters=probe_iters if mode == "probe" else 0, configs=configs,
        probe_iters_used=iters_used,
    )


def resolve_auto_t(
    t: str,
    adaptive,
    *,
    a=None,
    b=None,
    select: TSelection | None = None,
    candidates=DEFAULT_CANDIDATES,
    tol: float = 1e-8,
    machine=None,
    n_nodes: int = 1,
    ppn: int = 1,
    pm=None,
    backend: str = "jnp",
    tune_mode: str = "model",
    probe_iters: int = 8,
    probe_rtol: float = 0.01,
    method: str = "classic",
    s: int = 1,
    reorth: bool = False,
):
    """Shared ``t="auto"`` resolution for the solvers.

    Validates the string, runs :func:`select_t` unless a precomputed
    ``select`` is supplied (probes run with the requested ``adaptive``
    controller so reduction-aware byte savings enter the ranking), and
    defaults ``adaptive`` to ``"rankrev"`` (an explicit ``"off"`` is
    honored) — one implementation so the sequential and distributed solvers
    cannot drift apart.  Returns ``(t, selection, adaptive)``.  ``pm`` (a
    partition of ``a`` over ``n_nodes·ppn`` ranks) is handed to
    :func:`select_t`.
    """
    if t != "auto":
        raise ValueError(f"t must be an int or 'auto', got {t!r}")
    if select is None:
        if a is None:
            raise ValueError(
                "t='auto' needs matrix= (the CSRMatrix behind a_apply) "
                "or select= (a precomputed TSelection)"
            )
        probe_adaptive = "rankrev" if adaptive in (None, "off") else adaptive
        select = select_t(
            a, b, candidates=candidates, tol=tol, machine=machine,
            n_nodes=n_nodes, ppn=ppn, pm=pm, backend=backend,
            tune_mode=tune_mode, adaptive=probe_adaptive,
            probe_iters=probe_iters, probe_rtol=probe_rtol,
            method=method, s=s, reorth=reorth,
        )
    if adaptive is None:
        adaptive = "rankrev"  # auto-t implies breakdown safety
    return int(select.t), select, adaptive


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _iters_to_tol(rate: float, rn0: float, tol: float, n: int) -> int:
    """Iterations for rn0·rateᵏ ≤ tol, clipped to [1, n] (CG terminates in at
    most n exact-arithmetic steps; the enlarged method in fewer)."""
    if rn0 <= tol or rn0 == 0.0:
        return 1
    k = math.log(tol / rn0) / math.log(rate)
    return int(min(max(math.ceil(k), 1), n))
