"""Setup-time autotuner for the distributed ECG hot path (port of
``repro.tune``).

The paper's thesis (§4.3) is that the right point-to-point strategy is
*predictable from a byte model*; this package extends that discipline to all
three t-dependent execution knobs of :mod:`repro_torch.sparse.spmbv`:

* exchange strategy in {standard, 2step, 3step, optimal} — Table-1 message
  statistics + the §4.3 max-rate models (:mod:`repro_torch.core.models`);
* Block-ELL tile shape (br, bc) and the per-tile budget ``kmax`` — a
  zero-fill/alignment cost model over the matrix's block-structure histogram;
* blocking vs overlapped execution — the comm-hiding model
  ``max(T_interior, T_exchange) + T_boundary`` vs ``T_exchange + T_local``.

``tune(..., mode="model")`` evaluates the models only (pure host work, no
devices); ``mode="model:structural"`` swaps the exchange term for the
executor-structural model — each strategy's plan charged
``dispatches × overhead + moved bytes``; ``mode="measure"`` calibrates with
setup-time microbenchmarks on a mesh (:mod:`repro_torch.tune.microbench`).
All return a :class:`~repro_torch.tune.autotune.TunedConfig` that
``SolverConfig(tune=cfg)`` and ``_make_distributed_spmbv(..., tune=cfg)``
apply verbatim.  Without a ``machine`` the models use the H100's measured
parameters (:data:`repro_torch.core.machines.H100`).

The enlarging factor itself is tuned one level up:
:mod:`repro_torch.adaptive.select_t` composes this package's per-iteration
cost model with an iterations-to-convergence model to rank candidate t at
setup (``t="auto"``); the chosen :class:`TSelection` is recorded on
``TunedConfig.selection``.
"""

from repro_torch.tune.autotune import (
    DEFAULT_TILES,
    TileStats,
    TunedConfig,
    method_sync_cost,
    predict_config,
    rank_methods,
    structural_exchange_cost,
    structural_exchange_costs,
    tile_stats,
    tile_time,
    tune,
    tunedconfig_from_dict,
    tunedconfig_to_dict,
)
from repro_torch.tune.microbench import (
    measure_config,
    measure_dispatch_overhead,
    tune_measured,
)

__all__ = [
    "DEFAULT_TILES",
    "TileStats",
    "TunedConfig",
    "predict_config",
    "structural_exchange_cost",
    "structural_exchange_costs",
    "method_sync_cost",
    "rank_methods",
    "tile_stats",
    "tile_time",
    "tune",
    "tunedconfig_from_dict",
    "tunedconfig_to_dict",
    "measure_config",
    "measure_dispatch_overhead",
    "tune_measured",
]
