"""The build-once / solve-many ECG solver handle (sequential path).

Port of ``repro/solver/handle.py`` for ``mesh=None``:

    from repro_torch.solver import ECGSolver, SolverConfig, KernelConfig

    solver = ECGSolver.build(a, config=SolverConfig(
        t=8, tol=1e-8, kernel=KernelConfig(backend="pallas")), device="cuda")
    res = solver.solve(b)
    more = solver.solve_many(bs)

``build`` moves the operator to ``device`` and, with ``backend="pallas"``,
converts it to Block-ELL once.  The reference compiles its solve loop once
per width; PyTorch runs eagerly, so the handle instead caches one runner per
width and ``stats.traces`` counts runner constructions (flat across repeated
solves).  Options whose machinery is not ported yet raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ecg import finalize_result, make_ecg_runner
from repro_torch.kernels.bsr_spmbv.ops import block_ell_arrays, make_block_ell_apply_from_arrays
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.solver.config import SolverConfig
from repro_torch.sparse.csr import csr_spmbv


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def _dtype_name(dtype: torch.dtype) -> str:
    """torch.float64 -> "float64" (numpy's spelling, as the reference stores)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class SolverStats:
    """Build/runner accounting of one handle (reuse made observable)."""

    builds: int = 0            # operator constructions this handle paid
    traces: int = 0            # solve-loop runner constructions; flat across reuse
    solves: int = 0            # solve() calls served
    partition_reused: bool = False  # with_config reused the parent partition
    op_reused: bool = False         # with_config reused the parent operator
    conv_analyzed: bool = False     # this build ran the CSR→Block-ELL tile analysis
    conv_reused: bool = False       # this build skipped conversion entirely
    #                                 (precomputed Block-ELL arrays supplied)


class ECGSolver:
    """Build-once / solve-many ECG solver handle (see module docstring).

    Attributes after ``build``:

    t:       the enlarging factor.
    device:  the torch device every solve runs on.
    stats:   :class:`SolverStats`.
    """

    def __init__(self, *args, **kwargs):
        raise TypeError("use ECGSolver.build(a, mesh=None, config=..., device=...)")

    # ------------------------------------------------------------- building
    @classmethod
    def build(
        cls,
        a,
        mesh=None,
        config: SolverConfig | dict | None = None,
        *,
        conversion=None,
        device="cuda",
    ) -> "ECGSolver":
        """Build a solver handle for matrix ``a``.

        a:          :class:`~repro_torch.sparse.csr.CSRMatrix` (SPD); it is
                    moved to ``device`` if it lies elsewhere.
        mesh:       must be None (the distributed solver is not ported yet).
        config:     a :class:`SolverConfig` (or dict of its fields).
        conversion: optional CSR→Block-ELL artifacts to reuse
                    (``backend="pallas"`` only): a dict with ``"arrays"``
                    (a previous handle's ``conversion["arrays"]``, from this
                    package or the reference — numpy arrays are accepted;
                    skips the conversion) and/or ``"meta"`` (the tile
                    analysis from ``block_ell_meta``; skips the analysis).
                    Mismatched artifacts (tile, shape or dtype) are ignored.
        device:     ``"cuda"`` (default; raises when CUDA is missing) or
                    ``"cpu"`` (the kernels' plain torch versions).
        """
        if mesh is not None:
            _not_ported("the distributed solver (mesh=)", "queue 1 item 5")
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.a = a.to(self.device)
        self.config = SolverConfig.coerce(config)
        self.stats = SolverStats()
        self._runners: dict = {}
        self._conversion_in = conversion
        self.conversion = None
        self._build_sequential()
        return self

    def _build_sequential(self):
        cfg = self.config
        if isinstance(cfg.t, str):
            _not_ported('t="auto"', "queue 1 item 6")
        if cfg.tune.active:
            _not_ported(f"tuning (tune mode {cfg.tune.mode!r})", "queue 1 item 9")
        if cfg.adaptive.policy is not None:
            _not_ported("an adaptive policy", "queue 1 item 6")
        if cfg.precondition.active:
            _not_ported(f"preconditioning ({cfg.precondition.kind!r})", "queue 1 item 8")
        if cfg.method.name != "classic":
            _not_ported(f"method {cfg.method.name!r}", "queue 1 item 7")
        if self.device.type == "cuda":
            # float32 Gram products and TRSMs run in full float32, as the
            # reference's; this is torch's default, set here explicitly
            torch.backends.cuda.matmul.allow_tf32 = False
        self.stats.builds += 1
        self.t = cfg.t
        if cfg.kernel.backend == "pallas":
            self._build_ell_apply(cfg.kernel.ell_block)
        else:
            self._apply = lambda V: csr_spmbv(self.a, V)

    def _build_ell_apply(self, ell_block):
        """Sequential Block-ELL apply, reusing supplied conversion artifacts.

        Priority: precomputed arrays (skip conversion outright) > tile
        analysis meta (skip the analysis pass) > full conversion.  The
        artifacts are published on ``self.conversion``.
        """
        br, bc = ell_block
        conv_in = self._conversion_in or {}
        reuse = conv_in.get("arrays")
        dtype = _dtype_name(self.a.data.dtype)
        if reuse is not None and not (
            reuse.get("br") == br
            and reuse.get("bc") == bc
            and tuple(reuse.get("shape", ())) == tuple(self.a.shape)
            and reuse.get("dtype") == dtype
        ):
            reuse = None  # stale artifacts (tile/shape/dtype changed): ignore
        if reuse is not None:
            # the reference's artifacts hold jax arrays or numpy copies of them
            blocks, indices = (
                (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))).to(self.device)
                for x in (reuse["blocks"], reuse["indices"])
            )
            indices = indices.to(torch.int32)
            m_pad = int(reuse["m_pad"])
            meta = reuse.get("meta")
            self.stats.conv_reused = True
        else:
            blocks, indices, m_pad, meta, analyzed = block_ell_arrays(
                self.a, br, bc, meta=conv_in.get("meta")
            )
            self.stats.conv_analyzed = analyzed
        self._apply = make_block_ell_apply_from_arrays(blocks, indices, self.a.shape[0])
        self.conversion = dict(
            arrays=dict(
                blocks=blocks, indices=indices, m_pad=m_pad,
                br=br, bc=bc, shape=tuple(self.a.shape), dtype=dtype,
                meta=meta,
            ),
            meta=meta,
        )

    # ------------------------------------------------------------- runners
    def _runner(self, width: int):
        runner = self._runners.get(width)
        if runner is None:
            cfg = self.config
            runner = make_ecg_runner(
                self._apply, width, tol=cfg.tol, max_iters=cfg.max_iters,
                backend=cfg.kernel.backend, method=cfg.method.name,
            )
            self.stats.traces += 1
            self._runners[width] = runner
        return runner

    # -------------------------------------------------------------- solving
    def _device_vec(self, v, dtype=None) -> torch.Tensor:
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return v.to(device=self.device, dtype=dtype)

    def solve(self, b, x0=None):
        """Solve A x = b; returns a :class:`~repro_torch.core.cg.SolveResult`.

        ``b``/``x0`` are (n,) vectors (numpy or torch).  The solve runs in
        the promoted dtype of the operator and ``b``; ``res.x`` and
        ``res.res_hist`` are tensors on the handle's device.
        """
        cfg = self.config
        b_dev = self._device_vec(b)
        b_dev = b_dev.to(torch.promote_types(b_dev.dtype, self.a.data.dtype))
        x0_dev = torch.zeros_like(b_dev) if x0 is None else self._device_vec(x0, b_dev.dtype)
        runner = self._runner(self.t)
        out = runner.run(runner.init(b_dev, x0_dev))
        self.stats.solves += 1
        return finalize_result(out, x0=x0_dev, t=self.t, tol=cfg.tol)

    def solve_many(self, bs, x0s=None):
        """Solve the same operator against many right-hand sides.

        Every solve reuses the cached runner; results are exactly what
        per-RHS :meth:`solve` calls return.
        """
        x0s = [None] * len(bs) if x0s is None else list(x0s)
        if len(x0s) != len(bs):
            raise ValueError(f"got {len(bs)} rhs but {len(x0s)} initial guesses")
        return [self.solve(b, x0) for b, x0 in zip(bs, x0s)]

    def solve_packed(self, bs, x0s=None, tols=None):
        """Width-packed multi-RHS solve — not ported yet."""
        _not_ported("solve_packed", "queue 1 item 10")

    def unshard(self, arr) -> np.ndarray:
        """Global (n, ...) numpy array of a solve output (a sequential handle
        has no padded layout, so this is a host copy)."""
        if isinstance(arr, torch.Tensor):
            return arr.detach().cpu().numpy()
        return np.asarray(arr)

    # ----------------------------------------------------------- derivation
    def with_config(self, **overrides) -> "ECGSolver":
        """Derive a sibling handle with config overrides, reusing as much
        setup as the overrides permit.

        Solve-level overrides (``tol``, ``max_iters``, ``method``) reuse the
        operator outright; operator-level overrides (backend, tile, t, ...)
        rebuild it, reusing the parent's conversion artifacts where they
        still match.  Accepts the flat field spellings of
        :meth:`SolverConfig.replace`.
        """
        new_cfg = self.config.replace(**overrides)
        clone = ECGSolver.__new__(ECGSolver)
        clone.a, clone.config = self.a, new_cfg
        clone.device = self.device
        clone.stats = SolverStats()
        clone._runners = {}
        clone._conversion_in = self.conversion
        clone.conversion = None
        reuse_op = (
            new_cfg.t == self.config.t
            and new_cfg.comm == self.config.comm
            and new_cfg.kernel == self.config.kernel
            and new_cfg.tune == self.config.tune
            and new_cfg.adaptive == self.config.adaptive
            and new_cfg.precondition == self.config.precondition
        )
        if reuse_op:
            if new_cfg.method.name != "classic":
                _not_ported(f"method {new_cfg.method.name!r}", "queue 1 item 7")
            clone.t = self.t
            clone._apply = self._apply
            clone.conversion = self.conversion
            clone.stats.op_reused = True
        else:
            clone._build_sequential()
        return clone
