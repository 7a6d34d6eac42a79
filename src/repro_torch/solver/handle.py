"""The build-once / solve-many ECG solver handle.

Port of ``repro/solver/handle.py``, sequential and distributed:

    from repro_torch.solver import ECGSolver, SolverConfig, KernelConfig
    from repro_torch.launch.mesh import VirtualMesh

    solver = ECGSolver.build(a, config=SolverConfig(
        t=8, tol=1e-8, kernel=KernelConfig(backend="pallas")), device="cuda")
    res = solver.solve(b)
    more = solver.solve_many(bs)

    dist = ECGSolver.build(a, VirtualMesh(2, 4), SolverConfig(
        t=8, comm=CommConfig(strategy="optimal"), kernel="pallas"))
    x = dist.unshard(dist.solve(b).x)

    # one rank per process (torch.distributed initialised, 8 processes)
    pg = ECGSolver.build(a, ProcessGroupMesh(2, 4), SolverConfig(
        t=8, comm=CommConfig(strategy="optimal"), kernel="pallas"))
    x = pg.unshard(pg.solve(b).x)   # every process calls it

    adaptive = ECGSolver.build(a, VirtualMesh(2, 4), SolverConfig(
        t=8, adaptive="reduce", comm=CommConfig(strategy="optimal"), kernel="pallas"))
    res = adaptive.solve(b)   # res.active_hist, res.comm_segments

``build`` moves the operator to ``device`` and, with ``backend="pallas"``,
converts it to Block-ELL once.  With a mesh it also partitions the rows,
builds the node-aware exchange plan and the per-rank operator
(:mod:`repro_torch.sparse.spmbv`), and the reductions: per-rank products,
each followed by one ``mesh.psum``.  The reference compiles its solve loop once
per width; PyTorch runs eagerly, so the handle instead caches one runner per
width and ``stats.traces`` counts runner constructions (flat across repeated
solves).

``SolverConfig(method="pipelined")`` and ``method="sstep"`` (with ``s`` and
``reorth``) run the other two iteration schemes on the same operator and
reductions; ``CommConfig(overlap=True)`` runs each distributed SpMBV as the
interior/boundary schedule (:mod:`repro_torch.sparse.spmbv`).

``SolverConfig(tune=TuneConfig(mode="model" | "model:structural" |
"measure"))`` (or a precomputed ``TunedConfig``) hands the strategy, the
Block-ELL tile and the overlap to the setup-time tuner
(:mod:`repro_torch.tune`): on a mesh all three, sequentially the tile alone
(``backend="pallas"``; ``"measure"`` needs a mesh).  ``SolverConfig(t="auto")``
picks the enlarging factor at build time (:mod:`repro_torch.adaptive.
select_t`) and runs the tuner's config for it; it implies the ``rankrev``
policy unless the policy is explicitly ``"off"``.

An adaptive policy (``SolverConfig(adaptive="rankrev" | "reduce" |
"reduce+restart")``) runs the rank-revealing factorization and the width
controller in every scheme.  On a mesh, a policy without restart
*segments* the solve: when the active width drops, the loop exits, the
exchange is re-sliced at the narrower width (``plan.at_width``, its own
``HaloExchange`` graph) and the solve resumes from the same carry;
``result.comm_segments`` lists (width, iterations) per segment.  A
sequential handle never segments.  Options whose machinery is not ported
yet raise ``NotImplementedError`` naming the ROADMAP.md item that brings
them.

On a :class:`~repro_torch.launch.mesh.ProcessGroupMesh` every process
builds the handle from the same global matrix and config and holds only
its own rank's rows; every reduction is one ``all_reduce``, so each
process reads the same residual norm, rank and active count and takes the
same branch.  ``solve`` takes the global ``b`` on every process and
``unshard`` gathers the global ``x`` on every process.  The overlap
schedule, ``tune`` mode ``"measure"``, ``t="auto"``, ``solve_packed`` and
the serving layer need every rank stacked on one device and raise
``NotImplementedError`` there (ROADMAP.md queue 1 item 5b, remainder)
before any device work.

:meth:`ECGSolver.solve_packed` solves k right-hand sides as ONE enlarged
block solve of width k·t, each request retiring against its own tolerance
(the serving layer's width packing, :mod:`repro_torch.serve`); on a mesh
each retirement re-slices the exchange at the live width.

A :class:`~repro_torch.observe.Tracer` (``build(..., tracer=)``, default
the process tracer, normally the free null tracer) records the reference's
spans and counters: ``build`` and its ``build/*`` phases, ``solve/*``,
``solve_many/*``, ``solve_packed/*``, ``solver.*``.  The reference's
``*/dispatch`` spans cover an asynchronous enqueue; the port's loop is
synchronous (one host copy per iteration), so its ``*/dispatch`` spans
cover the whole loop and ``*/finalize`` only the host-side result
assembly.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from repro_torch.adaptive.groups import GroupSpec
from repro_torch.adaptive.reduce import resolve_policy
from repro_torch.core.cg import SolveResult
from repro_torch.core.ecg import check_card_width, finalize_result, make_ecg_runner
from repro_torch.kernels.block_update.ops import ecg_tail
from repro_torch.kernels.bsr_spmbv.ops import block_ell_arrays, make_block_ell_apply_from_arrays
from repro_torch.kernels.chol_apply.ops import MAX_RANK_T
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.fused_gram.ops import fused_gram
from repro_torch.launch.mesh import PROCESS_MESH_ITEM, refuse_unstacked
from repro_torch.observe.tracer import coerce_tracer
from repro_torch.precondition import (
    build_distributed_preconditioner,
    build_sequential_preconditioner,
)
from repro_torch.solver.config import SolverConfig
from repro_torch.sparse.csr import csr_spmbv
from repro_torch.sparse.partition import partition_csr
from repro_torch.sparse.spmbv import _make_distributed_spmbv


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def check_process_mesh(mesh, cfg: SolverConfig) -> None:
    """Refuse, before any device work, the options that need every rank
    stacked on one device when ``mesh`` holds only some (a
    :class:`~repro_torch.launch.mesh.ProcessGroupMesh`)."""
    if cfg.comm.overlap:
        refuse_unstacked(mesh, "the overlap schedule (CommConfig(overlap=True))")
    if cfg.tune.mode == "measure":
        refuse_unstacked(mesh, 'tune mode "measure"')
    if isinstance(cfg.t, str):
        refuse_unstacked(mesh, 't="auto"')


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

    t:       the resolved enlarging factor (an int, even for ``t="auto"``).
    device:  the torch device every solve runs on.
    tuned:   the applied :class:`~repro_torch.tune.TunedConfig` (None untuned).
    selection: the :class:`~repro_torch.adaptive.TSelection` when ``t="auto"``.
    mesh:    the :class:`~repro_torch.launch.mesh.VirtualMesh` or
             :class:`~repro_torch.launch.mesh.ProcessGroupMesh` (None for a
             sequential handle).
    policy:  the resolved adaptive
             :class:`~repro_torch.adaptive.ReductionPolicy` (None = fixed
             width).
    op:      the :class:`~repro_torch.sparse.spmbv.DistributedSpMBV`
             operator (None for a sequential handle).
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
        b=None,
        pm=None,
        conversion=None,
        device=None,
        tracer=None,
    ) -> "ECGSolver":
        """Build a solver handle for matrix ``a``.

        a:          :class:`~repro_torch.sparse.csr.CSRMatrix` (SPD); it is
                    moved to ``device`` if it lies elsewhere.
        mesh:       a :class:`~repro_torch.launch.mesh.VirtualMesh` or
                    :class:`~repro_torch.launch.mesh.ProcessGroupMesh` for
                    the distributed node-aware solver, or None for the
                    sequential solver.
        config:     a :class:`SolverConfig` (or dict of its fields).
        b:          optional probe right-hand side for ``t="auto"`` (defaults
                    to a seeded Gaussian: the selection only needs a
                    representative right-hand side, but the real one
                    sharpens the probe).
        pm:         optional precomputed partition to reuse (distributed).
        conversion: optional CSR→Block-ELL artifacts to reuse (sequential
                    ``backend="pallas"`` only): a dict with ``"arrays"``
                    (a previous handle's ``conversion["arrays"]``, from this
                    package or the reference — numpy arrays are accepted;
                    skips the conversion) and/or ``"meta"`` (the tile
                    analysis from ``block_ell_meta``; skips the analysis).
                    Mismatched artifacts (tile, shape or dtype) are ignored.
                    With a mesh: a handle's ``conversion`` built on the same
                    partition (``pm=``), whose Block-ELL arrays are reused.
        device:     ``"cuda"`` (the default without a mesh; raises when CUDA
                    is missing) or ``"cpu"`` (the kernels' plain torch
                    versions).  With a mesh it defaults to, and must equal,
                    the mesh's device.
        tracer:     a :class:`repro_torch.observe.Tracer` to record the
                    build-phase and solve spans on (default: the process
                    tracer, normally the free null tracer).
        """
        if mesh is not None and not all(
            hasattr(mesh, m) for m in ("ppermute", "psum", "all_gather", "local_ranks", "ranks",
                                       "shape", "device", "capturable")
        ):
            _not_ported(
                f"a mesh of type {type(mesh).__name__}: the distributed solver runs on a "
                "repro_torch.launch.mesh.VirtualMesh or ProcessGroupMesh; any other mesh",
                PROCESS_MESH_ITEM,
            )
        self = cls.__new__(cls)
        if mesh is not None:
            self.device = mesh.device
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device!r} differs from the mesh's {mesh.device}")
        else:
            self.device = resolve_device("cuda" if device is None else device)
        self.config = cfg = SolverConfig.coerce(config)
        check_card_width(self.device, cfg.t, cfg.method.s, cfg.adaptive.t_candidates)
        check_process_mesh(mesh, cfg)
        self.a = a.to(self.device)
        self.mesh = mesh
        self._tracer = coerce_tracer(tracer)
        self.stats = SolverStats()
        self.selection = None
        self.tuned = None
        self.op = None
        self._pm = pm
        self._probe_b = b
        self._runners: dict = {}
        self._onehot_cache: dict = {}
        self._packed_applies: dict = {}
        self._conversion_in = conversion
        self.conversion = None
        with self._tracer.span("build", cat="build", n=int(a.shape[0]), nnz=int(a.nnz),
                               distributed=mesh is not None) as sp:
            self._build()
            sp.args["t"] = int(self.t)
        self._tracer.counter("solver.builds", self.stats.builds)
        return self

    def _auto_probe_b(self):
        if self._probe_b is not None:
            return self._probe_b
        return np.random.default_rng(0).standard_normal(self.a.shape[0])

    def _resolve_auto_t(self, adaptive, n_nodes=1, ppn=1, tune_mode="model", pm=None):
        """``t="auto"``: run (or reuse) the selection; returns ``(t,
        adaptive)`` and records ``self.selection``.  ``pm`` is the mesh's
        partition, which the selection's tuning reuses."""
        from repro_torch.adaptive.select_t import resolve_auto_t

        cfg = self.config
        with self._tracer.span("build/select_t", cat="build"):
            t, self.selection, adaptive = resolve_auto_t(
                "auto", adaptive, a=self.a, b=self._auto_probe_b(),
                select=cfg.adaptive.select, candidates=cfg.adaptive.t_candidates,
                tol=cfg.tol, machine=cfg.comm.machine, n_nodes=n_nodes, ppn=ppn,
                pm=pm, backend=cfg.kernel.backend, tune_mode=tune_mode,
                probe_iters=cfg.adaptive.probe_iters, probe_rtol=cfg.adaptive.probe_rtol,
                method=cfg.method.name, s=cfg.method.s, reorth=cfg.method.reorth,
            )
        return t, adaptive

    def _build(self):
        if self.device.type == "cuda":
            # float32 Gram products and TRSMs run in full float32, as the
            # reference's; this is torch's default, set here explicitly
            torch.backends.cuda.matmul.allow_tf32 = False
        self.stats.builds += 1
        self.selection = None
        self._gram1 = self._gram2 = self._sqnorm = self._tail = self._split_fn = None
        self._gram2p = self._sqnorm_cols = None
        if self.mesh is not None:
            self._build_distributed()
        else:
            self._build_sequential()
        self._precond = self._build_precond()

    def _build_sequential(self):
        cfg = self.config
        t = cfg.t
        adaptive = "off" if cfg.adaptive.explicit_off else cfg.adaptive.policy
        tuned = cfg.tune.tuned
        if cfg.tune.mode == "measure":
            raise ValueError(
                'tune mode "measure" times candidate operators on a device '
                "mesh; build the handle with mesh= (or use mode='model')"
            )
        if isinstance(t, str):  # "auto"
            t, adaptive = self._resolve_auto_t(adaptive)
            if tuned is None and cfg.kernel.backend == "pallas":
                # execute the tile the candidate costs were modeled with
                tuned = self.selection.configs.get(t)
        elif tuned is None and cfg.tune.active and cfg.kernel.backend == "pallas":
            from repro_torch.tune import tune as run_tune

            with self._tracer.span("build/tune", cat="build", mode=cfg.tune.mode):
                tuned = run_tune(
                    self.a, t=t, machine=cfg.comm.machine, n_nodes=1, ppn=1,
                    backend="pallas", mode=cfg.tune.mode,
                )
        self.tuned = tuned
        self.t = t
        self._set_policy(resolve_policy(adaptive))
        if cfg.kernel.backend == "pallas":
            with self._tracer.span("build/convert", cat="build") as sp:
                self._build_ell_apply(tuned.ell_block if tuned is not None else cfg.kernel.ell_block)
                sp.args.update(analyzed=self.stats.conv_analyzed, reused=self.stats.conv_reused)
        else:
            self._apply = lambda V: csr_spmbv(self.a, V)

    def _set_policy(self, policy):
        """The adaptive policy and whether solves run width-segmented: on a
        mesh, without restart (a restart re-enlarges, which a narrower
        exchange could not carry)."""
        self.policy = policy
        self._segmented = self.mesh is not None and policy is not None and not policy.restart

    def _build_distributed(self):
        cfg = self.config
        n_nodes, ppn = self.mesh.shape
        if self._pm is None:
            with self._tracer.span("build/partition", cat="build", p=self.mesh.p):
                self._pm = partition_csr(self.a, self.mesh.p)
        t = cfg.t
        adaptive = "off" if cfg.adaptive.explicit_off else cfg.adaptive.policy
        tune_arg = cfg.tune.tuned if cfg.tune.tuned is not None else cfg.tune.mode
        strategy, overlap = cfg.comm.strategy, cfg.comm.overlap
        ell_block = cfg.kernel.ell_block
        if isinstance(t, str):  # "auto"
            tune_mode = (
                cfg.tune.mode if cfg.tune.mode in ("model", "model:structural") else "model"
            )
            t, adaptive = self._resolve_auto_t(adaptive, n_nodes, ppn, tune_mode, self._pm)
            if not cfg.tune.active:
                # execute the exact config the choice was modeled with — a t
                # optimized for one (strategy, tile, overlap) but run under
                # another would make the selection meaningless.  Explicit
                # comm/kernel settings are overridden (warn when that
                # discards a non-default request).
                tcfg = self.selection.configs.get(t)
                if tcfg is not None:
                    if strategy != "standard" or overlap or ell_block != (8, 8):
                        warnings.warn(
                            "t='auto' executes the tuner config its choice was "
                            f"modeled with ({tcfg.strategy}/{tcfg.ell_block}/"
                            f"{'overlap' if tcfg.overlap else 'blocking'}); the "
                            f"explicit strategy={strategy!r}/overlap={overlap}/"
                            f"ell_block={ell_block} settings are ignored — pass "
                            "a fixed t to force them",
                            stacklevel=4,
                        )
                    tune_arg = tcfg
        # a sibling from with_config that changed only the exchange reuses
        # its parent's Block-ELL arrays: they depend on the partition alone
        # (an untuned build only: a tuned one picks its own tile)
        parent = self._conversion_in or {}
        ell = None
        if (tune_arg == "off" and parent.get("ell_block") == ell_block
                and cfg.kernel.backend == "pallas"):
            ell = parent.get("ell")
        # one span for plan construction + tuning + Block-ELL conversion:
        # _make_distributed_spmbv owns those phases, and the span's
        # structural attributes (wire bytes, packed dispatch count) are the
        # accounting every later solve span inherits
        with self._tracer.span("build/operator", cat="build", strategy=strategy,
                               t=int(t)) as sp:
            self.op = _make_distributed_spmbv(
                self.a, self.mesh, strategy, t=t,
                machine=cfg.comm.machine, pm=self._pm, backend=cfg.kernel.backend,
                overlap=overlap, ell_block=ell_block, tune=tune_arg,
                col_split=cfg.comm.col_split, ell=ell,
            )
            f = self.a.data.element_size()
            sp.args.update(
                wire_bytes=int(self.op.plan.wire_bytes(f)),
                dispatch_count=int(self.op.plan.dispatch_count(packed=True)),
                tuned_strategy=self.op.tuned.strategy if self.op.tuned else strategy,
            )
        self.stats.conv_reused = ell is not None
        if self.selection is not None and self.op.tuned is not None:
            self.op.tuned = dataclasses.replace(self.op.tuned, selection=self.selection)
        self.tuned = self.op.tuned
        if self.op.ell:
            applied = self.tuned.ell_block if self.tuned is not None else ell_block
            self.conversion = dict(ell=self.op.ell, ell_block=applied)
        self.t = t
        self._set_policy(resolve_policy(adaptive))
        self._apply = self.op.matvec_fn()
        with self._tracer.span("build/reducers", cat="build"):
            self._build_reducers()

    def _build_reducers(self):
        """The §3.1 reductions on the mesh — each a per-rank product followed
        by one ``mesh.psum`` — and the padded-layout T_{r,t} splitting."""
        op, mesh = self.op, self.mesh
        p, rmax = mesh.local_ranks, op.rmax

        def ranked(m):  # (p·rmax, t) padded layout -> (p, rmax, t) view
            return m.reshape(p, rmax, -1)

        # gram1 and gram2p are plain products, left to XLA by the reference:
        # batched.  A (p, t, rmax)·(p, rmax, t) batch gets one cuBLAS CTA per
        # rank (1.19 ms at Example 2.1's full scale on the H100, PERF.md), so
        # each rank's rows are split into chunks, summed in a fixed order after
        chunks = math.gcd(rmax, 64)

        def local_product(u, v):  # (p·rmax, a), (p·rmax, b) -> (p, a, b) per-rank uᵀv
            a_, b_ = u.shape[-1], v.shape[-1]
            uc = u.reshape(p * chunks, rmax // chunks, a_)
            vc = v.reshape(p * chunks, rmax // chunks, b_)
            return torch.bmm(uc.mT, vc).reshape(p, chunks, a_, b_).sum(dim=1)

        self._gram1 = lambda z, az: mesh.psum(local_product(z, az))
        # the preconditioned packed reduction [PᵀR | APᵀW | AP_oldᵀW]: three
        # per-rank products, one psum
        self._gram2p = lambda pp, rr, ap, apo, w: mesh.psum(torch.cat(
            [local_product(pp, rr), local_product(ap, w), local_product(apo, w)], dim=-1
        ))
        if self.config.kernel.backend == "pallas":
            # one fused_gram launch yields the p local (t, 3t) payloads
            self._gram2 = lambda pp, rr, ap, apo: mesh.psum(
                fused_gram(ranked(pp), ranked(rr), ranked(ap), ranked(apo))
            )
            # row-wise with replicated (t, t) coefficients: one launch on
            # the stacked (p·rmax, t) rows
            self._tail = ecg_tail
        else:
            def gram2(pp, rr, ap, apo):
                pp, rr, ap, apo = (ranked(m) for m in (pp, rr, ap, apo))
                return mesh.psum(torch.cat([pp.mT @ rr, ap.mT @ ap, apo.mT @ ap], dim=-1))

            self._gram2 = gram2
        self._sqnorm = lambda v: mesh.psum(torch.linalg.vecdot(v.reshape(p, rmax), v.reshape(p, rmax)))
        # per-column squared norms for packed multi-RHS solves: one psum of
        # g floats that REPLACES the scalar sqnorm reduction in group mode
        self._sqnorm_cols = lambda m: mesh.psum(torch.sum(ranked(m * m), dim=1))

        # T_{r,t} on the padded layout: subdomains follow *true* global row
        # ids, so the splitting matches the sequential solver exactly
        t = self.t
        true_rows = op.true_row_of_slot()
        sub = np.where(true_rows >= 0, (true_rows * t) // op.n, 0)
        onehot = np.zeros((op.n_padded, t))
        onehot[np.arange(op.n_padded), np.minimum(sub, t - 1)] = (true_rows >= 0).astype(float)
        self._onehot_np = onehot
        self._split_fn = lambda r, t_: r[:, None] * self._onehot(r.dtype)

    def _build_precond(self):
        """Build the preconditioner apply for this handle's operator
        (None when ``config.precondition`` is inactive)."""
        cfg = self.config
        if not cfg.precondition.active:
            return None
        if self.mesh is None:
            return build_sequential_preconditioner(self.a, cfg.precondition, self._apply)
        return build_distributed_preconditioner(
            self.a, cfg.precondition, self.op, self.mesh, self._apply
        )

    def _onehot(self, dtype) -> torch.Tensor:
        """Device-resident T_{r,t} one-hot for ``dtype`` (cached)."""
        hit = self._onehot_cache.get(dtype)
        if hit is None:
            hit = torch.as_tensor(self._onehot_np, dtype=dtype, device=self.device)
            self._onehot_cache[dtype] = hit
        return hit

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
        """The runner of the segment at exchange width ``width`` (the solve
        at ``self.t`` when the handle does not segment)."""
        runner = self._runners.get(width)
        if runner is None:
            cfg = self.config
            masked = exit_bw = None
            if self._segmented:
                # the full-width segment still carries the active mask (so the
                # loop can exit on a reduction event); narrower segments
                # compact the exchange's payload
                masked = (
                    (lambda z, act: self._apply(z)) if width == self.t
                    else self.op.masked_matvec_fn(width)
                )
                exit_bw = width
            runner = make_ecg_runner(
                self._apply, self.t, tol=cfg.tol, max_iters=cfg.max_iters,
                split=self._split_fn, gram1=self._gram1, gram2=self._gram2,
                sqnorm=self._sqnorm, tail=self._tail,
                backend=cfg.kernel.backend, method=cfg.method.name,
                precond=self._precond, gram2p=self._gram2p,
                precond_reseed=(
                    cfg.precondition.reseed if cfg.precondition.kind == "inexact" else None
                ),
                policy=self.policy, a_apply_masked=masked, exit_below_width=exit_bw,
                s=cfg.method.s, reorth=cfg.method.reorth, rank_rtol=cfg.method.rank_rtol,
            )
            self.stats.traces += 1
            self._runners[width] = runner
        return runner

    # -------------------------------------------------------------- solving
    def _device_vec(self, v, dtype=None) -> torch.Tensor:
        if self.op is not None:
            return self.op.shard_vector(v, dtype)
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return v.to(device=self.device, dtype=dtype)

    def _operands(self, b, x0):
        """``b`` and ``x0`` on the device (the mesh's layout on a mesh), in
        the promoted dtype of the operator and ``b``."""
        b_dev = self._device_vec(b)
        b_dev = b_dev.to(torch.promote_types(b_dev.dtype, self.a.data.dtype))
        x0_dev = torch.zeros_like(b_dev) if x0 is None else self._device_vec(x0, b_dev.dtype)
        return b_dev, x0_dev

    def _struct_attrs(self, width: int) -> dict:
        """Structural accounting of one solve segment at active ``width``
        — the attributes that make a trace self-describing (plan wire bytes
        at the re-sliced width, packed dispatch count, the scheme's psums
        per iteration).  Called only when tracing is enabled."""
        from repro_torch.core.methods import get_method

        cfg = self.config
        spec = get_method(cfg.method.name)
        attrs = dict(psums_per_iter=float(
            spec.collectives_per_iteration(cfg.method.s, cfg.method.reorth)
        ))
        if self.op is not None:
            f = self.a.data.element_size()
            plan_w = self.op.plan.at_width(width)
            attrs.update(
                wire_bytes=int(plan_w.wire_bytes(f)),
                dispatch_count=int(plan_w.dispatch_count(packed=True)),
            )
        return attrs

    def _emit_solve_telemetry(self, result):
        """Counters and per-iteration event markers for one finished solve,
        read off the host histories (only when the tracer is enabled)."""
        tr = self._tracer
        if not tr.enabled:
            return
        tr.counter("solver.solves", self.stats.solves)
        tr.counter("solver.traces", self.stats.traces)
        for k, before, after in result.reduction_events():
            tr.instant("solve/width_change", k=k, before=before, after=after)
        for k in result.recovery_events():
            tr.instant("solve/recovery", k=k)
        for k in result.reseed_events():
            tr.instant("solve/reseed", k=k)

    def _result(self, carry, x0_dev, segments=None):
        result = finalize_result(carry, x0=x0_dev, t=self.t, tol=self.config.tol,
                                 policy=self.policy, selection=self.selection)
        result.comm_segments = segments
        return result

    def solve(self, b, x0=None):
        """Solve A x = b; returns a :class:`~repro_torch.core.cg.SolveResult`.

        ``b``/``x0`` are global (n,) vectors (numpy or torch).  The solve
        runs in the promoted dtype of the operator and ``b``; ``res.x`` and
        ``res.res_hist`` are tensors on the handle's device.  On a
        distributed handle ``b``/``x0`` are laid out onto the mesh here and
        ``res.x`` is in the padded per-rank layout — use :meth:`unshard` for
        the global vector.
        """
        cfg = self.config
        b_dev, x0_dev = self._operands(b, x0)
        tr = self._tracer
        if not self._segmented:
            with tr.span("solve/dispatch", cat="solve", width=self.t) as spd:
                runner = self._runner(self.t)
                carry = runner.run(runner.init(b_dev, x0_dev))
            with tr.span("solve/finalize", cat="solve") as spf:
                result = self._result(carry, x0_dev)
                spf.args.update(iters=result.n_iters, converged=bool(result.converged))
            if tr.enabled:
                # one segment span covering the loop through the result: the
                # unsegmented solve's (width, iters, wall)
                tr.emit("solve/segment", spd.t0, spf.t0 + spf.dur - spd.t0, cat="solve",
                        width=self.t, iters=result.n_iters, **self._struct_attrs(self.t))
        else:
            # Width-segmented solve: each segment runs the loop with the
            # exchange compacted to its width; when the controller retires
            # directions the loop exits, the exchange is re-sliced at the new
            # width and the solve resumes from the same carry.
            t_seg, carry, k_prev, segments = self.t, None, 0, []
            while True:
                with tr.span("solve/segment", cat="solve", width=t_seg) as sp:
                    runner = self._runner(t_seg)
                    carry = runner.run(runner.init(b_dev, x0_dev) if carry is None else carry)
                    k = carry["k"]
                    it_seg = k - k_prev
                    sp.args["iters"] = it_seg
                    if tr.enabled:
                        sp.args.update(self._struct_attrs(t_seg))
                segments.append((t_seg, it_seg))
                k_prev = k
                n_act = int(carry["ahist"][k])
                if (
                    carry["rn"] <= cfg.tol
                    or carry["bd"]
                    or k >= cfg.max_iters
                    or n_act >= t_seg
                    # every direction dead (a rank-0 Gram without a non-finite
                    # iterate) or a zero-progress segment: nothing a narrower
                    # re-slice could fix
                    or n_act == 0
                    or it_seg == 0
                ):
                    break
                t_seg = n_act  # width-reduction event -> re-slice
            with tr.span("solve/finalize", cat="solve"):
                result = self._result(carry, x0_dev, segments)
        self.stats.solves += 1
        self._emit_solve_telemetry(result)
        return result

    def solve_many(self, bs, x0s=None):
        """Solve the same operator against many right-hand sides.

        Every solve reuses the cached runner; results are exactly what
        per-RHS :meth:`solve` calls return.  The reference enqueues all
        solves before the first host sync; the port's loop syncs once per
        iteration, so the solves run one after another inside the
        ``solve_many/dispatch`` span.
        """
        x0s = [None] * len(bs) if x0s is None else list(x0s)
        if len(x0s) != len(bs):
            raise ValueError(f"got {len(bs)} rhs but {len(x0s)} initial guesses")
        if self._segmented:
            # width-segmented solves sync the host between segments anyway
            return [self.solve(b, x0) for b, x0 in zip(bs, x0s)]
        tr = self._tracer
        outs = []
        with tr.span("solve_many/dispatch", cat="solve", requests=len(bs), width=self.t):
            runner = self._runner(self.t)
            for b, x0 in zip(bs, x0s):
                b_dev, x0_dev = self._operands(b, x0)
                outs.append((runner.run(runner.init(b_dev, x0_dev)), x0_dev))
                self.stats.solves += 1
        with tr.span("solve_many/finalize", cat="solve", requests=len(bs)):
            results = [self._result(carry, x0_dev) for carry, x0_dev in outs]
        if tr.enabled:
            tr.counter("solver.solves", self.stats.solves)
            tr.counter("solver.traces", self.stats.traces)
        return results

    # ------------------------------------------------------- packed solving
    def _packed_apply(self, width: int):
        """Full-width SpMBV of a packed solve on a mesh (the plan re-sliced
        at ``width``)."""
        fn = self._packed_applies.get(width)
        if fn is None:
            fn = self._packed_applies[width] = self.op.matvec_fn(t_active=width)
        return fn

    def _packed_runner(self, spec: GroupSpec, width_seg: int):
        """The runner of a packed solve's segment at exchange width
        ``width_seg`` (sequentially always the pack's full width)."""
        key = ("pack", spec, width_seg)
        runner = self._runners.get(key)
        if runner is None:
            cfg = self.config
            width = spec.width
            masked = exit_bw = None
            if self.mesh is None:
                apply_w = self._apply  # the width-polymorphic sequential apply
            else:
                apply_w = self._packed_apply(width)
                # group retirement drives the compacted exchange even under
                # a policy that never reduces: the full-width segment carries
                # the live mask so the loop can exit at a retirement,
                # narrower segments compact the payload
                masked = (
                    (lambda z, act: apply_w(z)) if width_seg == width
                    else self.op.masked_matvec_fn(width_seg)
                )
                exit_bw = width_seg
            runner = make_ecg_runner(
                apply_w, width, tol=cfg.tol, max_iters=cfg.max_iters,
                split=self._split_fn, gram1=self._gram1, gram2=self._gram2,
                sqnorm=self._sqnorm, tail=self._tail,
                backend=cfg.kernel.backend, method=cfg.method.name,
                precond=self._precond, gram2p=self._gram2p,
                precond_reseed=(
                    cfg.precondition.reseed if cfg.precondition.kind == "inexact" else None
                ),
                policy=self.policy, a_apply_masked=masked, exit_below_width=exit_bw,
                s=cfg.method.s, reorth=cfg.method.reorth, rank_rtol=cfg.method.rank_rtol,
                groups=spec, sqnorm_cols=self._sqnorm_cols,
            )
            self.stats.traces += 1
            self._runners[key] = runner
        return runner

    def _check_pack(self, spec: GroupSpec) -> None:
        """On the card, a pack must fit the kernels it runs: every kernel,
        ``rank_apply`` and ``drop_mask`` among them, takes at most
        ``MAX_RANK_T`` columns.  Raised before any device work; a wider pack
        never falls back to the plain versions."""
        if self.device.type == "cuda" and spec.width > MAX_RANK_T:
            raise NotImplementedError(
                f"a pack of width {spec.width} ({spec.n_groups} requests × t={spec.t_each}) "
                f"exceeds the {MAX_RANK_T} columns rank_apply and the other kernels take on "
                f"the card; lower max_pack_width to {MAX_RANK_T}"
            )

    def _device_block(self, vs, dtype=None) -> torch.Tensor:
        """Global (n,) vectors stacked as the columns of an (n, k) block on
        the device (the mesh's layout on a mesh)."""
        cols = [v.to(self.device) if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.array(v), device=self.device) for v in vs]
        return self._device_vec(torch.stack(cols, dim=1), dtype)

    def solve_packed(self, bs, x0s=None, tols=None):
        """Solve k right-hand sides as ONE enlarged block solve of width
        ``k·t``, each request retiring against its own tolerance.

        Request j owns the contiguous column slab ``[j·t, (j+1)·t)`` of the
        packed solve; all k requests share every halo exchange and both Gram
        reductions per iteration.  When a request's per-group residual norm
        reaches its tolerance its R slab is zero-retired and its solution
        freezes, and the pack restarts from the live requests' residuals at
        t columns per live request (where the reference drops directions
        and stalls, :mod:`repro_torch.core.methods.classic`); on a
        distributed handle the exchange is re-sliced at the shrunken live
        width (``ExchangePlan.at_width``) so late finishers stop paying
        early finishers' bytes: each retirement exits the segment, and the
        solve resumes from the same carry.

        ``tols`` is one absolute residual-norm tolerance per request (None
        entries inherit ``config.tol``).  Results are NOT bit-identical to
        solo :meth:`solve` calls (the shared search space couples the
        iterates), so each :class:`~repro_torch.core.cg.SolveResult` carries
        its own residual history and iteration count and a ``pack`` dict
        (group layout, retirement iteration, total packed iterations).
        Requires ``method="classic"`` and a rank-revealing policy without
        restart.  On the card a pack wider than the kernels take raises
        ``NotImplementedError`` before any device work.  The loop is
        synchronous, so the ``solve_packed/dispatch`` span covers it.
        """
        cfg = self.config
        refuse_unstacked(self.mesh, "solve_packed")
        if len(bs) == 0:
            raise ValueError("solve_packed needs at least one right-hand side")
        if cfg.method.name != "classic":
            raise ValueError(
                f"solve_packed requires method 'classic', got {cfg.method.name!r}"
            )
        if self.policy is None:
            raise ValueError(
                "solve_packed requires a rank-revealing policy (build with "
                "adaptive='rankrev' at minimum): retirement makes the Gram "
                "matrix structurally singular, which the pivoted "
                "factorization absorbs as zero-masked columns"
            )
        if self.policy.restart:
            raise ValueError(
                "solve_packed cannot run a restart policy (re-enlarging would "
                "mix request boundaries); use adaptive='rankrev' or 'reduce'"
            )
        x0s = [None] * len(bs) if x0s is None else list(x0s)
        tols = [None] * len(bs) if tols is None else list(tols)
        if len(x0s) != len(bs) or len(tols) != len(bs):
            raise ValueError(
                f"got {len(bs)} rhs but {len(x0s)} guesses / {len(tols)} tols"
            )
        spec = GroupSpec(
            t_each=self.t,
            tols=tuple(cfg.tol if tt is None else float(tt) for tt in tols),
        )
        self._check_pack(spec)
        g = spec.n_groups
        b_dev = self._device_block(bs)
        b_dev = b_dev.to(torch.promote_types(b_dev.dtype, self.a.data.dtype))
        x0_dev = self._device_block(
            [torch.zeros(self.a.shape[0], dtype=b_dev.dtype) if x0 is None else x0 for x0 in x0s],
            b_dev.dtype,
        )
        tr = self._tracer
        segments = None
        if self.mesh is None:
            with tr.span("solve_packed/dispatch", cat="solve", width=spec.width, groups=g):
                runner = self._packed_runner(spec, spec.width)
                carry = runner.run(runner.init(b_dev, x0_dev))
        else:
            # width-segmented packed solve: each retirement (or policy
            # reduction) event exits the loop, the exchange re-slices at the
            # live width, and the solve resumes from the same carry
            t_seg, carry, k_prev, segments = spec.width, None, 0, []
            while True:
                with tr.span("solve/segment", cat="solve", width=t_seg, packed=True,
                             groups=g) as sp:
                    runner = self._packed_runner(spec, t_seg)
                    carry = runner.run(runner.init(b_dev, x0_dev) if carry is None else carry)
                    k = carry["k"]
                    it_seg = k - k_prev
                    sp.args["iters"] = it_seg
                    if tr.enabled:
                        sp.args.update(self._struct_attrs(t_seg))
                segments.append((t_seg, it_seg))
                k_prev = k
                n_act = int(carry["ahist"][k])
                if (
                    not (carry["grp_iter"] < 0).any()
                    or carry["bd"]
                    or k >= cfg.max_iters
                    or n_act >= t_seg
                    or n_act == 0
                ):
                    break
                new_w = max(n_act, 1)
                if it_seg == 0 and new_w == t_seg:
                    break  # zero-progress segment at a stable width
                # retirement (or reduction) event -> re-slice; a pack whose
                # groups arrive at their tolerance (x0) exits its first
                # segment after zero iterations and re-slices straight to
                # the initial live width
                t_seg = new_w
        self.stats.solves += g
        with tr.span("solve_packed/finalize", cat="solve", groups=g):
            results = self._finalize_packed(carry, x0_dev, spec, segments)
        if tr.enabled:
            tr.counter("solver.solves", self.stats.solves)
        return results

    def _finalize_packed(self, out, x0_dev, spec: GroupSpec, segments):
        """Split one packed loop carry into k per-request results (x and
        ``res_hist`` stay tensors on the device; a history is NaN past its
        request's retirement)."""
        te, g = spec.t_each, spec.n_groups
        big_x = out["X"]
        xs = x0_dev + big_x.reshape(big_x.shape[0], g, te).sum(dim=2)
        k_total, bd = out["k"], bool(out["bd"])
        results = []
        for j in range(g):
            it = int(out["grp_iter"][j])
            retired = it >= 0
            nit = it if retired else k_total
            hist_j = out["grp_hist"][:, j].clone()
            hist_j[nit + 1:] = float("nan")  # frozen past retirement -> NaN padding
            results.append(SolveResult(
                x=xs[:, j],
                n_iters=nit,
                res_hist=hist_j,
                converged=retired,
                breakdown=bd and not retired,
                t=te,
                selection=self.selection,
                comm_segments=segments,
                pack=dict(
                    width=spec.width,
                    t_each=te,
                    n_groups=g,
                    group=j,
                    tol=spec.tols[j],
                    retired_iter=it if retired else None,
                    packed_iters=k_total,
                ),
            ))
        return results

    def unshard(self, arr) -> np.ndarray:
        """Padded per-rank layout -> global (n, ...) numpy array (a host
        copy for a sequential handle, which has no padded layout)."""
        if self.op is not None:
            return self.op.unshard(arr)
        if isinstance(arr, torch.Tensor):
            return arr.detach().cpu().numpy()
        return np.asarray(arr)

    @property
    def partition(self):
        """The row partition this handle was built on — pass it back to
        ``ECGSolver.build(..., pm=)`` to share the partitioning cost across
        handles of the same matrix (None for a sequential handle)."""
        return self._pm

    # ----------------------------------------------------------- derivation
    def with_config(self, **overrides) -> "ECGSolver":
        """Derive a sibling handle with config overrides, reusing as much
        setup as the overrides permit.

        Solve-level overrides (``tol``, ``max_iters``, ``method``, the
        adaptive policy) reuse the operator, the tuning and the ``t="auto"``
        selection outright; operator-level overrides (strategy, backend,
        tile, overlap, tune, t) rebuild it, reusing the parent's partition
        and, where they still match, its conversion artifacts.  Under
        ``t="auto"`` a change of the adaptive knobs, the tolerance or the
        method re-runs the selection (each enters its ranking).  The
        preconditioner is reused with the operator unless the precondition
        knobs changed, which rebuild it alone.  Accepts the flat field
        spellings of :meth:`SolverConfig.replace`.
        """
        new_cfg = self.config.replace(**overrides)
        check_card_width(self.device, new_cfg.t, new_cfg.method.s, new_cfg.adaptive.t_candidates)
        check_process_mesh(self.mesh, new_cfg)
        clone = ECGSolver.__new__(ECGSolver)
        clone.a, clone.config = self.a, new_cfg
        clone.device, clone.mesh = self.device, self.mesh
        clone._tracer = self._tracer
        clone.stats = SolverStats()
        clone.selection = None
        clone.tuned = None
        clone.op = None
        clone._pm = self._pm
        clone._probe_b = self._probe_b
        clone._runners = {}
        clone._onehot_cache = {}
        clone._packed_applies = {}
        clone._conversion_in = self.conversion
        clone.conversion = None
        reuse_op = (
            new_cfg.t == self.config.t
            and new_cfg.comm == self.config.comm
            and new_cfg.kernel == self.config.kernel
            and new_cfg.tune == self.config.tune
            # a t="auto" resolution is derived from the adaptive knobs, the
            # tolerance and the method (each enters its ranking): changing
            # any of them must re-run the selection.  A method change under
            # a fixed t reuses the operator outright.
            and (
                not isinstance(self.config.t, str)
                or (
                    new_cfg.adaptive == self.config.adaptive
                    and new_cfg.tol == self.config.tol
                    and new_cfg.method == self.config.method
                )
            )
        )
        if reuse_op:
            # the SpMBV and the reductions do not depend on the scheme: a
            # method change reuses the operator; only the runners differ
            clone.t = self.t
            clone.tuned = self.tuned
            clone.selection = self.selection
            if new_cfg.adaptive == self.config.adaptive:
                policy = self.policy  # keeps auto-t's implied rankrev
            else:
                policy = new_cfg.adaptive.policy
                if policy is None and clone.selection is not None and not new_cfg.adaptive.explicit_off:
                    policy = resolve_policy("rankrev")  # auto-t implies breakdown safety
            clone._set_policy(policy)
            clone.op = self.op
            clone._apply = self._apply
            clone._gram1, clone._gram2 = self._gram1, self._gram2
            clone._sqnorm, clone._tail = self._sqnorm, self._tail
            clone._gram2p = self._gram2p
            clone._sqnorm_cols = self._sqnorm_cols
            clone._split_fn = self._split_fn
            if self.mesh is not None:
                clone._onehot_np = self._onehot_np
                clone._onehot_cache = self._onehot_cache
            clone.conversion = self.conversion
            clone.stats.op_reused = True
            # the preconditioner depends only on (a, op, precondition cfg)
            if new_cfg.precondition == self.config.precondition:
                clone._precond = self._precond
            else:
                clone._precond = clone._build_precond()
        else:
            clone._build()
        clone.stats.partition_reused = self.mesh is not None
        return clone
