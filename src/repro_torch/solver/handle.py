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
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.ecg import finalize_result, make_ecg_runner
from repro_torch.kernels.block_update.ops import ecg_tail
from repro_torch.kernels.bsr_spmbv.ops import block_ell_arrays, make_block_ell_apply_from_arrays
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.fused_gram.ops import fused_gram
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
    mesh:    the :class:`~repro_torch.launch.mesh.VirtualMesh` (None for a
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
        pm=None,
        conversion=None,
        device=None,
    ) -> "ECGSolver":
        """Build a solver handle for matrix ``a``.

        a:          :class:`~repro_torch.sparse.csr.CSRMatrix` (SPD); it is
                    moved to ``device`` if it lies elsewhere.
        mesh:       a :class:`~repro_torch.launch.mesh.VirtualMesh` for the
                    distributed node-aware solver, or None for the
                    sequential solver.
        config:     a :class:`SolverConfig` (or dict of its fields).
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
        """
        if mesh is not None and not all(
            hasattr(mesh, m) for m in ("ppermute", "psum", "local_ranks", "shape", "device")
        ):
            _not_ported(
                f"a mesh of type {type(mesh).__name__}: the distributed solver runs on a "
                "repro_torch.launch.mesh.VirtualMesh; a process-group mesh",
                "queue 1 item 5b",
            )
        self = cls.__new__(cls)
        if mesh is not None:
            self.device = mesh.device
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device!r} differs from the mesh's {mesh.device}")
        else:
            self.device = resolve_device("cuda" if device is None else device)
        self.a = a.to(self.device)
        self.mesh = mesh
        self.config = SolverConfig.coerce(config)
        self.stats = SolverStats()
        self.op = None
        self._pm = pm
        self._runners: dict = {}
        self._onehot_cache: dict = {}
        self._conversion_in = conversion
        self.conversion = None
        self._build()
        return self

    def _build(self):
        cfg = self.config
        if isinstance(cfg.t, str):
            _not_ported('t="auto"', "queue 1 item 6b")
        if cfg.tune.active:
            _not_ported(f"tuning (tune mode {cfg.tune.mode!r})", "queue 1 item 9")
        if self.device.type == "cuda":
            # float32 Gram products and TRSMs run in full float32, as the
            # reference's; this is torch's default, set here explicitly
            torch.backends.cuda.matmul.allow_tf32 = False
        self.stats.builds += 1
        self.t = cfg.t
        self._set_policy(cfg.adaptive.policy)
        self._gram1 = self._gram2 = self._sqnorm = self._tail = self._split_fn = None
        self._gram2p = None
        if self.mesh is not None:
            self._build_distributed()
        elif cfg.kernel.backend == "pallas":
            self._build_ell_apply(cfg.kernel.ell_block)
        else:
            self._apply = lambda V: csr_spmbv(self.a, V)
        self._precond = self._build_precond()

    def _set_policy(self, policy):
        """The adaptive policy and whether solves run width-segmented: on a
        mesh, without restart (a restart re-enlarges, which a narrower
        exchange could not carry)."""
        self.policy = policy
        self._segmented = self.mesh is not None and policy is not None and not policy.restart

    def _build_distributed(self):
        cfg = self.config
        if self._pm is None:
            self._pm = partition_csr(self.a, self.mesh.p)
        # a sibling from with_config that changed only the exchange reuses
        # its parent's Block-ELL arrays: they depend on the partition alone
        parent = self._conversion_in or {}
        ell = None
        if parent.get("ell_block") == cfg.kernel.ell_block and cfg.kernel.backend == "pallas":
            ell = parent.get("ell")
        self.op = _make_distributed_spmbv(
            self.a, self.mesh, cfg.comm.strategy, t=self.t,
            machine=cfg.comm.machine, pm=self._pm, backend=cfg.kernel.backend,
            overlap=cfg.comm.overlap, ell_block=cfg.kernel.ell_block,
            col_split=cfg.comm.col_split, ell=ell,
        )
        self.stats.conv_reused = ell is not None
        if self.op.ell:
            self.conversion = dict(ell=self.op.ell, ell_block=cfg.kernel.ell_block)
        self._apply = self.op.matvec_fn()
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
        b_dev = self._device_vec(b)
        b_dev = b_dev.to(torch.promote_types(b_dev.dtype, self.a.data.dtype))
        x0_dev = torch.zeros_like(b_dev) if x0 is None else self._device_vec(x0, b_dev.dtype)
        runner = self._runner(self.t)
        carry = runner.run(runner.init(b_dev, x0_dev))
        segments = None
        if self._segmented:
            # Width-segmented solve: each segment runs the loop with the
            # exchange compacted to its width; when the controller retires
            # directions the loop exits, the exchange is re-sliced at the new
            # width and the solve resumes from the same carry.
            t_seg, k_prev, segments = self.t, 0, []
            while True:
                k = carry["k"]
                it_seg = k - k_prev
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
                carry = self._runner(t_seg).run(carry)
        self.stats.solves += 1
        result = finalize_result(carry, x0=x0_dev, t=self.t, tol=cfg.tol, policy=self.policy)
        result.comm_segments = segments
        return result

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
        adaptive policy) reuse the operator outright; operator-level overrides (backend, tile, t, ...)
        rebuild it, reusing the parent's conversion artifacts where they
        still match.  The preconditioner is reused with the operator unless
        the precondition knobs changed, which rebuild it alone.  Accepts the flat field spellings of
        :meth:`SolverConfig.replace`.
        """
        new_cfg = self.config.replace(**overrides)
        clone = ECGSolver.__new__(ECGSolver)
        clone.a, clone.config = self.a, new_cfg
        clone.device, clone.mesh = self.device, self.mesh
        clone.stats = SolverStats()
        clone.op = None
        clone._pm = self._pm
        clone._runners = {}
        clone._onehot_cache = {}
        clone._conversion_in = self.conversion
        clone.conversion = None
        reuse_op = (
            new_cfg.t == self.config.t
            and new_cfg.comm == self.config.comm
            and new_cfg.kernel == self.config.kernel
            and new_cfg.tune == self.config.tune
        )
        if reuse_op:
            # the SpMBV and the reductions do not depend on the scheme: a
            # method change reuses the operator; only the runners differ
            clone.t = self.t
            clone._set_policy(new_cfg.adaptive.policy)
            clone.op = self.op
            clone._apply = self._apply
            clone._gram1, clone._gram2 = self._gram1, self._gram2
            clone._sqnorm, clone._tail = self._sqnorm, self._tail
            clone._gram2p = self._gram2p
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
