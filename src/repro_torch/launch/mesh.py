"""The ("node", "proc") mesh the distributed solver runs on.

Port of ``repro/launch/mesh.py`` for the solver.  The reference lays its
ranks out on a ``jax.sharding.Mesh`` of devices and runs the per-rank
program under ``shard_map``.  The port has two meshes with the same
members, and the executor (:mod:`repro_torch.sparse.spmbv`) and the solver
handle use only those:

* :class:`VirtualMesh` holds all ``p = n_nodes·ppn`` ranks in one process,
  on one device: every per-rank tensor carries a leading rank axis of
  length ``local_ranks`` (= p here), ``ppermute`` is a rotation along that
  axis and ``psum`` a sum over it;
* :class:`ProcessGroupMesh` runs one rank per process over
  ``torch.distributed`` (NCCL on the process's card, gloo on the CPU):
  ``local_ranks == 1``, ``ppermute`` is one batched isend/irecv round with
  the two peers, ``psum`` one ``all_reduce``.

:class:`LMMesh` is the LM half's ("data", "model") mesh over the same
process groups (:func:`make_production_mesh`, :func:`make_smoke_mesh`).

``ranks`` names the global ranks whose rows a process holds (all p on a
``VirtualMesh``, its own on a ``ProcessGroupMesh``); ``all_gather``, used
only outside the iteration (``DistributedSpMBV.unshard``), stacks every
rank's value on every process (on a ``VirtualMesh`` it is the stacked
value itself).  ``capturable`` says whether an exchange on
the mesh may be captured in a CUDA graph: NCCL point-to-point calls are
not captured (ROADMAP.md queue 1 item 5b, remainder), so the exchange runs
eagerly on a ``ProcessGroupMesh``.

:func:`make_solver_mesh` is the reference's mesh constructor for the solver,
with the same shape rule.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

from repro_torch.kernels.dispatch import resolve_device

AXES = ("node", "proc", "flat")
#: the ROADMAP.md item that brings what the process-group mesh refuses
PROCESS_MESH_ITEM = "queue 1 item 5b, remainder"


class VirtualMesh:
    """``n_nodes × ppn`` ranks stacked along a leading axis of one device.

    Rank ``d`` is node ``d // ppn``, local rank ``d % ppn`` (node-major, as
    the reference's flattened ``("node", "proc")`` axis).  The counters
    ``psum_calls``, ``ppermute_calls`` and ``ppermute_elements`` (elements
    handed to ``ppermute``, padding included) stand in for the reference's
    lowered all-reduce and collective-permute counts, ``all_gather_calls``
    counts the gathers outside the iteration; :meth:`reset_counters` sets
    them to 0.
    """

    capturable = True

    def __init__(self, n_nodes: int, ppn: int, device="cuda"):
        if n_nodes < 1 or ppn < 1:
            raise ValueError(f"mesh shape must be positive, got ({n_nodes}, {ppn})")
        self.n_nodes, self.ppn = int(n_nodes), int(ppn)
        self.device = resolve_device(device)
        self.reset_counters()

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_nodes, self.ppn)

    @property
    def p(self) -> int:
        return self.n_nodes * self.ppn

    @property
    def local_ranks(self) -> int:
        """Length of the leading rank axis of every per-rank tensor."""
        return self.p

    @property
    def ranks(self) -> range:
        """The global ranks this process holds, in the rank axis' order."""
        return range(self.p)

    def reset_counters(self) -> None:
        self.psum_calls = 0
        self.ppermute_calls = 0
        self.ppermute_elements = 0
        self.all_gather_calls = 0

    def ppermute(self, buf: torch.Tensor, axis: str, offset: int) -> torch.Tensor:
        """Rank i sends ``buf[i]`` to rank (i + offset) mod n along ``axis``
        (``"proc"``: within a node; ``"node"``: same local rank on another
        node; ``"flat"``: the node-major flattened axis).  Returns what each
        rank received."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; expected one of {AXES}")
        self._check_ranked(buf, "ppermute")
        self.ppermute_calls += 1
        self.ppermute_elements += buf.numel()
        if axis == "flat":
            return torch.roll(buf, shifts=offset, dims=0)
        grid = buf.reshape(self.shape + tuple(buf.shape[1:]))
        out = torch.roll(grid, shifts=offset, dims=0 if axis == "node" else 1)
        return out.reshape(buf.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' values, ``x`` (p, ...) -> (...).  The sum runs
        over the rank axis in one fixed order (no atomics), so it is the same
        from run to run."""
        self._check_ranked(x, "psum")
        self.psum_calls += 1
        return x.sum(dim=0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's value, ``x`` (p, ...) -> (p, ...): the ranks are
        already stacked here."""
        self._check_ranked(x, "all_gather")
        self.all_gather_calls += 1
        return x

    def _check_ranked(self, x: torch.Tensor, what: str) -> None:
        if x.dim() < 1 or x.shape[0] != self.local_ranks:
            raise ValueError(
                f"{what}: expected a leading rank axis of {self.local_ranks}, got "
                f"shape {tuple(x.shape)}"
            )

    def __repr__(self) -> str:
        return f"VirtualMesh(n_nodes={self.n_nodes}, ppn={self.ppn}, device={str(self.device)!r})"


class ProcessGroupMesh:
    """``n_nodes × ppn`` ranks, one per process, over ``torch.distributed``.

    ``torch.distributed`` must be initialised, and ``group`` (default the
    world) must hold ``n_nodes·ppn`` processes; process d of the group is
    rank d: node ``d // ppn``, local rank ``d % ppn`` (node-major, as
    :class:`VirtualMesh`).  Each per-rank tensor carries a leading rank axis
    of length 1.  ``device`` defaults to ``cuda:<LOCAL_RANK>`` under NCCL
    (the card ``torch.cuda.set_device`` chose before the group was made) and
    to the CPU under gloo; any other pairing of backend and device raises,
    as does any other backend: nothing is staged through the host.

    The counters are :class:`VirtualMesh`'s and count this process's calls
    and elements, so ``ppermute_elements`` summed over the processes equals
    a :class:`VirtualMesh`'s.  The mesh makes one ``all_reduce`` over the
    group when it is built (NCCL's first call must involve every rank);
    that call is not counted.
    """

    capturable = False

    def __init__(self, n_nodes: int, ppn: int, group=None, device=None):
        if n_nodes < 1 or ppn < 1:
            raise ValueError(f"mesh shape must be positive, got ({n_nodes}, {ppn})")
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("a ProcessGroupMesh needs torch.distributed.init_process_group first")
        size = dist.get_world_size(group)
        if size != n_nodes * ppn:
            raise ValueError(f"the process group holds {size} processes, the mesh "
                             f"({n_nodes}, {ppn}) needs {n_nodes * ppn}")
        self.n_nodes, self.ppn = int(n_nodes), int(ppn)
        self.group = group
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.device = process_device(self.backend, device)
        self._peers = [r if group is None else dist.get_global_rank(group, r) for r in range(size)]
        dist.all_reduce(torch.zeros(1, device=self.device), group=group)
        self.reset_counters()

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_nodes, self.ppn)

    @property
    def p(self) -> int:
        return self.n_nodes * self.ppn

    @property
    def local_ranks(self) -> int:
        """Length of the leading rank axis of every per-rank tensor."""
        return 1

    @property
    def ranks(self) -> range:
        """The global ranks this process holds: its own."""
        return range(self.rank, self.rank + 1)

    reset_counters = VirtualMesh.reset_counters
    _check_ranked = VirtualMesh._check_ranked

    def peer(self, axis: str, offset: int) -> int:
        """The rank ``offset`` steps from this one along ``axis``
        (:meth:`VirtualMesh.ppermute`'s axes), wrapping around."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; expected one of {AXES}")
        if axis == "flat":
            return (self.rank + offset) % self.p
        node, proc = divmod(self.rank, self.ppn)
        if axis == "node":
            return (node + offset) % self.n_nodes * self.ppn + proc
        return node * self.ppn + (proc + offset) % self.ppn

    def ppermute(self, buf: torch.Tensor, axis: str, offset: int) -> torch.Tensor:
        """This rank's ``buf[0]`` goes to the rank ``+offset`` along ``axis``;
        returns (1, ...) what the rank ``-offset`` sent.  One
        ``batch_isend_irecv`` holds the send and the receive, so two ranks
        that send to each other (offset 1 on an axis of 2) cannot deadlock.
        Every rank's buffer has the same shape (the plan pads it over
        ranks), so each send matches its receive.  An offset that wraps
        to this rank (a multiple of the axis' length) returns a copy."""
        self._check_ranked(buf, "ppermute")
        dst, src = self.peer(axis, offset), self.peer(axis, -offset)
        self.ppermute_calls += 1
        self.ppermute_elements += buf.numel()
        if dst == self.rank:
            return buf.clone()
        out = torch.empty_like(buf, memory_format=torch.contiguous_format)
        ops = [dist.P2POp(dist.isend, buf.contiguous(), self._peers[dst], self.group),
               dist.P2POp(dist.irecv, out, self._peers[src], self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, ``x`` (1, ...) -> (...): one ``all_reduce`` of
        a copy of ``x[0]``.  NCCL and gloo hand every rank the same sum, but
        not in :meth:`VirtualMesh.psum`'s order."""
        self._check_ranked(x, "psum")
        self.psum_calls += 1
        out = x[0].clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's value on every process, ``x`` (1, ...) -> (p, ...);
        used outside the iteration only, with its own counter."""
        self._check_ranked(x, "all_gather")
        self.all_gather_calls += 1
        x = x[0].contiguous()
        out = [torch.empty_like(x) for _ in range(self.p)]
        dist.all_gather(out, x, group=self.group)
        return torch.stack(out)

    def __repr__(self) -> str:
        return (f"ProcessGroupMesh(n_nodes={self.n_nodes}, ppn={self.ppn}, rank={self.rank}, "
                f"backend={self.backend!r}, device={str(self.device)!r})")


def process_device(backend: str, device=None) -> torch.device:
    """The device a process-group rank computes on: ``cuda:<LOCAL_RANK>``
    under NCCL (by default; the card ``torch.cuda.set_device`` chose), the
    CPU under gloo, and under ``fake`` (the dry-run's traced world,
    :mod:`torch.testing._internal.distributed.fake_pg`, whose collectives
    move nothing) the device the caller names (default ``cuda``), which the
    traced step's fake tensors are placed on: no card is needed.  Any other
    pairing raises."""
    if backend == "fake":
        dev = torch.device("cuda" if device is None else device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be a CUDA device or 'cpu', got {device!r}")
        return dev
    if backend == "nccl":
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if device is None
                             else device)
        if dev.type != "cuda":
            raise ValueError(f"a NCCL process group computes on a CUDA device, got {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"a NCCL rank on {dev} must call torch.cuda.set_device({dev.index}) "
                             "before init_process_group")
        return dev
    if backend == "gloo":
        dev = resolve_device("cpu" if device is None else device)
        if dev.type != "cpu":
            raise ValueError(f"a gloo process group computes on the CPU, got {dev}")
        return dev
    raise ValueError(f"a ProcessGroupMesh runs over NCCL or gloo (an LMMesh also in the dry-run's "
                     f"fake world), got backend {backend!r}")


def refuse_unstacked(mesh, what: str) -> None:
    """Raise ``NotImplementedError`` when ``what`` needs every rank stacked
    on one device and ``mesh`` holds only some of them (a process-group
    mesh)."""
    if mesh is not None and mesh.local_ranks != mesh.p:
        raise NotImplementedError(
            f"{what} on a {type(mesh).__name__} is not ported yet (ROADMAP.md "
            f"{PROCESS_MESH_ITEM})")


def make_solver_mesh(*, multi_pod: bool = False, ppn: int = 16, n_ranks: int | None = None,
                     device=None) -> VirtualMesh | ProcessGroupMesh:
    """Two-level ("node", "proc") grid for the distributed ECG solver.

    The reference's shape rule: ``(2, n // 2)`` under ``multi_pod`` (two
    pods as the slow tier), else ``(n // ppn, ppn)`` (groups of ``ppn``
    ranks as the paper's nodes).  With ``n_ranks`` it returns a
    :class:`VirtualMesh` of ``n = n_ranks`` ranks stacked on ``device``
    (default ``"cuda"``; the count of cards says nothing about it).
    Without, inside an initialised ``torch.distributed`` world, it returns
    a :class:`ProcessGroupMesh` over the world, ``n`` its size (the
    reference's device count).  A count the shape does not cover raises,
    as ``jax.make_mesh`` does.
    """
    if n_ranks is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("make_solver_mesh needs n_ranks= or an initialised "
                             "torch.distributed world")
        n = dist.get_world_size()
    else:
        n = n_ranks
    shape = (2, n // 2) if multi_pod else (n // ppn, ppn)
    if shape[0] * shape[1] != n or min(shape) < 1:
        what = f"n_ranks={n}" if n_ranks is not None else f"a world of {n}"
        raise ValueError(
            f"mesh shape {shape} does not cover {what} "
            f"({'multi_pod' if multi_pod else f'ppn={ppn}'})"
        )
    if n_ranks is None:
        return ProcessGroupMesh(*shape, device=device)
    return VirtualMesh(*shape, device="cuda" if device is None else device)


class LMMesh:
    """The LM half's ("data", "model") or ("pod", "data", "model") mesh over
    ``torch.distributed``, one process a position.

    Process ``r`` of the world sits at the row-major coordinates of ``r``
    over ``shape``, as ``jax.make_mesh`` lays devices out.  A collective
    over an axis (or a tuple of axes) runs on the process subgroup that
    shares every other coordinate; the subgroups of an axis tuple are made
    on its first use, by every process in the same order (the sharded step
    is one program on every process).  Inside a subgroup the processes are
    in the order of their coordinate along the axes, so a tiled gather
    concatenates the blocks in the reference's order.

    ``torch.distributed`` must be initialised and its world hold
    ``prod(shape)`` processes; a mesh whose axes all have size 1 may also
    be made without a world, and its collectives are then identities that
    make no call (the reference's smoke mesh).  ``device`` is as
    :class:`ProcessGroupMesh`'s (NCCL on the process's card, gloo on the
    CPU, no other pairing), or any device without a world.  In a ``fake``
    world (:func:`process_device`; the dry-run traces rank 0 of the
    production mesh in one process) the mesh makes no joining call and its
    collectives move nothing: their results have the right shapes only.

    Collectives (:meth:`all_gather`, :meth:`reduce_scatter`, :meth:`psum`,
    :meth:`pmean`) are differentiable: each one's backward is its exact
    transpose (an all-gather's is a reduce-scatter and back, a psum's a
    psum), so the gradient a process computes is its share of the gradient
    of the sum of every process's loss.  Counters: ``calls[key]`` and
    ``elements[key]`` count this process's calls and the elements it handed
    in, by axis key (the axis names joined by ``+``); :meth:`reset_counters`
    clears them.  Inside :meth:`record_calls` each call is also listed as
    (op, the group's global ranks, payload bytes of its result), which
    :func:`~repro_torch.collectives.tiered_collective_bytes` reads.
    """

    def __init__(self, shape, axis_names, device=None):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names) or min(shape, default=0) < 1:
            raise ValueError(f"mesh shape {shape} does not match axes {names}")
        if names not in (("data", "model"), ("pod", "data", "model")):
            raise ValueError(f"an LM mesh has axes ('data', 'model') or ('pod', 'data', 'model'), "
                             f"got {names}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.size = math.prod(shape)
        self.distributed = dist.is_available() and dist.is_initialized()
        if self.distributed:
            world = dist.get_world_size()
            if world != self.size:
                raise ValueError(f"mesh {shape} needs a world of {self.size} processes, "
                                 f"torch.distributed has {world}")
            self.rank = dist.get_rank()
            self.backend = str(dist.get_backend())
            self.device = process_device(self.backend, device)
        else:
            if self.size != 1:
                raise ValueError(f"mesh {shape} needs torch.distributed.init_process_group first")
            self.rank, self.backend = 0, None
            self.device = resolve_device("cuda" if device is None else device)
        self.coords = dict(zip(names, _unravel(self.rank, shape)))
        self._groups: dict[tuple, tuple] = {}
        self._records: list | None = None
        if self.distributed and self.backend != "fake":  # a fake world moves nothing
            dist.all_reduce(torch.zeros(1, device=self.device))  # every rank joins once
        self.reset_counters()

    def reset_counters(self) -> None:
        self.calls: dict[str, int] = {}
        self.elements: dict[str, int] = {}

    @contextlib.contextmanager
    def record_calls(self):
        """Collect each collective made inside as (op, the group's global
        ranks, payload bytes of its result), in call order."""
        before, self._records = self._records, []
        try:
            yield self._records
        finally:
            self._records = before

    def barrier(self) -> None:
        """Wait for every process of the world (nothing without one)."""
        if self.distributed:
            dist.barrier(device_ids=[self.device.index] if self.backend == "nccl" else None)

    # ------------------------------------------------------------ geometry
    def axes(self, axis) -> tuple[str, ...]:
        """``axis`` (a name or a tuple of names) as a tuple in mesh order."""
        want = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = set(want) - set(self.axis_names)
        if unknown or len(set(want)) != len(want):
            raise ValueError(f"axes {want} are not distinct axes of {self.axis_names}")
        return tuple(a for a in self.axis_names if a in want)

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[a] for a in self.axes(axis))

    def axis_index(self, axis) -> int:
        """This process's coordinate along ``axis`` (row-major over a tuple)."""
        idx = 0
        for a in self.axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _group(self, axes: tuple[str, ...]):
        if axes not in self._groups:
            names, sizes = self.axis_names, tuple(self.shape.values())
            by_rest: dict[tuple, list[int]] = {}
            for r in range(self.size):
                c = dict(zip(names, _unravel(r, sizes)))
                by_rest.setdefault(tuple(c[a] for a in names if a not in axes), []).append(r)
            mine = None
            for ranks in by_rest.values():  # every process makes every group, in one order
                g = dist.new_group(ranks) if self.distributed and len(by_rest) > 1 else None
                if self.rank in ranks:
                    mine = (g, tuple(ranks))
            self._groups[axes] = mine
        return self._groups[axes]

    # --------------------------------------------------------- collectives
    def all_gather(self, x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
        """The blocks of ``axis`` concatenated along ``dim`` (tiled)."""
        return _AllGather.apply(x, self, self.axes(axis), dim)

    def reduce_scatter(self, x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
        """The sum over ``axis``, this process's block of ``dim`` (tiled)."""
        return _ReduceScatter.apply(x, self, self.axes(axis), dim)

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        return _Psum.apply(x, self, self.axes(axis))

    def pmean(self, x: torch.Tensor, axis) -> torch.Tensor:
        return self.psum(x, axis) / self.axis_size(axis)

    def pmax(self, x: torch.Tensor, axis) -> torch.Tensor:
        """The elementwise max over ``axis`` (no gradient)."""
        return self._raw("all_reduce", x.detach(), self.axes(axis), reduce_op=dist.ReduceOp.MAX)

    def all_gather_many(self, xs, axis, dims) -> list[torch.Tensor]:
        """:meth:`all_gather` of several tensors (each along its own dim) in
        one call: their blocks are packed into one buffer."""
        return list(_AllGatherMany.apply(self, self.axes(axis), tuple(dims), *xs))

    # -------------------------------------------------------------- calls
    def _count(self, op: str, axes, x: torch.Tensor, out: torch.Tensor) -> None:
        key = "+".join(axes)
        self.calls[key] = self.calls.get(key, 0) + 1
        self.elements[key] = self.elements.get(key, 0) + x.numel()
        if self._records is not None:
            self._records.append((op, self._group(axes)[1], out.numel() * out.element_size()))

    def _raw(self, op: str, x: torch.Tensor, axes, dim: int = 0, reduce_op=None) -> torch.Tensor:
        """One collective over ``axes`` without autograd: ``all_gather``,
        ``reduce_scatter`` (tiled along ``dim``) or ``all_reduce``.  The
        result is contiguous in ``x``'s layout: the blocks travel stacked
        on a new leading axis and one copy merges that axis into ``dim``
        (none where ``dim`` is 0 or the axis has one process)."""
        if not self.distributed:  # a mesh of one position: nothing to call
            return x
        n = self.axis_size(axes)
        group = self._group(axes)[0]
        dim = dim % max(x.dim(), 1)
        if op == "all_reduce":
            out = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, op=reduce_op or dist.ReduceOp.SUM, group=group)
        elif op == "all_gather":
            xc = x.contiguous()
            out = xc.new_empty((n * xc.shape[0],) + xc.shape[1:])
            dist.all_gather_into_tensor(out, xc, group=group)
            out = _merge(out.view((n,) + xc.shape), dim)
        else:
            if x.shape[dim] % n:
                raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not "
                                 f"divide over {axes} ({n})")
            xs = _split(x, n, dim).contiguous()  # (n, block)
            out = xs.new_empty(xs.shape[1:])
            dist.reduce_scatter_tensor(out, xs.view((n * xs.shape[1],) + xs.shape[2:]), group=group)
        self._count(op, axes, x, out)
        return out

    def __repr__(self) -> str:
        return (f"LMMesh({self.shape}, rank={self.rank}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")


def _merge(stacked: torch.Tensor, dim: int) -> torch.Tensor:
    """(n, *block) blocks → one tensor, the blocks concatenated along
    ``dim``: contiguous (a view where ``dim`` is 0 or n is 1)."""
    n, shape = stacked.shape[0], stacked.shape[1:]
    full = shape[:dim] + (n * shape[dim],) + shape[dim + 1:]
    return stacked.movedim(0, dim).reshape(full)


def _split(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``x`` cut into ``n`` blocks along ``dim``, stacked: (n, *block) (a
    view; the inverse of :func:`_merge`)."""
    shape = x.shape
    return x.reshape(shape[:dim] + (n, shape[dim] // n) + shape[dim + 1:]).movedim(dim, 0)


def _unravel(r: int, sizes) -> tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        r, c = divmod(r, s)
        out.append(c)
    return tuple(reversed(out))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.meta = (mesh, axes, dim)
        return mesh._raw("all_gather", x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.meta
        return mesh._raw("reduce_scatter", g, axes, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.meta = (mesh, axes, dim)
        return mesh._raw("reduce_scatter", x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.meta
        return mesh._raw("all_gather", g, axes, dim), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.meta = (mesh, axes)
        return mesh._raw("all_reduce", x, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.meta
        return mesh._raw("all_reduce", g, axes), None, None


def _pack(xs):
    """The blocks flattened and concatenated: (sum of numels,), and their
    shapes."""
    return torch.cat([x.reshape(-1) for x in xs]), [tuple(x.shape) for x in xs]


def _unpack(flat, n, shapes, dims):
    """``flat`` (n·total,) of n stacked packs → each tensor with its n
    blocks concatenated along its dim, contiguous (:func:`_merge`)."""
    rows = flat.view(n, -1)
    out, off = [], 0
    for shape, d in zip(shapes, dims):
        k = math.prod(shape)
        out.append(_merge(rows[:, off:off + k].view((n,) + shape), d))
        off += k
    return out


class _AllGatherMany(torch.autograd.Function):
    """One all-gather of several blocks packed together; backward one
    reduce-scatter of their gradients packed the same way."""

    @staticmethod
    def forward(ctx, mesh, axes, dims, *xs):
        n = mesh.axis_size(axes)
        flat, shapes = _pack(xs)
        ctx.meta = (mesh, axes, dims, shapes)
        return tuple(_unpack(mesh._raw("all_gather", flat, axes), n, shapes, dims))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes, dims, shapes = ctx.meta
        n = mesh.axis_size(axes)
        # each gradient as n blocks along its dim, rank-major like the gather
        packs = [_split(g, n, d).reshape((n, -1)) for g, d in zip(gs, dims)]
        flat = torch.cat(packs, dim=1).reshape(-1)
        parts = mesh._raw("reduce_scatter", flat, axes)
        out, off = [], 0
        for shape in shapes:
            k = math.prod(shape)
            out.append(parts[off:off + k].view(shape))
            off += k
        return (None, None, None, *out)


def make_smoke_mesh(device=None) -> LMMesh:
    """The reference's 1 × 1 ("data", "model") mesh: no world needed (inside
    one, a world of 1, whose collectives are then real calls)."""
    return LMMesh((1, 1), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> LMMesh:
    """The reference's LM production mesh over the initialised world:
    ("data", "model") 16 × 16, or ("pod", "data", "model") 2 × 16 × 16 under
    ``multi_pod``.  A world of another size raises ``ValueError``, as
    ``jax.make_mesh`` does for another device count."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_production_mesh needs an initialised torch.distributed world "
                         f"of {math.prod(shape)} processes")
    return LMMesh(shape, axes, device=device)
