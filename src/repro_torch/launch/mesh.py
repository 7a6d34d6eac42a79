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
    CPU under gloo.  Any other pairing raises."""
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
    raise ValueError(f"a ProcessGroupMesh runs over NCCL or gloo, got backend {backend!r}")


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


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's ("data", "model") 16 × 16 LM training mesh (two pods
    under ``multi_pod``): the sharded LM layout, not ported yet (the LM
    half runs on one device)."""
    from repro_torch.models.common import not_ported

    not_ported("the LM production mesh (make_production_mesh) and its 2-D FSDP x TP layout")
