"""The ("node", "proc") mesh the distributed solver runs on.

Port of ``repro/launch/mesh.py`` for the solver.  The reference lays its
ranks out on a ``jax.sharding.Mesh`` of devices and runs the per-rank
program under ``shard_map``.  The port's :class:`VirtualMesh` holds all
``p = n_nodes·ppn`` ranks in one process, on one device: every per-rank
tensor carries a leading rank axis of length ``local_ranks`` (= p here),
``ppermute`` is a rotation along that axis and ``psum`` a sum over it.  The
executor (:mod:`repro_torch.sparse.spmbv`) and the solver handle use only
the members below, so a process-group mesh (one rank per card, NCCL
``send``/``recv`` and ``all_reduce``, ``local_ranks == 1``) can take its
place without touching them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import resolve_device

AXES = ("node", "proc", "flat")


class VirtualMesh:
    """``n_nodes × ppn`` ranks stacked along a leading axis of one device.

    Rank ``d`` is node ``d // ppn``, local rank ``d % ppn`` (node-major, as
    the reference's flattened ``("node", "proc")`` axis).  The counters
    ``psum_calls``, ``ppermute_calls`` and ``ppermute_elements`` (elements
    handed to ``ppermute``, padding included) stand in for the reference's
    lowered all-reduce and collective-permute counts; :meth:`reset_counters`
    sets them to 0.
    """

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

    def reset_counters(self) -> None:
        self.psum_calls = 0
        self.ppermute_calls = 0
        self.ppermute_elements = 0

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

    def _check_ranked(self, x: torch.Tensor, what: str) -> None:
        if x.dim() < 1 or x.shape[0] != self.local_ranks:
            raise ValueError(
                f"{what}: expected a leading rank axis of {self.local_ranks}, got "
                f"shape {tuple(x.shape)}"
            )

    def __repr__(self) -> str:
        return f"VirtualMesh(n_nodes={self.n_nodes}, ppn={self.ppn}, device={str(self.device)!r})"
