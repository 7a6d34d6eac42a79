"""The packed halo exchange of one plan at one width, over static buffers,
replayed as one CUDA graph.

A :class:`HaloExchange` owns everything one exchange touches: the
``[own ‖ halo ‖ pad]`` operand ``xfull`` of the local products (p, m_pad, t),
whose pad rows are zeroed once; the halo (p, halo_size + 1, w) and stage
(p, stage_size + 1, w) buffers; and each phase's send buffer and, where the
phase rotates, its receive buffer.  :meth:`HaloExchange.exchange` is the
exchange itself: zero the halo and stage, then per phase one ``halo_pack``
into the send buffer, one ``mesh.ppermute`` per nonzero rotation offset
(concatenated into the receive buffer), one ``halo_unpack``, and last the
copy of the finished halo into ``xfull``'s halo rows.  The plan's index
arrays were checked against these buffers when they were built
(``spmbv._phase_arrays``).

On CUDA, :meth:`HaloExchange.run` runs it eagerly the first time (the
warm-up, which also builds the kernel libraries: nothing may be built under
capture), captures it into a CUDA graph the second time, and replays that
graph from then on, so an exchange costs the host one graph launch instead
of some thirty kernel launches.  A capture that fails raises; there is no
eager fallback.  On CPU tensors every run is eager, through the plain
versions, and so is every run on a mesh whose ``capturable`` is False (a
``ProcessGroupMesh``: its NCCL point-to-point calls are not captured),
decided by the mesh's type and not by a failed capture.  :meth:`HaloExchange.start` is :meth:`run` for the overlap
schedule: it replays the graph on a given side stream, after the caller's
stream has copied in the own rows, and hands back an event that the
boundary product waits on.

Python counters move only while the exchange's Python code runs, so under a
graph the kernel ops' ``launches`` and the mesh's counters would stop at the
capture.  :func:`count_deltas` records what the captured exchange added to
them (and takes it back: the capture itself moves no data); the capture
raises unless that equals what the plan says one exchange launches
(:attr:`HaloExchange.deltas`), and :func:`add_counts` adds it at every
replay, so the counts read as if every exchange had run eagerly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import KERNEL_OPS
from repro_torch.kernels.halo_pack.ops import halo_pack, halo_unpack

#: the mesh counters an exchange may move (see ``launch/mesh.py``)
MESH_COUNTERS = ("psum_calls", "ppermute_calls", "ppermute_elements")


def count_deltas(counters, fn) -> list[int]:
    """Run ``fn`` and return what it added to each counter, an ``(object,
    attribute)`` pair; every counter is left as it was before the call."""
    before = [getattr(obj, attr) for obj, attr in counters]
    try:
        fn()
        return [getattr(obj, attr) - b for (obj, attr), b in zip(counters, before)]
    finally:
        for (obj, attr), b in zip(counters, before):
            setattr(obj, attr, b)


def add_counts(counters, deltas) -> None:
    """Add ``deltas`` (from :func:`count_deltas`) to the counters."""
    for (obj, attr), d in zip(counters, deltas):
        if d:
            setattr(obj, attr, getattr(obj, attr) + d)


class HaloExchange:
    """One exchange of ``plan`` at width ``t`` in ``dtype`` on ``mesh``.

    ``gathers``/``scatters`` are the plan's per-phase (p, width) int32 index
    tensors; ``rmax`` the own rows and ``m_pad`` the operand rows of a rank.
    Col-split plans index (row, column segment) slots: the own rows are
    viewed as (p, rmax·cs, t/cs) segments, from ``xfull`` itself when cs
    divides t, else from a copy padded to a multiple of cs columns (the
    width-1 initial residual).

    ``counters`` are the (object, attribute) pairs an exchange may move and
    ``deltas`` what one exchange on the card adds to each, from the plan:
    one ``halo_pack`` and one ``halo_unpack`` per nonempty phase, one
    ``ppermute`` per rotation offset, no ``psum`` and no other kernel.
    """

    def __init__(self, mesh, plan, gathers, scatters, rmax: int, m_pad: int, t: int, dtype):
        p, cs = mesh.local_ranks, plan.col_split
        if rmax + plan.halo_rows > m_pad:
            raise ValueError(f"{rmax} own and {plan.halo_rows} halo rows exceed {m_pad} operand rows")
        tp = -(-t // cs) * cs
        w = tp // cs

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=mesh.device)

        self.mesh, self.t = mesh, t
        self.xfull = zeros(p, m_pad, t)
        self.own = self.xfull[:, :rmax]
        self._padded = None if tp == t else zeros(p, rmax, tp)
        xs = (self.xfull.view(p, m_pad * cs, w) if self._padded is None
              else self._padded.view(p, rmax * cs, w))
        self.halo = zeros(p, plan.halo_size + 1, w)
        self.stage = zeros(p, plan.stage_size + 1, w)
        self.halo_rows = self.xfull[:, rmax : rmax + plan.halo_rows]
        self._finished = self.halo[:, : plan.halo_size].view(p, plan.halo_rows, tp)[:, :, :t]
        self._phases = []
        launches = rotations = elements = 0
        for ph, g_idx, s_pos in zip(plan.phases, gathers, scatters):
            send = zeros(p, ph.width, w)
            segments = [(send[:, ph.bounds[i] : ph.bounds[i + 1]], off)
                        for i, off in enumerate(ph.offsets)]
            recv = torch.empty_like(send) if any(ph.offsets) else send
            self._phases.append((xs if ph.src == "x" else self.stage, g_idx, send,
                                 ph.axis, segments if recv is not send else None, recv,
                                 self.halo if ph.dst == "halo" else self.stage, s_pos))
            launches += send.numel() > 0
            if recv is not send:
                rotated = [seg.numel() for seg, off in segments if off]
                rotations += len(rotated)
                elements += sum(rotated)
        self.counters = ([(op, "launches") for op in KERNEL_OPS]
                         + [(mesh, name) for name in MESH_COUNTERS])
        self.deltas = ([launches if op in (halo_pack, halo_unpack) else 0 for op in KERNEL_OPS]
                       + [0, rotations, elements])
        self.graph = None
        self.runs = 0
        self._done = None  # start()'s event, made at its first replay

    def exchange(self) -> None:
        """One exchange, run eagerly: ``xfull``'s halo rows from its own rows."""
        if self._padded is not None:
            self._padded[:, :, : self.t].copy_(self.own)
        self.halo.zero_()
        self.stage.zero_()
        for src, g_idx, send, axis, segments, recv, dst, s_pos in self._phases:
            halo_pack(src, g_idx, out=send)
            if segments is not None:
                torch.cat([seg if off == 0 else self.mesh.ppermute(seg, axis, off)
                           for seg, off in segments], dim=1, out=recv)
            halo_unpack(dst, recv, s_pos)
        self.halo_rows.copy_(self._finished)

    def capture(self) -> None:
        """Capture :meth:`exchange` as this exchange's CUDA graph; raises if
        the capture fails or counts other launches than :attr:`deltas`."""
        graph = torch.cuda.CUDAGraph()

        def record():
            with torch.cuda.graph(graph):
                self.exchange()

        captured = count_deltas(self.counters, record)
        if captured != self.deltas:
            names = [f"{getattr(obj, '__name__', 'mesh')}.{attr}" for obj, attr in self.counters]
            raise RuntimeError(f"the captured exchange counted {dict(zip(names, captured))}, "
                               f"its plan {dict(zip(names, self.deltas))}")
        self.graph = graph

    def replay(self) -> None:
        """One exchange by the captured graph, counted as an eager one."""
        self.graph.replay()
        add_counts(self.counters, self.deltas)

    def run(self, v3: torch.Tensor) -> torch.Tensor:
        """``xfull`` with ``v3`` (p, rmax, t) as its own rows and their
        exchanged halo: eager at the first run, on the CPU and on a mesh
        that cannot be captured, captured at the second run on CUDA and
        replayed from then on.  ``v3`` must lie
        on the exchange's device, in its dtype and shape."""
        return self.start(v3)[0]

    def start(self, v3: torch.Tensor, stream=None):
        """:meth:`run` with the replay on ``stream``: returns ``(xfull,
        done)``, where ``done`` is a CUDA event recorded on ``stream`` after
        the replay (the caller's stream must wait on it before it reads the
        halo rows), or None when the exchange ran on the caller's stream
        (no ``stream``, the eager first run, CPU tensors).  The
        replay waits for the caller's stream, which has copied ``v3`` in."""
        own = self.own
        if v3.device != own.device or v3.dtype != own.dtype or v3.shape != own.shape:
            raise ValueError(f"exchange of {tuple(own.shape)} {own.dtype} on {own.device} "
                             f"got {tuple(v3.shape)} {v3.dtype} on {v3.device}")
        own.copy_(v3)
        if self.graph is None and self.runs and self.xfull.is_cuda and self.mesh.capturable:
            self.capture()
        done = None
        if self.graph is None:
            self.exchange()
        elif stream is None:
            self.replay()
        else:
            stream.wait_stream(torch.cuda.current_stream(own.device))
            with torch.cuda.stream(stream):
                self.replay()
            if self._done is None:
                self._done = torch.cuda.Event()
            done = self._done
            done.record(stream)
        self.runs += 1
        return self.xfull, done
