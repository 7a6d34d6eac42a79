"""Pod-aware hierarchical collectives: the paper's node-aware schemes applied
to multi-pod gradient reduction.

Port of ``repro/collectives/hierarchical.py`` on an
:class:`~repro_torch.launch.mesh.LMMesh`.  The 2-step node-aware exchange
(the paper's Fig. 2.6) maps onto an allreduce as:

    step 1 (fast tier):  reduce-scatter over the intra-pod "data" axis
                         — every process now owns a 1/|data| shard of the sum
    step 2 (slow tier):  all-reduce over the "pod" axis on shards only
                         — slow-tier bytes drop by |data|× vs a flat ring
    step 3 (fast tier):  all-gather over "data" to restore the full tensor

The reference runs the three steps under ``shard_map`` with the input
replicated, so a replicated ``x`` returns n·x (n the processes summed
over); here each process hands in its own value and gets the sum.

``tiered_collective_bytes`` splits the payload bytes of collectives into
those whose group stays inside a pod and those that cross pods.  The
reference reads a compiled HLO's replica groups; the port reads the mesh's
own record of its calls (``LMMesh.record_calls``: each call's group ranks
and result bytes).
"""

from __future__ import annotations

import torch


def hierarchical_allreduce(x: torch.Tensor, mesh, pod_axis: str = "pod",
                           fast_axis: str = "data") -> torch.Tensor:
    """The sum of every process's ``x`` over (``pod_axis``, ``fast_axis``) by
    the 2-step scheme (module docstring).

    Falls back to a plain psum when the mesh has no pod axis (over
    ``fast_axis`` only) or the leading dim does not divide the fast axis
    (over both axes), as the reference does.
    """
    if pod_axis not in mesh.axis_names:
        return mesh.psum(x, fast_axis)
    if x.shape[0] % mesh.shape[fast_axis]:
        return mesh.psum(x, (pod_axis, fast_axis))
    shard = mesh.reduce_scatter(x, fast_axis, 0)   # step 1: fast tier
    shard = mesh.psum(shard, pod_axis)             # step 2: slow tier, shards only
    return mesh.all_gather(shard, fast_axis, 0)    # step 3: fast tier


def tiered_collective_bytes(records, pod_size: int) -> dict[str, int]:
    """Collective payload bytes split into ``intra_pod`` and ``cross_pod``: a
    call crosses pods iff its group holds ranks from different
    ``rank // pod_size`` blocks.  ``records`` are (op, group ranks, bytes),
    as an LM mesh's ``record_calls()`` collects them."""
    out = {"intra_pod": 0, "cross_pod": 0}
    for _, ranks, nbytes in records:
        crosses = len({r // pod_size for r in ranks}) > 1
        out["cross_pod" if crosses else "intra_pod"] += int(nbytes)
    return out
