"""Plain torch version of the fused block-inner-product kernel."""

from __future__ import annotations

import torch


def fused_gram_ref(p, r, ap, ap_old):
    """[PᵀR | APᵀAP | AP_oldᵀAP]  — the 3t² payload of ECG's allreduce #2.

    All inputs (n, t); output (t, 3t).  With a leading rank axis, inputs
    (ranks, n, t) give one payload per rank, (ranks, t, 3t).
    """
    return torch.cat([p.mT @ r, ap.mT @ ap, ap_old.mT @ ap], dim=-1)
