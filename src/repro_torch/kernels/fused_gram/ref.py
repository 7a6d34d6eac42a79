"""Plain torch version of the fused block-inner-product kernel."""

from __future__ import annotations

import torch


def fused_gram_ref(p, r, ap, ap_old):
    """[PᵀR | APᵀAP | AP_oldᵀAP]  — the 3t² payload of ECG's allreduce #2.

    All inputs (n, t); output (t, 3t).
    """
    return torch.cat([p.T @ r, ap.T @ ap, ap_old.T @ ap], dim=1)
