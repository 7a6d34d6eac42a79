"""Plain torch versions of the fused ECG block-update kernels."""

from __future__ import annotations


def block_update_ref(x, r, p, ap, c):
    """X += P·c ; R -= AP·c   (ECG Alg 1 lines 7–8, one fused pass)."""
    return x + p @ c, r - ap @ c


def ecg_tail_ref(x, r, p, ap, p_old, c, d, d_old):
    """Full iteration tail: X += P·c ; R -= AP·c ; Z = AP − P·d − P_old·d_old."""
    return x + p @ c, r - ap @ c, ap - p @ d - p_old @ d_old
