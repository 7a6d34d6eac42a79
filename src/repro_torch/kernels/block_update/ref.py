"""Plain torch version of the fused ECG tail kernel."""

from __future__ import annotations


def ecg_tail_ref(x, r, p, ap, p_old, c, d, d_old):
    """Full iteration tail: X += P·c ; R -= AP·c ; Z = AP − P·d − P_old·d_old."""
    return x + p @ c, r - ap @ c, ap - p @ d - p_old @ d_old
