"""Residual enlarging operators T_{r,t} (paper §2.1, Fig 2.1).

T_{r,t} projects r ∈ R^n to an n x t block vector whose columns sum to r
(row-sum preservation, eq. 2.3) and are linearly independent: column i of
T carries the entries of r belonging to subdomain i, zeros elsewhere.
"""

from __future__ import annotations

import torch


def subdomain_map_contiguous(n: int, t: int, device=None) -> torch.Tensor:
    """Row -> subdomain id, contiguous blocks (Fig 2.1 left; aligned with the
    contiguous row partition the paper uses)."""
    return (torch.arange(n, device=device) * t) // n


def subdomain_map_round_robin(n: int, t: int, device=None) -> torch.Tensor:
    """Row -> subdomain id, cyclic assignment (Fig 2.1 middle)."""
    return torch.arange(n, device=device) % t


def split_residual(r: torch.Tensor, t: int, mapping: str = "contiguous") -> torch.Tensor:
    """T_{r,t}: split r into an (n, t) block vector along subdomains."""
    n = r.shape[0]
    if mapping == "contiguous":
        sub = subdomain_map_contiguous(n, t, r.device)
    elif mapping == "round_robin":
        sub = subdomain_map_round_robin(n, t, r.device)
    else:
        raise ValueError(f"unknown mapping {mapping!r}")
    onehot = torch.nn.functional.one_hot(sub, t).to(r.dtype)
    return r[:, None] * onehot


def collapse(block: torch.Tensor) -> torch.Tensor:
    """Inverse direction of (2.3): sum block-vector columns back to a vector."""
    return block.sum(dim=1)



def split_rank(r: torch.Tensor, t: int, mapping: str = "contiguous") -> torch.Tensor:
    """Number of nonzero columns of T_{r,t}(r), a 0-dim integer tensor.

    The columns of the splitting have disjoint supports, so they are linearly
    independent iff nonzero — this is the exact rank of the initial enlarged
    block, i.e. the width a breakdown-safe solve (:mod:`repro_torch.adaptive`)
    reduces to on its first iteration when some subdomains carry no residual.
    """
    big = split_residual(r, t, mapping)
    return torch.sum(torch.any(big != 0, dim=0))
