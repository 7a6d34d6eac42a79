"""Disk-backed warm-start cache: tuning + t-selection survive restarts.

Port of ``repro/serve/cache.py``: the keys, the file names and the JSON are
the reference's, so an entry written by either package loads in the other.

The expensive part of registering an operator is not the partition or the
plan (milliseconds) but the *tuning work*: ``t="auto"`` convergence
probes and autotuner model evaluation.  Both already serialize losslessly
(:func:`~repro_torch.tune.autotune.tunedconfig_to_dict`,
:func:`~repro_torch.adaptive.select_t.tselection_to_dict`), and both feed
straight back into a build through ``SolverConfig.replace(tuned=...,
select=...)`` — so one small JSON file per operator turns every restart
rebuild into a probe-free warm build.

Schema 2 entries additionally persist the CSR→Block-ELL **conversion
meta** (:func:`~repro_torch.kernels.block_ell_meta` — tile choice, ``kmax``,
padding histogram) when the build ran the Block-ELL kernel path
(``backend="pallas"``): a restarted or re-admitted-after-eviction operator
then direct-fills its Block-ELL arrays without re-running the tile
analysis (``SolverStats.conv_analyzed`` stays False).

Keying: ``(operator fingerprint, base-config digest, mesh tag)``.  The
config digest hashes the solver template *with its tuned/select payload
nulled* — a cached selection is only valid for the base configuration
(tolerance, method, candidates, machine…) it was probed under, while the
payload itself must not key the lookup it answers.  The mesh tag
(``seq`` or ``{nodes}x{ppn}``, from ``VirtualMesh.shape`` where the
reference reads ``mesh.devices.shape``) keeps sequential and differently-shaped
distributed selections apart.

Corrupt or stale-schema files are a cache *miss*, never an error: the
loader warns and falls back to a cold build that overwrites the entry.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings

from repro_torch.solver.config import SolverConfig, solverconfig_to_dict

_SCHEMA = 2


def config_digest(cfg: SolverConfig) -> str:
    """Digest of the base solver template, warm-start payload excluded."""
    d = solverconfig_to_dict(cfg)
    d["tune"]["tuned"] = None
    d["adaptive"]["select"] = None
    blob = json.dumps(d, sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


def mesh_tag(mesh) -> str:
    """``seq`` for a single-device handle, else ``{nodes}x{ppn}``."""
    if mesh is None:
        return "seq"
    n_nodes, ppn = mesh.shape
    return f"{n_nodes}x{ppn}"


class WarmStartCache:
    """One JSON file per (fingerprint, config, mesh) warm-start entry."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, fingerprint: str, cfg_digest: str, tag: str) -> str:
        return os.path.join(self.root, f"{fingerprint}-{cfg_digest}-{tag}.json")

    def load(self, fingerprint: str, cfg_digest: str, tag: str):
        """Return ``(hit, tuned, select, conversion)``; corrupt entries are
        misses.  Schema-1 entries (no conversion meta) still hit — their
        ``conversion`` is None and the next store upgrades them in place."""
        path = self.path(fingerprint, cfg_digest, tag)
        if not os.path.exists(path):
            return False, None, None, None
        try:
            with open(path) as f:
                d = json.load(f)
            if d.get("schema") not in (1, _SCHEMA):
                raise ValueError(f"unknown warm-start schema {d.get('schema')!r}")
            tuned = select = None
            if d.get("tuned") is not None:
                from repro_torch.tune.autotune import tunedconfig_from_dict

                tuned = tunedconfig_from_dict(d["tuned"])
            if d.get("select") is not None:
                from repro_torch.adaptive.select_t import tselection_from_dict

                select = tselection_from_dict(d["select"])
            conversion = d.get("conversion")
            if conversion is not None and not isinstance(conversion, dict):
                conversion = None
            return True, tuned, select, conversion
        except Exception as e:  # poisoned entry -> cold build, then overwrite
            warnings.warn(
                f"warm-start cache entry {path} unreadable ({e}); "
                "falling back to a cold build",
                stacklevel=3,
            )
            return False, None, None, None

    def store(self, fingerprint: str, cfg_digest: str, tag: str,
              tuned, select, conversion=None) -> str:
        """Persist a build's tuning outcome (atomic rename write).

        ``conversion`` is the JSON-safe tile-analysis meta from
        :func:`~repro_torch.kernels.block_ell_meta` (or None when the build had
        no Block-ELL conversion to remember)."""
        d = dict(schema=_SCHEMA, fingerprint=fingerprint, tuned=None,
                 select=None, conversion=conversion)
        if tuned is not None:
            from repro_torch.tune.autotune import tunedconfig_to_dict

            d["tuned"] = tunedconfig_to_dict(tuned)
        if select is not None:
            from repro_torch.adaptive.select_t import tselection_to_dict

            d["select"] = tselection_to_dict(select)
        path = self.path(fingerprint, cfg_digest, tag)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f, indent=2)
        os.replace(tmp, path)
        return path
