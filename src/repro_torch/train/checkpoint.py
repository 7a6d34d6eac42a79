"""Checkpointing: atomic, step-tagged, mesh-agnostic, preemption-safe.

Port of ``repro/train/checkpoint.py`` on the reference's on-disk layout, so
a checkpoint written by either package restores in the other:

* ``<dir>/tmp.<step>`` is written, then renamed to ``step_<step:08d>``
  (atomic on POSIX), and the ``latest`` symlink is flipped last;
* ``leaves.npz`` holds ``leaf_<i>`` in the reference's flatten order (dict
  keys sorted), with a module's per-layer parameters, and any dict of
  tensors by parameter name (the optimizer moments), stacked back to the
  reference's ``(n_layers, …)`` arrays (``layers``; the encoder-decoder's
  ``enc_layers`` and ``dec_layers``) and other dotted names nested (the
  hybrid's ``shared.<w>`` as ``{"shared": {"<w>": …}}``); ``meta.json``
  holds the step, the leaf count and ``extra``;
* arrays are saved *logically* (full values), so a checkpoint written on
  one LM mesh restores onto another mesh shape or onto one device;
* ``install_preemption_handler`` checkpoints on SIGTERM before exiting.

A tree is nested dicts whose leaves are modules, tensors or numpy values.
The leaves are written one at a time into the archive (``np.savez``'s
format, streamed), so the host holds one stacked leaf at a time.

On an LM mesh (``mesh``, with ``specs`` mirroring the tree: a module's or
a named dict's entry is a ``name -> P`` function, a tensor's a ``P``; a
train bundle's ``state_specs``) each process holds blocks.
:func:`save_checkpoint` is then collective: every process gathers each
leaf by its spec (the parameters by theirs, the moments by their ZeRO-1
specs), one per-layer leaf at a time; rank 0 alone copies them to the
host and writes, and the others wait at a barrier.  :func:`restore_checkpoint` reads the file on every process
and keeps its own blocks.  The directory must be one every process sees.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import zipfile
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.models.common import block_of, gather_named
from repro_torch.models.transformer import STACKED, _to_numpy


def _is_named(d: dict) -> bool:
    """A dict of tensors by parameter name (dotted keys: ``"layers.<i>.<w>"``,
    ``"dec_layers.<i>.<w>"``, ``"shared.<w>"``)."""
    return any(isinstance(k, str) and "." in k for k in d)


def _sources(obj, spec=None, prefix=()) -> dict:
    """The reference layout's leaves of a tree: ``path -> [(layer, value,
    spec)]``, a stacked leaf's entries one a layer (``layer`` its index;
    None for a leaf that is not stacked)."""
    if isinstance(obj, nn.Module):
        obj = dict(obj.named_parameters())
    out: dict = {}
    if isinstance(obj, dict) and _is_named(obj):
        for name, t in obj.items():
            parts, sp = name.split("."), spec(name) if spec else None
            if parts[0] in STACKED:
                out.setdefault(prefix + (parts[0], parts[2]), []).append((int(parts[1]), t, sp))
            else:
                out[prefix + tuple(parts)] = [(None, t, sp)]
        for entries in out.values():
            entries.sort(key=lambda e: -1 if e[0] is None else e[0])
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out |= _sources(v, spec[k] if spec else None, prefix + (k,))
    else:
        out[prefix] = [(None, obj, spec)]
    return out


def _leaves(tree, specs) -> list:
    """:func:`_sources` in the reference's flatten order (keys sorted at
    every level: the paths in lexicographic order)."""
    return sorted(_sources(tree, specs).items(), key=lambda kv: kv[0])


def _full(value, spec, mesh, writer: bool) -> np.ndarray | None:
    """A leaf's full value on the host for the ``writer`` (gathered by
    ``spec`` on a mesh); the other processes only join the gather and
    get None."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value) if writer else None
    if mesh is not None and spec is not None:
        value = gather_named({"x": value}, lambda _: spec, mesh)["x"]
    return _to_numpy(value) if writer else None


def save_checkpoint(ckpt_dir: str | os.PathLike, step: int, tree, extra: dict | None = None,
                    mesh=None, specs=None):
    """Write ``tree`` as checkpoint ``step`` (module docstring); on a
    ``mesh`` every process calls it with its blocks and ``specs``."""
    ckpt_dir = Path(ckpt_dir)
    writer = mesh is None or mesh.rank == 0
    final = ckpt_dir / f"step_{step:08d}"
    leaves = _leaves(tree, specs)
    if writer:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        tmp = ckpt_dir / f"tmp.{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        archive = zipfile.ZipFile(tmp / "leaves.npz", "w", zipfile.ZIP_STORED, allowZip64=True)
    try:
        for i, (_, entries) in enumerate(leaves):
            # gathered layer by layer; the writer stacks them on the host
            parts = [_full(v, sp, mesh, writer) for _, v, sp in entries]
            if writer:
                arr = parts[0] if entries[0][0] is None else np.stack(parts)
                with archive.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                del arr
            del parts
    finally:
        if writer:
            archive.close()
    if writer:
        meta = {"step": step, "n_leaves": len(leaves), "extra": extra or {}}
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic
        latest = ckpt_dir / "latest"
        tmp_link = ckpt_dir / ".latest.tmp"
        if tmp_link.is_symlink() or tmp_link.exists():
            tmp_link.unlink()
        tmp_link.symlink_to(final.name)
        tmp_link.rename(latest)  # atomic flip
    if mesh is not None:
        mesh.barrier()  # the checkpoint exists for every process
    return final


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    latest = Path(ckpt_dir) / "latest"
    if not latest.exists():
        return None
    return json.loads((latest / "meta.json").read_text())["step"]


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str | os.PathLike, like_tree, step: int | None = None, mesh=None,
                       specs=None):
    """Restore into ``like_tree``'s structure, devices and dtypes (its
    tensors and modules in place; numpy leaves come back new).  On a
    ``mesh`` (with ``specs``) every process reads the file and keeps its
    own blocks, whatever mesh wrote it.  Returns ``(tree, meta)``."""
    ckpt_dir = Path(ckpt_dir)
    src = ckpt_dir / ("latest" if step is None else f"step_{step:08d}")
    meta = json.loads((src / "meta.json").read_text())
    leaves = _leaves(like_tree, specs)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint/model structure mismatch: {meta['n_leaves']} leaves "
                         f"against {len(leaves)}")
    got = {}
    with np.load(src / "leaves.npz") as data:
        for i, (path, entries) in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            for layer, t, sp in entries:
                a = arr if layer is None else arr[layer]
                if not isinstance(t, torch.Tensor):
                    got[path] = np.asarray(a).astype(np.asarray(t).dtype)
                    continue
                if mesh is not None and sp is not None:
                    a = block_of(a, sp, mesh)
                t.copy_(torch.from_numpy(np.array(a)).to(t.device, t.dtype))  # 0-d stays 0-d
    return _restored(like_tree, got), meta


def _restored(like, got, prefix=()):
    """``like`` with its numpy leaves replaced by the values read."""
    if isinstance(like, dict) and not _is_named(like):
        return {k: _restored(v, got, prefix + (k,)) for k, v in like.items()}
    return got.get(prefix, like)


def install_preemption_handler(save_fn, mesh=None):
    """Checkpoint on SIGTERM (preemption) before exiting with 143.  Returns
    ``poll``, which the training loop calls after each step.

    Without a ``mesh`` (one process) the handler saves and exits at once,
    and ``poll`` does nothing.  On a mesh the save is collective (every
    process joins its gathers), and a handler that ran it could meet its
    peers inside a training step's collectives, or peers that got no
    signal at all (a SIGTERM that reaches only some processes): there the
    handler only records the signal.  ``poll``, called by every process at
    the same step boundary, takes the flag's max over the world (one
    all-reduce), so a process that got no signal learns of it, and then
    every process runs ``save_fn`` together and exits with 143."""
    got = {"signal": False}

    def handler(signum, frame):
        if mesh is not None:
            got["signal"] = True
            return
        save_fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)

    def poll() -> None:
        if mesh is None:
            return
        flag = torch.tensor([1.0 if got["signal"] else 0.0], device=mesh.device)
        if float(mesh.pmax(flag, mesh.axis_names)[0]) > 0:
            save_fn()
            raise SystemExit(143)

    return poll
