"""Checkpointing: atomic, step-tagged, preemption-safe.

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
* ``install_preemption_handler`` checkpoints on SIGTERM before exiting.

A tree is nested dicts whose leaves are modules, tensors or numpy values.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.models.transformer import STACKED, _to_numpy, stack_named, unstack_named


def _is_named(d: dict) -> bool:
    """A dict of tensors by parameter name (dotted keys: ``"layers.<i>.<w>"``,
    ``"dec_layers.<i>.<w>"``, ``"shared.<w>"``)."""
    return any(isinstance(k, str) and "." in k for k in d)


def _to_reference(obj):
    """A tree → the reference's nested dict of numpy arrays."""
    if isinstance(obj, nn.Module):
        return stack_named(dict(obj.named_parameters()))
    if isinstance(obj, dict):
        return stack_named(obj) if _is_named(obj) else {k: _to_reference(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return _to_numpy(obj)
    return np.asarray(obj)


def _named_keys(names) -> dict:
    """:func:`stack_named`'s keys for parameter names (leaves None)."""
    keys = {}
    for name in names:
        parts = name.split(".")
        if parts[0] in STACKED:
            parts = [parts[0], parts[2]]
        node = keys
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = None
    return keys


def _reference_keys(obj):
    """The reference layout's keys of a tree (leaves None), without copying
    any value."""
    if isinstance(obj, nn.Module):
        return _named_keys(n for n, _ in obj.named_parameters())
    if isinstance(obj, dict):
        return _named_keys(obj) if _is_named(obj) else {k: _reference_keys(v) for k, v in obj.items()}
    return None


def _flatten(tree, prefix=()):
    """(path, leaf) in the reference's order: dict keys sorted."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _flatten(tree[k], prefix + (k,))


def _from_reference(like, ref):
    """Values in the reference layout → ``like``'s structure: a module's
    parameters are copied in place (the module is returned), tensors come
    back on ``like``'s device in its dtype."""
    as_tensor = lambda a, t: torch.from_numpy(np.array(a)).to(t.device, t.dtype)
    if isinstance(like, nn.Module):
        named = unstack_named(ref)
        with torch.no_grad():
            for name, p in like.named_parameters():
                p.copy_(as_tensor(named[name], p))
        return like
    if isinstance(like, dict):
        if _is_named(like):
            named = unstack_named(ref)
            return {n: as_tensor(named[n], t) for n, t in like.items()}
        return {k: _from_reference(v, ref[k]) for k, v in like.items()}
    if isinstance(like, torch.Tensor):
        return as_tensor(ref, like)
    return np.asarray(ref).astype(np.asarray(like).dtype)


def save_checkpoint(ckpt_dir: str | os.PathLike, step: int, tree, extra: dict | None = None):
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp.{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves = [leaf for _, leaf in _flatten(_to_reference(tree))]
    np.savez(tmp / "leaves.npz", **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    meta = {"step": step, "n_leaves": len(leaves), "extra": extra or {}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    final = ckpt_dir / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic
    latest = ckpt_dir / "latest"
    tmp_link = ckpt_dir / ".latest.tmp"
    if tmp_link.is_symlink() or tmp_link.exists():
        tmp_link.unlink()
    tmp_link.symlink_to(final.name)
    tmp_link.rename(latest)  # atomic flip
    return final


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    latest = Path(ckpt_dir) / "latest"
    if not latest.exists():
        return None
    return json.loads((latest / "meta.json").read_text())["step"]


def restore_checkpoint(ckpt_dir: str | os.PathLike, like_tree, step: int | None = None):
    """Restore into ``like_tree``'s structure, devices and dtypes (modules
    in place).  Returns ``(tree, meta)``."""
    ckpt_dir = Path(ckpt_dir)
    src = ckpt_dir / ("latest" if step is None else f"step_{step:08d}")
    meta = json.loads((src / "meta.json").read_text())
    paths = [path for path, _ in _flatten(_reference_keys(like_tree))]
    if meta["n_leaves"] != len(paths):
        raise ValueError(f"checkpoint/model structure mismatch: {meta['n_leaves']} leaves "
                         f"against {len(paths)}")
    ref: dict = {}
    with np.load(src / "leaves.npz") as data:
        for i, path in enumerate(paths):
            node = ref
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = data[f"leaf_{i}"]
    return _from_reference(like_tree, ref), meta


def install_preemption_handler(save_fn):
    """Checkpoint on SIGTERM (preemption) before exiting."""
    def handler(signum, frame):
        save_fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)
