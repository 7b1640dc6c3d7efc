"""Checkpoint and resume for long renders and inverse-rendering runs
(kytpu/utils/checkpoint.py).

A checkpoint is a nested structure of dicts, tuples and lists whose leaves
are tensors, numpy arrays or python numbers (a film accumulator, optimizer
state, trainable parameters), flattened in kytpu's order (dict keys
sorted) and written atomically as numpy arrays beside a JSON header that
holds the structure in kytpu's PyTreeDef notation, so a killed process
never leaves a torn file, and kytpu's files load here and this package's
there.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch


def _flatten(tree) -> tuple[list, str]:
    """(leaves, structure) of a nested dict / tuple / list, dict keys
    sorted; the structure as kytpu's PyTreeDef prints it, inside
    "PyTreeDef(...)"."""
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, s = _flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {s}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (tuple, list)):
        leaves, parts = [], []
        for v in tree:
            sub, s = _flatten(v)
            leaves += sub
            parts.append(s)
        body = ", ".join(parts)
        if isinstance(tree, list):
            return leaves, f"[{body}]"
        return leaves, f"({body}{',' if len(parts) == 1 else ''})"
    if tree is None:
        return [], "None"
    return [tree], "*"


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken from the iterator
    `leaves` in `_flatten`'s order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _treedef(tree) -> str:
    return f"PyTreeDef({_flatten(tree)[1]})"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, tree, step: int | None = None) -> str:
    """Atomically write `tree` (+ an optional step counter) to `path`, an
    .npz file."""
    leaves, _ = _flatten(tree)
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
    meta = dict(n_leaves=len(leaves), step=step, treedef=_treedef(tree))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


class CheckpointMismatchError(ValueError):
    """The checkpoint's structure does not match the restore template."""


def load_checkpoint(path: str, like, strict: bool = True):
    """Restore into the structure of `like` (a template) -> (tree, step).

    Checked, not unpickled: raises CheckpointMismatchError if the leaf
    count, a leaf's shape or (strict) the stored structure disagrees with
    the template. A tensor leaf of the template is restored as a tensor of
    its dtype and device, a numpy one as an array of its dtype, a python
    number as saved."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    template = _flatten(like)[0]
    if len(template) != len(leaves):
        raise CheckpointMismatchError(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(template)}")
    if strict and meta.get("treedef") not in (None, _treedef(like)):
        raise CheckpointMismatchError(
            f"checkpoint treedef does not match template:\n"
            f"  saved:    {meta['treedef']}\n"
            f"  template: {_treedef(like)}")
    restored = []
    for i, (x, t) in enumerate(zip(leaves, template)):
        t_shape = tuple(t.shape) if hasattr(t, "shape") else np.shape(t)
        if x.shape != t_shape:
            raise CheckpointMismatchError(
                f"leaf {i}: checkpoint shape {x.shape} != template shape "
                f"{t_shape}")
        if isinstance(t, torch.Tensor):
            restored.append(torch.as_tensor(x).to(dtype=t.dtype,
                                                  device=t.device))
        elif isinstance(t, np.ndarray):
            restored.append(x.astype(t.dtype))
        else:
            restored.append(x)
    return _unflatten(like, iter(restored)), meta.get("step")
