"""Tree checkpointing in the reference's npz layout (port of
:mod:`repro.checkpoint.ckpt`).

Tensors are copied to the host; the keys are the tree paths joined by
``/`` in the JAX package's leaf order (dict keys sorted, sequences by
index: :mod:`repro_torch.tree`), bf16 is stored as its uint16 bit
pattern under ``key::bf16``, and a file is published atomically. So a
file that either package writes loads in the other, bit for bit. A
``None`` is an empty subtree, as in the reference: it stores nothing and
loads back as ``None``.

Packed trainer state needs nothing special: its leaves are bf16, int8
grid payloads and f32 per-row scales, which all round-trip bitwise, so a
mid-run resume of packed optimizer state and EF residual is exact.
"""
from __future__ import annotations

import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _walk(tree: Any, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[str, Any]]:
    """(path key, leaf) pairs in the JAX package's order; ``None`` is an
    empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _flatten(tree: Any) -> dict:
    out = {}
    for key, leaf in _walk(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            # npz has no bf16: store the bit pattern and a dtype tag
            out[key + "::bf16"] = t.contiguous().view(torch.int16) \
                .numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    return out


def save_pytree(path: str, tree: Any) -> None:
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)          # atomic publish


def save_state(path: str, **trees: Any) -> None:
    """Bundle several named trees (params, opt_state, the EF residual,
    channel state, …) into one atomic checkpoint: a partial save (params
    without the EF residual they were trained with) would resume to
    different bits. ``None`` entries are legal."""
    save_pytree(path, dict(trees))


def load_state(path: str, **likes: Any) -> dict:
    """Inverse of :func:`save_state`: restore each named tree into the
    structure of its ``like`` (shapes validated leaf by leaf)."""
    return load_pytree(path, dict(likes))


def _load(flat: dict, like: Any, prefix: Tuple[str, ...]) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _load(flat, like[k], prefix + (str(k),))
                for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_load(flat, v, prefix + (str(i),))
                          for i, v in enumerate(like))
    key = "/".join(prefix)
    if key + "::bf16" in flat:
        arr = flat[key + "::bf16"].view(np.int16)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(flat[key]))
    ref = torch.as_tensor(like)
    if tuple(t.shape) != tuple(ref.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                         f"{tuple(ref.shape)}")
    device = ref.device if ref.device.type != "meta" else "cpu"
    return t.to(device=device, dtype=ref.dtype)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes validated; each
    leaf cast to the dtype, and moved to the device, of ``like``'s)."""
    with np.load(path) as data:
        flat = dict(data)
    return _load(flat, like, ())
