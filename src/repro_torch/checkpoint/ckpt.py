"""Checkpointing: tree save / restore with step resume (port of
``repro.checkpoint.ckpt``, in the reference's on-disk format).

Format: one directory per step —
    ckpt_dir/step_000123/
        meta.json              (step, every leaf's shape and dtype)
        arrays.npz             (flat leaves, key = leaf path)
        DONE                   (commit marker)

A writer writes ``step_XXXXXXXX.tmp`` and renames it when complete, so a
crash mid-save leaves no DONE marker and :func:`latest_step` picks the
previous step.  Keys follow the reference's leaf paths: dict keys in
sorted order, list entries by index, named-tuple fields as ``.name``
(``{"params": ..., "opt": OptState(m, v, step)}`` gives ``opt/.m/...``),
joined by "/".  bf16 (and float8) leaves are stored as their unsigned
integer view, with the logical dtype in ``meta.json``, as the reference
stores them.  So a checkpoint of the reference's tree layout (the port's
Trainer saves through ``bridge``) restores in either package.  Leaves may
be tensors (any device), numpy arrays, or callables that make one when
the writer reaches them; :func:`restore` returns CPU tensors.  A blocking
save copies and writes one leaf at a time; an async save snapshots the
tree to host memory at call time and writes it from a thread, so the
caller waits for the copy only.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

# dtypes numpy's npz cannot round-trip: the unsigned view stored, and the
# torch dtype that view reads back as
_VIEW = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
         "float8_e5m2": (np.uint8, torch.float8_e5m2)}
_TORCH_NAME = {torch.bfloat16: "bfloat16",
               torch.float8_e4m3fn: "float8_e4m3fn",
               torch.float8_e5m2: "float8_e5m2"}
# the stored view as a torch integer type, and as its numpy twin (torch
# has no uint16)
_INT_OF = {np.uint16: torch.int16, np.uint8: torch.uint8}
_NP_INT_OF = {np.uint16: np.int16, np.uint8: np.uint8}


def _items(tree, prefix=()):
    """(path tuple, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _host(leaf):
    """(array to store, logical dtype name): a host copy of the leaf (a
    callable leaf is called first: see :func:`save`)."""
    if callable(leaf):
        leaf = leaf()
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        name = _TORCH_NAME.get(t.dtype)
        if name is not None:
            store = _VIEW[name][0]
            return t.view(_INT_OF[store]).numpy().view(store), name
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _VIEW:
        return arr.view(_VIEW[name][0]), name
    return arr, name


def leaf_keys(tree) -> list:
    """The keys that :func:`save` gives the leaves of ``tree``, in order."""
    return ["/".join(path) for path, _ in _items(tree)]


def snapshot(tree) -> dict:
    """{key: (host array, logical dtype)} of every leaf, in flatten
    order."""
    return {"/".join(path): _host(leaf) for path, leaf in _items(tree)}


def _write(ckpt_dir: str, step: int, leaves):
    """Write the (key, (array, dtype)) pairs of ``leaves`` as numpy's
    ``savez`` lays out an npz (stored zip entries "<key>.npy"), each leaf
    as it comes, then meta.json and DONE, then commit by renaming."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "leaves": {}}
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dt) in leaves:
            arr = np.asarray(arr, order="C")    # keeps a 0-d leaf 0-d
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                # write_array's header, then the bytes in one write (its
                # own loop copies every 16 MiB chunk first)
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(memoryview(arr.reshape(-1)).cast("B"))
            meta["leaves"][key] = {"shape": list(arr.shape), "dtype": dt}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def save(ckpt_dir: str, step: int, tree: Any, *, blocking: bool = True
         ) -> Optional[threading.Thread]:
    """Save ``tree`` at ``step``.  A leaf may be a tensor, a numpy array or
    a callable that returns one (made when its turn comes).  Blocking
    mode copies and writes one leaf at a time, so the host holds one
    leaf, never the tree (a full-width qwen3-4b's parameters and moments
    are 40 GB).  Non-blocking mode snapshots the whole tree to host
    memory first, then writes it in a daemon thread, which it returns."""
    if blocking:
        _write(ckpt_dir, step, (("/".join(path), _host(leaf))
                                for path, leaf in _items(tree)))
        return None
    snap = snapshot(tree)
    th = threading.Thread(target=_write,
                          args=(ckpt_dir, step, list(snap.items())),
                          daemon=True)
    th.start()
    return th


def save_gathered(ckpt_dir: str, step: int, tree: Any) -> None:
    """Save a mesh's tree: every rank calls each leaf (a callable that
    gathers the leaf whole, a collective; or a tensor every rank holds) in
    the writer's order; rank 0 writes them as :func:`save` does, one leaf
    in host memory at a time, meta.json and DONE last, and the others wait
    at a barrier until it has committed."""
    items = (("/".join(path), leaf) for path, leaf in _items(tree))
    if dist.get_rank() == 0:
        _write(ckpt_dir, step, ((k, _host(leaf)) for k, leaf in items))
    else:
        for _, leaf in items:
            if callable(leaf):
                leaf()
    dist.barrier()


def _committed(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "DONE")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed(ckpt_dir)
    return steps[-1] if steps else None


def _leaf(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype in _VIEW:
        store, tdt = _VIEW[dtype]
        return torch.from_numpy(arr.view(_NP_INT_OF[store]).copy()).view(tdt)
    return torch.from_numpy(np.array(arr))


def restore(ckpt_dir: str, like_tree: Any, step: Optional[int] = None,
            device=None, specs: Any = None, rules=None) -> tuple[Any, int]:
    """Restore into the structure of ``like_tree`` (its leaves give the
    keys and the expected shapes): (tree of tensors on ``device``, CPU by
    default, in the dtypes saved, step).  With ``specs`` (a tree of
    partition specs of ``like_tree``'s structure) and ``rules`` each leaf
    is this rank's block of it on the rules' mesh (the reference's
    ``restore(shardings=)``), one whole leaf in host memory at a time."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def load(path_, like, spec):
            key = "/".join(path_)
            t = _leaf(data[key], meta["leaves"][key]["dtype"])
            assert tuple(t.shape) == tuple(like.shape), (key, t.shape,
                                                         like.shape)
            if spec is not None:
                from repro_torch.sharding.rules import take_block

                t = take_block(t, spec, rules)
            return t if device is None else t.to(device)

        return _rebuild(like_tree, load, specs=specs), step


def _rebuild(tree, load, prefix=(), specs=None):
    """``like``'s structure with each leaf replaced by ``load(path, leaf,
    spec)``, paths as :func:`_items` makes them, ``spec`` the matching
    entry of ``specs`` (a tree of ``tree``'s structure) or None."""
    sub = (lambda k: None) if specs is None else specs.__getitem__
    if isinstance(tree, dict):
        return {k: _rebuild(v, load, prefix + (str(k),), sub(k))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, load, prefix + ("." + n,), sub(i))
                            for i, (n, v) in enumerate(zip(tree._fields,
                                                           tree))))
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, load, prefix + (str(i),), sub(i))
                for i, v in enumerate(tree)]
    return None if tree is None else load(prefix, tree, specs)


def prune(ckpt_dir: str, keep: int = 3):
    for s in _committed(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
