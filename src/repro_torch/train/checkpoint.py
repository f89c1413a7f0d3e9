"""Atomic array checkpoints, in the reference's on-disk layout.

One directory per step::

    ckpt_dir/step_000000123/
        manifest.json      — keys, shapes, dtypes and the caller's JSON ``extra``
        arrays.npz         — the flat ``{name: array}`` dict
    ckpt_dir/latest        — the name of the newest step directory

A write goes to ``step_….tmp`` and is renamed into place, and ``latest`` is
replaced atomically after it, so a write cut half way never corrupts the
newest checkpoint; ``keep_last`` older step directories are kept. This is
the layout of ``repro.train.checkpoint``, so a checkpoint written by either
package loads in the other: ``save_arrays`` / ``load_arrays`` for a flat
``{name: array}`` dict, ``save`` / ``restore`` for a tree (nested dicts and
lists of tensors, see ``utils/tree.py``), its leaves named by
``jax.tree_util.keystr`` (``['params']['layers']['attn']['wq']``).

A bfloat16 leaf is written as its 2-byte words in a ``|V2`` array, the bytes
and header the reference's ``ml_dtypes`` array gives, and read back from
them: ``np.load`` returns such a leaf as ``|V2`` words in either package.

A data-parallel run's state (``save(..., mesh=)``, called by every rank;
rank 0 writes) is stored in the same layout, its ``residual`` the ranks'
mean, so the reference and a run at any world size restore it; beside it
each rank's own residual, ``['rank_residual'][r]…``. ``restore(...,
shardings=)`` is the elastic path: a run with as many ranks as wrote the
checkpoint takes each rank's own residual back (a resume bit for bit),
another world size the mean.

Reads take each ``.npy`` member of ``arrays.npz`` straight from the file
(``np.fromfile`` at the member's offset) and hold it to the zip's CRC-32,
``READ_THREADS`` members at a time; ``np.load`` copies a member through
Python 256 KiB at a time, ≈ 3.6× slower than the file's read.
"""
from __future__ import annotations

import collections
import json
import math
import os
import shutil
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.cluster.bootstrap import process_count, process_index
from repro_torch.utils.host import from_host, is_bf16_words, to_host
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten

_SAVE_LOCK = threading.Lock()
_PENDING: list[threading.Thread] = []
# members of arrays.npz read at once
READ_THREADS = 8
# the names of a data-parallel checkpoint's mean residual and of each rank's
_RES, _RANKS = "['residual']", "rank_residual"


def save(ckpt_dir: str, step: int, state, extra: dict | None = None,
         async_: bool = True, keep_last: int = 3, mesh=None) -> None:
    """Snapshot the tree ``state`` (+ JSON-serializable ``extra``, e.g. the
    data pipeline's cursor) as step ``step``; its leaves are copied to the
    host before this returns, so the caller may update them in place.

    With a collective ``mesh`` every rank calls this with its own state (the
    same but for ``residual``); rank 0 writes the ranks' mean residual and
    each rank's own (the module docstring)."""
    if mesh is None or not mesh.collective:
        _save_arrays(ckpt_dir, step, {k: to_host(v) for k, v in tree_leaves_with_path(state)},
                     extra, async_, keep_last)
        return
    ranks = _gather_residuals(state.get("residual"))
    if process_index() != 0:
        return
    arrays = {k: to_host(v) for k, v in tree_leaves_with_path(state)
              if ranks is None or not k.startswith(_RES)}
    if ranks is not None:
        # the mean and the ranks' residuals are host tensors of this call's own
        ours = {"residual": tree_map(_mean, *ranks), _RANKS: ranks}
        arrays.update((k, to_host(v, copy=False)) for k, v in tree_leaves_with_path(ours))
    _save_arrays(ckpt_dir, step, arrays, extra, async_, keep_last)


def _mean(*leaves: torch.Tensor) -> torch.Tensor:
    """The leaves' mean, summed in float32 in order, in their dtype."""
    acc = leaves[0].float().clone()
    for t in leaves[1:]:
        acc += t.float()
    return acc.div_(len(leaves)).to(leaves[0].dtype)


def _gather_residuals(residual):
    """Every rank's residual tree on rank 0's host, in rank order (None on
    the other ranks, and without a residual), one gather to rank 0 a leaf.
    Over gloo each leaf is gathered from host memory, where rank 0 needs it,
    so rank 0's card holds no other rank's leaf; NCCL gathers on the card."""
    if residual is None:
        return None
    rank, world = process_index(), process_count()
    staged = torch.distributed.get_backend() == "gloo"
    out = [[] for _ in range(world)]
    for leaf in tree_leaves(residual):
        t = leaf.detach().to("cpu", copy=True) if staged else leaf.detach()
        parts = [torch.empty_like(t) for _ in range(world)] if rank == 0 else None
        torch.distributed.gather(t, parts, dst=0)
        if rank == 0:
            for r, part in enumerate(parts):
                out[r].append(part.to("cpu"))
    return [tree_unflatten(residual, leaves) for leaves in out] if rank == 0 else None


def restore(ckpt_dir: str, like, device=None, shardings=None) -> tuple[dict, dict]:
    """Load the latest checkpoint into the structure, dtypes and devices of the
    tree ``like`` (or onto ``device``). Returns (state, extra); raises
    FileNotFoundError if there is no checkpoint.

    ``shardings`` (the restoring run's ``trainer.state_shardings``) makes it
    the elastic path of a data-parallel run: each rank takes its own
    residual where the checkpoint holds one for each rank of this run's
    world, else the ranks' mean. Every leaf is restored whole on each rank:
    this port replicates parameters (their placement over a mesh is not
    ported)."""
    d = latest_step_dir(ckpt_dir)
    if d is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    specs = tree_leaves_with_path(like)
    names = [name for name, _ in specs]
    stored = {k[len(_RANKS) + 5:].split("]")[0] for k in meta.get("keys", ())
              if k.startswith(f"['{_RANKS}'][")}
    if shardings is not None and len(stored) == process_count() > 1:
        own = f"['{_RANKS}'][{process_index()}]"
        names = [own + n[len(_RES):] if n.startswith(_RES) else n for n in names]
    arrays = _read_npz(os.path.join(d, "arrays.npz"), names)
    leaves = [from_host(a, spec.dtype, spec.device if device is None else device)
              for (_, spec), a in zip(specs, arrays)]
    return tree_unflatten(like, leaves), meta.get("extra", {})


def save_arrays(ckpt_dir: str, step: int, arrays: dict, extra: dict | None = None,
                async_: bool = False, keep_last: int = 3) -> None:
    """Snapshot a flat ``{name: array}`` dict (numpy arrays or tensors, copied
    to the host before this returns) with JSON ``extra`` as step ``step``."""
    _save_arrays(ckpt_dir, step, {k: to_host(v) for k, v in arrays.items()}, extra, async_,
                 keep_last)


def _save_arrays(ckpt_dir: str, step: int, arrays: dict, extra: dict | None, async_: bool,
                 keep_last: int) -> None:
    meta = {
        "step": step,
        "treedef": None,
        "keys": list(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: "bfloat16" if is_bf16_words(v) else str(v.dtype)
                   for k, v in arrays.items()},
        "extra": extra or {},
        "time": time.time(),
    }

    def _write():
        with _SAVE_LOCK:
            final = os.path.join(ckpt_dir, f"step_{step:09d}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
                f.write(os.path.basename(final))
            os.replace(os.path.join(ckpt_dir, "latest.tmp"), os.path.join(ckpt_dir, "latest"))
            _gc(ckpt_dir, keep_last)

    os.makedirs(ckpt_dir, exist_ok=True)
    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        _write()


def wait_for_pending() -> None:
    """Block until every ``async_`` write has landed."""
    for t in list(_PENDING):
        t.join()
        _PENDING.remove(t)


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step_dir(ckpt_dir: str) -> str | None:
    ptr = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return os.path.join(ckpt_dir, f.read().strip())


def load_arrays(ckpt_dir: str) -> tuple[dict[str, np.ndarray], dict]:
    """(``{name: np.ndarray}``, ``extra``) of the latest snapshot under
    ``ckpt_dir``. Raises FileNotFoundError if there is none."""
    d = latest_step_dir(ckpt_dir)
    if d is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    arrays = dict(zip(meta["keys"], _read_npz(os.path.join(d, "arrays.npz"), meta["keys"])))
    return arrays, meta.get("extra", {})


def _read_npz(path: str, names: list[str]):
    """The arrays ``names`` of an ``.npz``, in order, as a generator: at most
    ``READ_THREADS`` read ahead of the one taken, so a caller that moves each
    to the card holds a few on the host, not all. Raises KeyError for a
    missing name."""
    with zipfile.ZipFile(path) as zf:
        have = {info.filename: info for info in zf.infolist()}
    missing = [n for n in names if n + ".npy" not in have]
    if missing:
        raise KeyError(f"checkpoint missing leaf {missing[0]}")

    def gen():
        with ThreadPoolExecutor(READ_THREADS) as pool:
            ahead = collections.deque()
            for n in names:
                ahead.append(pool.submit(_read_member, path, have[n + ".npy"]))
                if len(ahead) > READ_THREADS:
                    yield ahead.popleft().result()
            while ahead:
                yield ahead.popleft().result()

    return gen()


def _read_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """One ``.npy`` member of an ``.npz`` as ``np.savez`` stores it (both
    packages write no other), straight from the file, held to its CRC-32."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        n_name, n_extra = struct.unpack("<HH", f.read(30)[26:30])
        start = info.header_offset + 30 + n_name + n_extra
        f.seek(start)
        version = np.lib.format.read_magic(f) if info.compress_type == zipfile.ZIP_STORED else None
        if version not in ((1, 0), (2, 0)):
            raise ValueError(f"{path}: member {info.filename} is not a stored .npy of format "
                             f"1.0 or 2.0")
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        n_head = f.tell() - start
        f.seek(start)
        crc = zlib.crc32(f.read(n_head))
        a = np.fromfile(f, dtype=dtype, count=math.prod(shape))
    if a.size != math.prod(shape) or zlib.crc32(a, crc) != info.CRC:
        raise ValueError(f"{path}: member {info.filename} is truncated or corrupt")
    return a.reshape(shape[::-1]).T if fortran else a.reshape(shape)
