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

A placed state (``train/fsdp.py``; ``save`` called by every rank) is
written as the reference's tree: each leaf gathered whole to rank 0, one
leaf at a time (over gloo staged through the host, so rank 0's card holds
no other rank's block), the residual one tree. ``restore`` into a placed
``like`` holds every member to its CRC-32 (each member read through by one
rank) and then reads only the rank's own block of each leaf and its part
of the residual. A checkpoint that holds each rank's residual
(``['rank_residual'][r]…``) beside their mean ``['residual']`` restores,
placed or whole, to the mean, the reference's residual.

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

from repro_torch.cluster.bootstrap import process_index
from repro_torch.utils.host import from_host, is_bf16_words, to_host
from repro_torch.utils.tree import tree_leaves_with_path, tree_unflatten

_SAVE_LOCK = threading.Lock()
_PENDING: list[threading.Thread] = []
# members of arrays.npz read at once
READ_THREADS = 8


def save(ckpt_dir: str, step: int, state, extra: dict | None = None,
         async_: bool = True, keep_last: int = 3) -> None:
    """Snapshot the tree ``state`` (+ JSON-serializable ``extra``, e.g. the
    data pipeline's cursor) as step ``step``; its leaves are copied to the
    host before this returns, so the caller may update them in place.

    A placed state is saved by every rank together: its leaves gathered
    whole to rank 0, which writes them (the module docstring)."""
    from repro_torch.train.fsdp import PlacedState

    if isinstance(state, PlacedState):
        arrays = _gather_placed(state)
        if process_index() == 0:
            _save_arrays(ckpt_dir, step, arrays, extra, async_, keep_last)
        return
    _save_arrays(ckpt_dir, step, {k: to_host(v) for k, v in tree_leaves_with_path(state)},
                 extra, async_, keep_last)


def _gather_placed(state) -> dict | None:
    """A placed state's leaves, whole, as host arrays on rank 0 (None on
    the other ranks): a leaf's blocks by one gather to rank 0, a residual
    leaf's parts sent to it by the ranks that hold one."""
    from repro_torch.train.fsdp import RES

    layout = state.layout
    rank, world = layout.rank, layout.world
    staged = torch.distributed.get_backend() == "gloo"
    out = {} if rank == 0 else None
    for name, leaf in tree_leaves_with_path(state):
        t = leaf.detach().to("cpu", copy=True) if staged else leaf.detach()
        if name.startswith(RES):
            i = layout.params.index(name[len(RES):])
            whole = (torch.empty((layout.param(i).numel,), dtype=t.dtype) if rank == 0
                     else None)
            for r in range(world):
                a, b = layout.part(i, r)
                if b == a:
                    continue
                if r == rank == 0:
                    whole[a:b] = t
                elif rank == 0:
                    buf = torch.empty((b - a,), dtype=t.dtype, device=t.device)
                    torch.distributed.recv(buf, src=r)
                    whole[a:b] = buf.to("cpu")
                elif rank == r:
                    torch.distributed.send(t.contiguous(), dst=0)
            if rank == 0:
                out[name] = to_host(whole.view(layout.param(i).shape), copy=False)
            continue
        place = layout.places[name]
        if place.dim is None:
            if rank == 0:
                out[name] = to_host(t)
            continue
        parts = [torch.empty_like(t) for _ in range(world)] if rank == 0 else None
        torch.distributed.gather(t.contiguous(), parts, dst=0)
        if rank == 0:
            out[name] = to_host(torch.cat([q.to("cpu") for q in parts], place.dim), copy=False)
    return out


def restore(ckpt_dir: str, like, device=None) -> tuple[dict, dict]:
    """Load the latest checkpoint into the structure, dtypes and devices of the
    tree ``like`` (or onto ``device``). Returns (state, extra); raises
    FileNotFoundError if there is no checkpoint.

    Into a placed ``like`` (``train/fsdp.py``; called by every rank) each
    rank reads its own block of every leaf and its part of the residual;
    into a whole ``like`` every leaf is restored whole."""
    from repro_torch.train.fsdp import PlacedState

    d = latest_step_dir(ckpt_dir)
    if d is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    if isinstance(like, PlacedState):
        return _restore_placed(os.path.join(d, "arrays.npz"), like, device), meta.get("extra", {})
    specs = tree_leaves_with_path(like)
    arrays = _read_npz(os.path.join(d, "arrays.npz"), [name for name, _ in specs])
    leaves = [from_host(a, spec.dtype, spec.device if device is None else device)
              for (_, spec), a in zip(specs, arrays)]
    return tree_unflatten(like, leaves), meta.get("extra", {})


def _restore_placed(path: str, like, device):
    """The placed state of ``like``'s layout from an ``.npz``: each leaf's
    block (a residual leaf's part), read from the member mapped in place
    once every member has passed its CRC-32 (:func:`_check_members`),
    ``READ_THREADS`` members at a time."""
    from repro_torch.train.fsdp import RES, PlacedState

    layout = like.layout
    with zipfile.ZipFile(path) as zf:
        have = {info.filename: info for info in zf.infolist()}
    names = tree_leaves_with_path(like)
    missing = [n for n, _ in names if n + ".npy" not in have]
    if missing:
        raise KeyError(f"checkpoint missing leaf {missing[0]}")
    _check_members(path, [have[n + ".npy"] for n, _ in names], layout,
                   names[0][1].device if device is None else device)

    def block(name: str) -> np.ndarray:
        a = _map_member(path, have[name + ".npy"])
        if name.startswith(RES):
            lo, hi = layout.part(layout.params.index(name[len(RES):]), layout.rank)
            a = a.reshape(-1)[lo:hi]
        else:
            place = layout.places[name]
            if tuple(a.shape) != place.shape:
                raise ValueError(f"checkpoint leaf {name} is {a.shape}, the state's {place.shape}")
            a = place.block(a, layout.rank)
        # a copy of what was sliced: only those pages are read
        return np.array(a)

    blocks = _read_ahead(block, [name for name, _ in names])
    leaves = [from_host(a, spec.dtype, spec.device if device is None else device)
              for (_, spec), a in zip(names, blocks)]
    return PlacedState(tree_unflatten(like, leaves), layout)


def _check_members(path: str, infos: list, layout, device) -> None:
    """Hold each member of ``infos`` to its zip CRC-32, member j read
    through by rank ``j mod world`` (``READ_THREADS`` at a time); one
    all-reduce of a flag on ``device`` tells every rank. Raises ValueError
    on every rank if a member is truncated or corrupt."""
    mine = [info for j, info in enumerate(infos) if j % layout.world == layout.rank]

    def intact(info: zipfile.ZipInfo) -> bool:
        try:
            with zipfile.ZipFile(path) as zf, zf.open(info) as f:
                while f.read(1 << 26):
                    pass
        except (zipfile.BadZipFile, EOFError):
            return False
        return True

    bad = next((info.filename for info, ok in zip(mine, _read_ahead(intact, mine)) if not ok),
               None)
    flag = torch.tensor([int(bad is not None)], dtype=torch.int32, device=device)
    torch.distributed.all_reduce(flag)
    if int(flag.item()):
        raise ValueError(f"{path}: member {bad or 'read by another rank'} is truncated or corrupt")


def _map_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """One stored ``.npy`` member of an ``.npz`` mapped from the file,
    read-only (only what is sliced from it is read)."""
    with open(path, "rb") as f:
        _, shape, fortran, dtype = _member_header(f, path, info)
        offset = f.tell()
    # a 0-d member maps as one value
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=tuple(shape) or (1,),
                     order="F" if fortran else "C").reshape(shape)


def _member_header(f, path: str, info: zipfile.ZipInfo):
    """(the member's offset, shape, Fortran order, dtype) of a stored
    ``.npy`` member, ``f`` left at its data."""
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
    return (start, *read_header(f))


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

    return _read_ahead(lambda n: _read_member(path, have[n + ".npy"]), names)


def _read_ahead(fn, items):
    """``fn(item)`` for each of ``items``, in order, as a generator: run by
    ``READ_THREADS`` threads, at most ``READ_THREADS`` ahead of the one
    taken."""
    with ThreadPoolExecutor(READ_THREADS) as pool:
        ahead = collections.deque()
        for item in items:
            ahead.append(pool.submit(fn, item))
            if len(ahead) > READ_THREADS:
                yield ahead.popleft().result()
        while ahead:
            yield ahead.popleft().result()


def _read_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """One ``.npy`` member of an ``.npz`` as ``np.savez`` stores it (both
    packages write no other), straight from the file, held to its CRC-32."""
    with open(path, "rb") as f:
        start, shape, fortran, dtype = _member_header(f, path, info)
        n_head = f.tell() - start
        f.seek(start)
        crc = zlib.crc32(f.read(n_head))
        a = np.fromfile(f, dtype=dtype, count=math.prod(shape))
    if a.size != math.prod(shape) or zlib.crc32(a, crc) != info.CRC:
        raise ValueError(f"{path}: member {info.filename} is truncated or corrupt")
    return a.reshape(shape[::-1]).T if fortran else a.reshape(shape)
