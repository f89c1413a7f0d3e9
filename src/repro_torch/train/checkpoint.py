"""Atomic array checkpoints, in the reference's on-disk layout.

One directory per step::

    ckpt_dir/step_000000123/
        manifest.json      — keys, shapes, dtypes and the caller's JSON ``extra``
        arrays.npz         — the flat ``{name: array}`` dict
    ckpt_dir/latest        — the name of the newest step directory

A write goes to ``step_….tmp`` and is renamed into place, and ``latest`` is
replaced atomically after it, so a write cut half way never corrupts the
newest checkpoint; ``keep_last`` older step directories are kept. This is
the layout of ``repro.train.checkpoint.save_arrays`` / ``load_arrays``, so a
checkpoint written by either package loads in the other. The pytree
``save`` / ``restore`` of the reference (its trainer's) is not here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

_SAVE_LOCK = threading.Lock()
_PENDING: list[threading.Thread] = []


def _host(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_arrays(ckpt_dir: str, step: int, arrays: dict, extra: dict | None = None,
                async_: bool = False, keep_last: int = 3) -> None:
    """Snapshot a flat ``{name: array}`` dict (numpy arrays or tensors, copied
    to the host before this returns) with JSON ``extra`` as step ``step``."""
    arrays = {k: _host(v) for k, v in arrays.items()}
    meta = {
        "step": step,
        "treedef": None,
        "keys": list(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
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
    with np.load(os.path.join(d, "arrays.npz")) as data:
        arrays = {k: data[k] for k in meta["keys"]}
    return arrays, meta.get("extra", {})
