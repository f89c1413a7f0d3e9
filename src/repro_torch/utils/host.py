"""Tensors to and from host numpy arrays, bfloat16 included, and array-likes
onto a device.

numpy has no bfloat16: a bfloat16 tensor goes to the host as its 2-byte
words in a ``|V2`` array, the bytes and header of the reference's
``ml_dtypes`` array, which is what ``np.load`` returns for such a leaf in
either package, and comes back from them.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


def to_host(v, copy: bool = True) -> np.ndarray:
    """A tensor (on any device; copied unless ``copy=False`` and already on
    the host) or array-like as a numpy array; a bfloat16 tensor as its
    2-byte words (``|V2``)."""
    if torch.is_tensor(v):
        v = v.detach().to("cpu", copy=copy)
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.asarray(v)


def is_bf16_words(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2)


def from_host(a: np.ndarray, dtype: torch.dtype | None = None, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor on ``device``: ``|V2`` words (or an
    ``ml_dtypes`` bfloat16 array) as bfloat16; ``dtype`` casts the rest, and
    widens bfloat16 exactly (a bf16 model's residual, saved in its
    gradients' dtype, restores into the float32 one ``init_state`` makes, as
    the reference's ``astype`` does); nothing narrows to bfloat16."""
    device = torch.device(device)
    # np.load gives read-only arrays: a tensor left on the host gets its own copy
    if not a.flags.c_contiguous or (device.type == "cpu" and not a.flags.writeable):
        a = a.copy()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        t = torch.from_numpy(a.view(np.int16) if is_bf16_words(a) else a)
    if is_bf16_words(a):
        t = t.view(torch.bfloat16)
    if dtype is not None and t.dtype != dtype:
        widen = t.dtype == torch.bfloat16 and dtype in (torch.float32, torch.float64)
        if not widen and (t.dtype == torch.bfloat16 or dtype == torch.bfloat16):
            raise TypeError(f"a checkpoint leaf of {t.dtype} does not restore as {dtype}")
        t = t.to(dtype)
    return t.to(device)


def on_device(v, device) -> torch.Tensor:
    """A tensor, or a numpy array or array-like (copied), as a tensor on
    ``device``."""
    return (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))).to(device)
