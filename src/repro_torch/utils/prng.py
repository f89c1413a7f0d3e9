"""Counter-based PRNG that reproduces ``jax.random`` bit for bit.

The port's randomness contract is the reference's: every sign vector, mask and
K-means++ draw regenerates from ``(root key, step, shard)``. So this module is
threefry-2x32 in both of JAX's layouts, chosen as JAX chooses them:

- partitionable (``jax_threefry_partitionable=True``, the default here and in
  JAX since 0.5): element ``j`` of a draw of ``N`` is a hash of the key and
  the count pair ``(j >> 32, j & M32)``, its two output words xored; ``split``
  hashes ``(0, i)`` into key ``i``.
- original (the default of JAX 0.4): the counts ``0 … N−1`` are padded with
  one zero to an even length and halved; pair ``j`` is ``(j, j + ⌈N/2⌉)``,
  whose first word is element ``j`` and whose second is element
  ``j + ⌈N/2⌉``. ``split(key, num)`` is such a draw of ``2·num`` words. Past
  ``2^32 − 1`` words the draw is split into that many keys, one a block.

:func:`set_threefry_partitionable` and the context manager
:func:`threefry_partitionable` switch the layout for the whole process, after
``jax.config.update("jax_threefry_partitionable", …)`` and
``jax.threefry_partitionable(…)``; a process starts in the partitionable
layout unless the environment sets ``REPRO_TORCH_THREEFRY_PARTITIONABLE=0``
(as ``JAX_THREEFRY_PARTITIONABLE`` does for JAX). ``fold_in`` and
``PRNGKey`` are the same in both.

Keys are numpy ``uint32[2]`` on the host — the same key data
``jax.random.key_data`` returns. Bits are generated on the target device in
int64 tensors holding 32-bit values, in chunks of rows, so an (n, p) draw never
needs more than a bounded scratch.
"""
from __future__ import annotations

import contextlib
import hashlib
import math
import os

import numpy as np
import torch

from repro_torch.roofline.counter import host_work

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements hashed per chunk: bounds the int64 scratch of one draw to ~256 MiB
_CHUNK = 1 << 24
# elements the normal's erfinv takes at a time
_ERFINV_CHUNK = 1 << 18
# words the original layout hashes under one key before it splits the key
_BLOCK = M32
# the layout of every draw in this process: {"partitionable": bool}; a
# process starts in the one REPRO_TORCH_THREEFRY_PARTITIONABLE names (0 or 1,
# default 1), so a launcher's child processes can draw as the reference does
_LAYOUT = {"partitionable": os.environ.get("REPRO_TORCH_THREEFRY_PARTITIONABLE", "1").strip()
           .lower() not in ("0", "false", "no")}


def set_threefry_partitionable(flag: bool) -> None:
    """Draw in the partitionable layout (``True``, the default) or JAX's
    original one (``False``) from now on, in every thread of the process."""
    _LAYOUT["partitionable"] = bool(flag)


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """Draw in the given layout inside the block, then restore the one before."""
    before = _LAYOUT["partitionable"]
    set_threefry_partitionable(flag)
    try:
        yield
    finally:
        set_threefry_partitionable(before)


def _threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 hash of count pairs ``(x0, x1)``, in place.

    ``x0``/``x1`` are int64 tensors holding uint32 values; they are
    overwritten with the two output words.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0.add_(ks[0]).bitwise_and_(M32)
    x1.add_(ks[1]).bitwise_and_(M32)
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            x1.bitwise_left_shift_(r).bitwise_or_(tmp).bitwise_and_(M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    return x0, x1


def _key_ints(key) -> tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a threefry key is uint32[2], got shape {k.shape}")
    return int(k[0]), int(k[1])


def _hash_pairs(key, hi, lo) -> np.ndarray:
    """Hash a few count pairs on the host → (2, len) uint32."""
    with host_work():
        x0 = torch.tensor(hi, dtype=torch.int64)
        x1 = torch.tensor(lo, dtype=torch.int64)
        y0, y1 = _threefry2x32(*_key_ints(key), x0, x1)
        return np.stack([y0.numpy(), y1.numpy()]).astype(np.uint32)


# ------------------------------------------------------------------ keys ----

def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` key data (32-bit mode: the seed's low word)."""
    return np.array([0, int(seed) & M32], dtype=np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in``: hash the pair (0, data) under ``key``."""
    out = _hash_pairs(key, [0], [int(data) & M32])
    return out[:, 0]


def fold_in_str(key, tag: str) -> np.ndarray:
    """Derive a subkey from ``key`` using a stable hash of ``tag``."""
    h = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:4], "little")
    return fold_in(key, h)


def key_for_step(key, step: int) -> np.ndarray:
    """Per-step key (``fold_in`` of the step)."""
    return fold_in(key, step)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split`` → (num, 2) uint32 keys."""
    if not _LAYOUT["partitionable"]:
        words = np.empty(2 * num, dtype=np.uint32)   # threefry_2x32(key, iota(2·num))
        with host_work():
            for start, bits in _original_block(key, 2 * num, 0, 2 * num, "cpu"):
                words[start:start + bits.numel()] = bits.numpy()
        return words.reshape(num, 2)
    out = _hash_pairs(key, [0] * num, list(range(num)))
    return np.ascontiguousarray(out.T)


# ------------------------------------------------------------------ bits ----

def _bits_chunks(key, numel: int, device, offset: int = 0, total: int | None = None):
    """Yield ``(start, bits)`` covering the flat indices ``offset … offset +
    numel`` of a draw of ``total`` words (default ``offset + numel``) once,
    in some order, ``start`` counted from ``offset``, ``bits`` int64."""
    total = offset + numel if total is None else total
    if offset < 0 or offset + numel > total:
        raise ValueError(f"elements [{offset}, {offset + numel}) lie outside a draw of {total}")
    if not _LAYOUT["partitionable"]:
        yield from _original_chunks(key, numel, device, offset, total)
        return
    k1, k2 = _key_ints(key)
    for start in range(0, numel, _CHUNK):
        count = min(_CHUNK, numel - start)
        idx = torch.arange(offset + start, offset + start + count, dtype=torch.int64,
                           device=device)
        hi = idx >> 32
        lo = idx.bitwise_and_(M32)
        y0, y1 = _threefry2x32(k1, k2, hi, lo)
        yield start, y0.bitwise_xor_(y1)


def _original_chunks(key, numel: int, device, offset: int, total: int):
    """:func:`_bits_chunks` in the original layout: the draw's blocks of
    ``_BLOCK`` words, each under its own key of ``split(key, nblocks + 1)``
    once there are more than one, and in each block the words asked for."""
    nblocks, rem = divmod(total, _BLOCK)
    keys = split(key, nblocks + 1) if nblocks else [key]
    for b, bkey in enumerate(keys):
        base, size = b * _BLOCK, (_BLOCK if b < nblocks else rem)
        s, e = max(offset, base), min(offset + numel, base + size)
        if s < e:
            for start, bits in _original_block(bkey, size, s - base, e - base, device):
                yield base + start - offset, bits


def _original_block(key, n: int, s: int, e: int, device):
    """Words ``[s, e)`` of ``threefry_2x32(key, iota(n))``: yield
    ``(start, bits)`` with ``start`` counted from 0.

    Pair ``a < h = ⌈n/2⌉`` hashes ``(a, a + h)`` (``(a, 0)`` where ``a + h``
    is the odd draw's pad) into words ``a`` and ``a + h``. Words of the first
    half need the pairs ``[s, min(e, h))``, words of the second the pairs
    ``[max(s, h) − h, e − h)``; each pair that either needs is hashed once.
    """
    k1, k2 = _key_ints(key)
    h = (n + 1) // 2
    first = (s, min(e, h))
    second = (max(s, h) - h, e - h)
    ranges = [r for r in (first, second) if r[0] < r[1]]
    if len(ranges) == 2 and ranges[1][0] <= ranges[0][1] and ranges[0][0] <= ranges[1][1]:
        ranges = [(min(first[0], second[0]), max(first[1], second[1]))]
    for lo, hi in ranges:
        for a0 in range(lo, hi, _CHUNK):
            a1 = min(hi, a0 + _CHUNK)
            x0 = torch.arange(a0, a1, dtype=torch.int64, device=device)
            x1 = x0 + h
            x1.masked_fill_(x1 >= n, 0)
            y0, y1 = _threefry2x32(k1, k2, x0, x1)
            # word a of the first half, word a + h of the second
            f0, f1 = max(a0, first[0]), min(a1, first[1])
            if f0 < f1:
                yield f0, y0[f0 - a0:f1 - a0]
            g0, g1 = max(a0, second[0]), min(a1, second[1])
            if g0 < g1:
                yield g0 + h, y1[g0 - a0:g1 - a0]


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor."""
    shape = tuple(shape)
    out = torch.empty(math.prod(shape), dtype=torch.int64, device=device)
    for start, bits in _bits_chunks(key, out.numel(), device):
        out[start:start + bits.numel()] = bits
    return out.reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu", offset: int = 0, total: int | None = None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits in [1, 2) − 1.

    With ``offset`` and ``total`` the draw is the part of a draw of ``total``
    elements under ``key`` that starts at flat index ``offset``: rows
    ``[r0, r1)`` of an ``(n, p)`` draw are ``uniform(key, (r1 - r0, p),
    offset=r0 * p, total=n * p)``. The original layout pairs elements across
    the halves of the whole draw, so it needs ``total``; the partitionable
    one ignores it.
    """
    shape = tuple(shape)
    out = torch.empty(math.prod(shape), dtype=torch.float32, device=device)
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    for start, bits in _bits_chunks(key, out.numel(), device, offset, total):
        f = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
        f = f.to(torch.int32).view(torch.float32) - 1.0
        out[start:start + f.numel()] = torch.maximum(lo, f * span + lo)
    return out.reshape(shape)


# Giles' single-precision erfinv, the polynomial XLA lowers ``lax.erf_inv`` to:
# coefficients for w = -log1p(-x²) below 5 and at or above it
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)

# XLA's float32 log1p on the CPU (Cephes), as its compiled code evaluates it.
# Below |t| = 0.41421357: t + (t³·P(t)/Q(t) − t²/2), P and Q by Horner's rule.
_LOG1P_P = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967, 57.112965, 20.039553)
_LOG1P_Q = (1.0, 15.062909, 83.04757, 221.7624, 309.09872, 216.42789, 60.11866)
# Above it: Cephes logf of w = 1 + t from w's exponent and mantissa, its
# polynomial in three chains of three coefficients
_LOGF = ((0.070376836, -0.1151461, 0.116769984), (-0.12420141, 0.14249323, -0.16668057),
         (0.20000714, -0.24999994, 0.3333333))


def _f32(x) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a·b + c rounded once, as an FMA instruction does.

    a·b is exact in float64, so s = a·b + c in float64 is rounded once. s
    rounds to float32 as the exact sum does unless s lies on a float32
    midpoint (its low 29 mantissa bits 1 and 28 zeros) that the exact sum
    does not: only those few elements take the exact remainder (TwoSum) and
    step off the midpoint towards it. ``b`` and ``c`` are float32 tensors or
    Python floats that float32 holds exactly.
    """
    s = a.double() * b + c
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    out = s.float()
    if bool(mid.any()):
        at = mid.nonzero(as_tuple=True)
        pick = (lambda x: x[at] if torch.is_tensor(x) and x.ndim else x)
        ab = a[at].double() * (pick(b).double() if torch.is_tensor(b) else b)
        cc = pick(c).double() if torch.is_tensor(c) else c
        sm = s[at]
        bb = sm - ab
        err = (ab - (sm - bb)) + (cc - bb)
        toward = torch.where(err > 0, math.inf, torch.where(err < 0, -math.inf, sm))
        out[at] = torch.nextafter(sm, toward).float()
    return out


def _horner(coefs, t: torch.Tensor) -> torch.Tensor:
    """coefs[0]·tⁿ + … by Horner's rule, each step fused."""
    p = torch.full_like(t, coefs[0])
    for c in coefs[1:]:
        p = _fma(p, t, _f32(c))
    return p


def log1p_xla(t: torch.Tensor) -> torch.Tensor:
    """float32 log1p(t) for t in (-1, 0], bit for bit as XLA's CPU code on a
    host with FMA: the operations of its LLVM IR in their order, with the
    multiply-adds that its object code fuses (``_fma``) fused."""
    t2 = t * t
    ratio = _horner(_LOG1P_P, t) / _horner(_LOG1P_Q, t)
    near0 = t + ((t * t2) * ratio - 0.5 * t2)
    # log(w) = log(m) + e·ln 2 for w = m·2^e, m in [√½, √2)
    w = torch.clamp(t + 1.0, min=2.0 ** -126)
    bits = w.view(torch.int32)
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)       # [0.5, 1)
    low = mant < 0.70710677
    e = ((bits >> 23) - 127).float() + 1.0
    e = torch.where(low, e - 1.0, e)
    xm = (mant - 1.0) + torch.where(low, mant, torch.zeros_like(mant))
    z = xm * xm
    z3 = z * xm
    a, b, c = (_fma(_fma(xm, _f32(ch[0]), _f32(ch[1])), xm, _f32(ch[2])) for ch in _LOGF)
    y = _fma(_fma(_fma(a, z3, b), z3, c), z3, e * -2.1219444e-4)
    far = _fma(e, _f32(0.6933594), (xm - 0.5 * z) + y)
    return torch.where(t.abs() < 0.41421357, near0, far)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function for |x| < 1 (±inf at ±1), bit for bit
    as XLA's CPU code on a host with FMA evaluates ``lax.erf_inv``: Giles'
    approximation on :func:`log1p_xla`, its polynomial fused.

    ``torch.erfinv`` is another approximation. The square root is taken in
    float64 and rounded (the correctly rounded float32 root, as the compiled
    ``vsqrtps``): float32 ``torch.sqrt`` on the CPU has been seen to return
    values 1e-4 off in a few elements in some processes.
    """
    w = -log1p_xla(-(x * x))
    p = _horner(_ERFINV_SMALL, w - 2.5)
    large = w >= 5.0   # few: |x| above 0.9966
    if bool(large.any()):
        at = large.nonzero(as_tuple=True)
        p[at] = _horner(_ERFINV_LARGE, torch.sqrt(w[at].double()).float() - 3.0)
    return x * torch.where(x.abs() == 1.0, torch.full_like(p, math.inf), p)


def normal(key, shape, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32 or bfloat16: √2·erfinv(uniform(-1⁺, 1)),
    bit for bit as JAX's on a CPU host with FMA (see :func:`erfinv`).

    In bfloat16 JAX draws one random byte an element (a bfloat16 mantissa
    has 7 bits), takes its top 7 bits as the uniform's mantissa, and
    multiplies bfloat16 √2 by erfinv's float32 value rounded to bfloat16:
    128 possible values, taken from a table of them."""
    if dtype == torch.bfloat16:
        return _normal_bf16(key, tuple(shape), device)
    if dtype != torch.float32:
        raise TypeError(f"normal draws float32 or bfloat16, not {dtype}")
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device).reshape(-1)
    root2 = torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=device)
    for part in u.split(_ERFINV_CHUNK):   # each slice's temporaries stay in cache
        part.copy_(root2 * erfinv(part))
    return u.reshape(shape)


def _random_bytes(key, n: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint8)`` as an int64 tensor: the low byte
    of each word in the partitionable layout; in the original one a draw of
    ⌈n/4⌉ words, each giving four elements from its low byte up."""
    if _LAYOUT["partitionable"]:
        return random_bits(key, (n,), device).bitwise_and_(0xFF)
    words = random_bits(key, (-(-n // 4),), device)
    return torch.stack([(words >> (8 * i)) & 0xFF for i in range(4)], dim=1).reshape(-1)[:n]


def _normal_bf16(key, shape: tuple, device) -> torch.Tensor:
    bf16 = torch.bfloat16
    one = torch.tensor(1.0, dtype=bf16)
    lo = torch.tensor(-1.0 + 2.0 ** -8, dtype=bf16)          # nextafter(-1, 0) in bfloat16
    # the 128 uniforms in bfloat16 arithmetic, as JAX computes them
    mant = (torch.arange(128, dtype=torch.int16) | 0x3F80).view(bf16) - one
    u = torch.maximum(lo, mant * (one - lo) + lo)
    table = (torch.tensor(np.sqrt(2.0), dtype=bf16) * erfinv(u.float()).to(bf16)).to(device)
    return table[_random_bytes(key, math.prod(shape), device) >> 1].reshape(shape)


def bernoulli(key, p: float = 0.5, shape=(), device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli`` ("low" mode): ``uniform < p``."""
    return uniform(key, shape, device=device) < p


def rademacher(key, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """±1 entries with equal probability (the diagonal of D in the ROS)."""
    b = bernoulli(key, 0.5, shape, device=device).to(dtype)
    return (2 * b - 1).to(dtype)


def randint(key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint`` for int32: two 32-bit draws folded into the span."""
    if not (-(1 << 31) <= minval and maxval <= (1 << 31) - 1):
        raise ValueError("randint supports the int32 range only")
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = 1 if maxval <= minval else (maxval - minval) & M32
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((higher % span) * mult).bitwise_and_(M32).add_(lower % span)
    off = off.bitwise_and_(M32) % span
    return (off + minval).to(torch.int32)


def gumbel(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.gumbel`` ("low" mode) in float32."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0, device=device)))


def categorical(key, logits: torch.Tensor, shape=None) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of 1-D ``logits``
    (Gumbel-max; ``shape`` is the sample shape)."""
    if logits.ndim != 1:
        raise ValueError("categorical takes 1-D logits here")
    shape = () if shape is None else tuple(shape)
    g = gumbel(key, (*shape, logits.shape[0]), device=logits.device)
    return torch.argmax(g + logits, dim=-1)


def permutation(key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` stably sorted by
    fresh 32-bit keys, ⌈3·log n / log(2³² − 1)⌉ rounds (JAX's ``_shuffle``)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device), stable=True).indices
        x = x[order]
    return x


def choice(key, a: int, shape=(), replace: bool = True, p: torch.Tensor | None = None,
           device="cpu") -> torch.Tensor:
    """``jax.random.choice(key, a, shape, replace, p)`` for an int population
    ``a`` (indices into ``arange(a)``), int64.

    The four paths of the reference: uniform with replacement (``randint``),
    uniform without (a :func:`permutation`'s head), weighted with replacement
    (the cumulative sum searched at ``total·(1 − u)``) and weighted without
    (the Gumbel top-k trick: ``gumbel + log p``, the ``m`` largest, ties to the
    lower index as ``lax.top_k`` breaks them). ``p`` is float32 on ``device``.
    """
    shape = tuple(shape)
    n_draws = math.prod(shape)
    if not replace and n_draws > a:
        raise ValueError(f"Cannot take a larger sample (size {n_draws}) than "
                         f"population (size {a}) when 'replace=False'")
    if p is None:
        if replace:
            return randint(key, shape, 0, a, device=device).to(torch.int64)
        return permutation(key, a, device)[:n_draws].reshape(shape)
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    if p.shape != (a,):
        raise ValueError(f"p must be a 1-D vector of size {a}, got shape {tuple(p.shape)}")
    if replace:
        cum = torch.cumsum(p, 0)
        r = cum[-1] * (1 - uniform(key, shape, device=device))
        return torch.searchsorted(cum, r).reshape(shape)
    g = gumbel(key, (a,), device=device) + torch.log(p)
    return torch.sort(g, descending=True, stable=True).indices[:n_draws].reshape(shape)
