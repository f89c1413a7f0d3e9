"""Counter-based PRNG that reproduces ``jax.random`` bit for bit.

The port's randomness contract is the reference's: every sign vector, mask and
K-means++ draw regenerates from ``(root key, step, shard)``. So this module is
threefry-2x32 in the layout JAX uses with ``jax_threefry_partitionable=True``
(each element's bits are a hash of the key and the element's flat index).

Keys are numpy ``uint32[2]`` on the host — the same key data
``jax.random.key_data`` returns. Bits are generated on the target device in
int64 tensors holding 32-bit values, in chunks of rows, so an (n, p) draw never
needs more than a bounded scratch.

The original (non-partitionable) layout is not implemented.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements hashed per chunk: bounds the int64 scratch of one draw to ~256 MiB
_CHUNK = 1 << 24
# elements the normal's erfinv takes at a time
_ERFINV_CHUNK = 1 << 18


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
    out = _hash_pairs(key, [0] * num, list(range(num)))
    return np.ascontiguousarray(out.T)


# ------------------------------------------------------------------ bits ----

def _bits_chunks(key, numel: int, device):
    """Yield ``(start, bits)`` over the flat index range, ``bits`` int64."""
    k1, k2 = _key_ints(key)
    for start in range(0, numel, _CHUNK):
        count = min(_CHUNK, numel - start)
        idx = torch.arange(start, start + count, dtype=torch.int64, device=device)
        hi = idx >> 32
        lo = idx.bitwise_and_(M32)
        y0, y1 = _threefry2x32(k1, k2, hi, lo)
        yield start, y0.bitwise_xor_(y1)


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor."""
    shape = tuple(shape)
    out = torch.empty(math.prod(shape), dtype=torch.int64, device=device)
    for start, bits in _bits_chunks(key, out.numel(), device):
        out[start:start + bits.numel()] = bits
    return out.reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits in [1, 2) − 1."""
    shape = tuple(shape)
    out = torch.empty(math.prod(shape), dtype=torch.float32, device=device)
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    for start, bits in _bits_chunks(key, out.numel(), device):
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


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal`` in float32: √2·erfinv(uniform(-1⁺, 1)), bit for
    bit as JAX's on a CPU host with FMA (see :func:`erfinv`)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device).reshape(-1)
    root2 = torch.tensor(np.sqrt(2.0), dtype=torch.float32, device=device)
    for part in u.split(_ERFINV_CHUNK):   # each slice's temporaries stay in cache
        part.copy_(root2 * erfinv(part))
    return u.reshape(shape)


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
