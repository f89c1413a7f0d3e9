"""Sketched gradient compression: the paper's estimator applied to training
(the port of ``repro.core.grad_compress``, its shared-mask mode).

Gradients are flattened to one float32 vector (``utils/tree.py``, JAX's leaf
order) and cut into ``chunk_p``-value chunks (a power of two). Each chunk gets
the block-diagonal ROS ``y = H·D·g`` (K2, ``kernels/fwht.hd_precondition``, on
a CUDA tensor), keeps ``m = γ·chunk_p`` coordinates under the step's mask and
is unmixed by ``D·Hᵀ`` (K2 with the signs after the transform). All workers
use the same per-step mask, so only the m kept values a chunk would cross
the network. With error feedback the dropped mass is carried to the next
step in a residual, and the rescale by ``chunk_p / m`` is left out (rand-k +
EF); without it the round trip is the paper's unbiased estimator.

The keys are the repo's (seed, step, shard) discipline: a sketch spec over the
chunk length gives the signs key, and each step's mask is
``sample_indices(sketch.batch_key(spec, step, shard), nc, chunk_p, m)`` —
the reference's masks bit for bit.

At a billion parameters each (n_chunks, chunk_p) float32 intermediate is
gigabytes, so the round trip runs in place where it can: the kept values
are gathered and scattered back in row blocks into the transform's own
output, and the unmix's output becomes ĝ. The per-worker mode
(``perworker_mean_estimate``) needs a process group and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import ros
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.sampling import sample_indices
from repro_torch.utils.device import not_ported
from repro_torch.utils.tree import tree_flatten_to_vector, tree_leaves

# chunk rows gathered and scattered at a time (bounds the int64 index copy)
_ROW_BLOCK = 8192


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    gamma: float = 0.1
    chunk_p: int = 1 << 14            # ROS block size (power of two)
    error_feedback: bool = True
    mode: str = "shared-mask"         # "per-worker" is not ported

    @property
    def m(self) -> int:
        return max(1, int(round(self.gamma * self.chunk_p)))


def mask_spec(cfg: CompressConfig, key) -> sketch_mod.SketchSpec:
    """The compressor's sketch over one gradient chunk — the source of its
    signs key and per-(step, shard) mask keys (``sketch.batch_key``)."""
    return sketch_mod.make_spec(cfg.chunk_p, key, m=cfg.m, transform="hadamard")


def _to_chunks(vec: torch.Tensor, chunk_p: int):
    n = vec.shape[0]
    return torch.nn.functional.pad(vec, (0, -n % chunk_p)).reshape(-1, chunk_p), n


def padded_len(n: int, chunk_p: int) -> int:
    """Length of an n-value vector zero-padded to whole chunks."""
    return n + (-n % chunk_p)


def round_trip(chunks: torch.Tensor, key, step: int, cfg: CompressConfig,
               unbiased: bool | None = None, shard: int = 0):
    """ĝ and the wire payload of the zero-padded chunks (nc, chunk_p).

    Returns (g_hat (nc, chunk_p), vals (nc, m)). ``chunks`` is read only by
    the first transform, so a caller may free or overwrite it after; peak
    temporaries are two (nc, chunk_p) float32 arrays and the (nc, m) mask.
    """
    if unbiased is None:
        unbiased = not cfg.error_feedback
    if cfg.mode != "shared-mask":
        raise not_ported(f"gradient compression in mode {cfg.mode!r}", "LM side, last")
    spec = mask_spec(cfg, key)
    nc, cp = chunks.shape
    signs_key = spec.signs_key()
    y = ros.precondition(chunks, signs_key, "hadamard")
    idx = sample_indices(sketch_mod.batch_key(spec, step, shard), nc, cp, cfg.m,
                         device=chunks.device)
    vals = torch.empty((nc, cfg.m), dtype=y.dtype, device=y.device)
    scale = (cp / cfg.m) if unbiased else 1.0
    for r0 in range(0, nc, _ROW_BLOCK):             # y becomes ŷ in place
        r1 = min(nc, r0 + _ROW_BLOCK)
        at = idx[r0:r1].long()
        torch.gather(y[r0:r1], 1, at, out=vals[r0:r1])
        y[r0:r1].zero_().scatter_(1, at, vals[r0:r1])
        if unbiased:
            y[r0:r1].mul_(scale)
    del idx
    return ros.unmix(y, signs_key, "hadamard"), vals


def compress_decompress(vec: torch.Tensor, key, step: int, cfg: CompressConfig,
                        unbiased: bool | None = None, shard: int = 0):
    """Shared-mask round trip g → ĝ of one (flat, float32) gradient vector.

    Returns (g_hat, kept_values): in a collective only ``kept_values`` (m a
    chunk) crosses the network; the reconstruction is local. ``shard`` folds
    into the mask key as a stream shard's id does; shared-mask mode keeps 0
    on every worker. ``unbiased`` (default: without error feedback) applies
    the paper's ``chunk_p / m`` rescale (Thm 4).
    """
    chunks, n = _to_chunks(vec, cfg.chunk_p)
    g_hat, vals = round_trip(chunks, key, int(step), cfg, unbiased, shard)
    return g_hat.reshape(-1)[:n], vals


def compress_flat(flat: torch.Tensor, key, step: int, cfg: CompressConfig, shard: int = 0):
    """The round trip of a gradient already flattened and zero-padded.

    ``flat`` is the (padded_len(n, chunk_p),) float32 vector g + r (the
    gradient plus the error-feedback residual). Returns (g_hat, residual,
    wire_floats): ``g_hat`` a new padded vector; ``residual`` is ``flat``
    itself overwritten with g + r − ĝ under error feedback (else None). Only
    the first n values of either mean anything.
    """
    g_hat, vals = round_trip(flat.view(-1, cfg.chunk_p), key, step, cfg, shard=shard)
    g_hat = g_hat.view(-1)
    residual = flat.sub_(g_hat) if cfg.error_feedback else None
    return g_hat, residual, vals.numel()


def compress_grads(grads: Any, key, step: int, cfg: CompressConfig,
                   residual: Any | None = None, shard: int = 0):
    """Apply sketch compression to a gradient tree (+ error feedback).

    Returns (g_hat tree, new_residual tree or None, wire_floats int), each
    leaf in the gradients' dtype, as the reference's.
    """
    n = sum(l.numel() for l in tree_leaves(grads))
    vec, unflatten = tree_flatten_to_vector(grads, padded_len(n, cfg.chunk_p))
    if residual is not None:
        vec[:n] += tree_flatten_to_vector(residual)[0]
    g_hat, new_residual, wire = compress_flat(vec, key, int(step), cfg, shard)
    return (unflatten(g_hat), None if new_residual is None else unflatten(new_residual),
            wire)


def wire_bytes(p_total: int, cfg: CompressConfig, n_workers: int) -> dict:
    """Napkin accounting of one step's traffic, dense against compressed."""
    dense = 2 * p_total * 4                                   # ring all-reduce ≈ 2p
    if cfg.mode == "shared-mask":
        comp = 2 * int(p_total * cfg.gamma) * 4
    else:
        comp = n_workers * int(p_total * cfg.gamma) * 8       # values+indices gather
    return {"dense_bytes": dense, "compressed_bytes": comp, "ratio": comp / dense}
