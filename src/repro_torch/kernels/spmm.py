"""K5 spmm and K6 spmm_t: sparse-times-dense products — the CUDA kernels' wrappers.

Replace the TPU kernels ``repro.kernels.spmm.spmm`` and ``spmm_t``
(``csrc/spmm.cu``). Over compact sparse rows W (values (n, m), indices
(n, m) in [0, p)) and a narrow dense operand of l columns:

    spmm:    T = W @ Ω      (n, l)
    spmm_t:  Y = Wᵀ @ T     (p, l)

The reference plans VMEM tiles (``plan_tiles``, ``tile_vmem_bytes``); these
kernels use no shared memory and take any p and l, so nothing here replaces
that model. What they do need is checked here: float32 operands (the plain
versions keep the reference's promotion rule for other types, see
``kernels.ref.spmm_out_dtype``), int32 indices, and fewer than 2^31 entries.
Indices must lie in [0, p): the kernels do not check them.

``spmm_t`` first buckets the entries by column with a stable sort
(:func:`column_buckets`, PyTorch ops), so its kernel sums each column in row
order without atomics and repeated calls are bit-identical. With
``col_sums=True`` the same launch also returns each column's Σv and Σv² (the
range-finder's ``sum_w`` and ``diag``), just as reproducible.

On a CPU tensor the wrappers compute the plain versions; on a CUDA tensor
they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref


def _check(values: torch.Tensor, indices: torch.Tensor, dense: torch.Tensor, what: str):
    _build.require(values, torch.float32, 2, "values")
    _build.require(indices, torch.int32, 2, "indices", device=values.device)
    _build.require(dense, torch.float32, 2, what, device=values.device)
    if indices.shape != values.shape:
        raise ValueError(f"indices {tuple(indices.shape)} != values {tuple(values.shape)}")
    if values.numel() >= 1 << 31:
        raise ValueError(f"{values.numel()} entries: the kernels index them with int32")


def _vec4(*ts: torch.Tensor) -> int:
    """1 when every operand's rows are whole float4s (l % 4 == 0, 16-byte aligned)."""
    return int(all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0 for t in ts))


def spmm(values: torch.Tensor, indices: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """T (n, l) = W @ dense for compact sparse rows W and dense (p, l)."""
    if values.device.type == "cpu":
        return _ref.ref_spmm(values, indices, dense)
    _check(values, indices, dense, "dense")
    n, m = values.shape
    ell = dense.shape[1]
    out = torch.empty((n, ell), dtype=torch.float32, device=values.device)
    if not (n and ell):
        return out
    if m == 0:
        return out.zero_()
    lib = _build.library("spmm")
    with torch.cuda.device(values.device):
        err = lib.spmm_f32(values.data_ptr(), indices.data_ptr(), dense.data_ptr(),
                           out.data_ptr(), n, m, ell, _vec4(dense, out),
                           _build.stream_of(values))
    _build.check(err, "spmm")
    spmm.launches += 1
    return out


def column_buckets(indices: torch.Tensor, p: int):
    """(order, starts): the flat positions of ``indices`` stably sorted by
    column, as int32, and the (p + 1,) int32 offsets of each column's run.

    Column c's entries are ``order[starts[c]:starts[c + 1]]``, in row order.
    """
    keys, order = torch.sort(indices.reshape(-1), stable=True)
    cols = torch.arange(p + 1, dtype=keys.dtype, device=keys.device)
    starts = torch.searchsorted(keys, cols, out_int32=True)
    return order.to(torch.int32), starts


def spmm_t(values: torch.Tensor, indices: torch.Tensor, t: torch.Tensor,
           p: int, col_sums: bool = False):
    """Y (p, l) = Wᵀ @ t for compact sparse rows W (n over p columns), t (n, l);
    with ``col_sums``, (Y, Σ_i W[i, c], Σ_i W[i, c]²), the sums (p,) float32."""
    if values.device.type == "cpu":
        return _ref.ref_spmm_t(values, indices, t, p, col_sums)
    _check(values, indices, t, "t")
    n, m = values.shape
    ell = t.shape[1]
    if t.shape[0] != n:
        raise ValueError(f"t has {t.shape[0]} rows, values {n}")
    out = torch.empty((p, ell), dtype=torch.float32, device=values.device)
    sums = torch.empty((2, p), dtype=torch.float32, device=values.device) if col_sums else None
    result = (out, sums[0], sums[1]) if col_sums else out
    if not p or not (ell or col_sums):
        return result
    if n * m == 0:
        out.zero_()
        if col_sums:
            sums.zero_()
        return result
    order, starts = column_buckets(indices, p)
    lib = _build.library("spmm")
    with torch.cuda.device(values.device):
        err = lib.spmm_t_f32(values.data_ptr(), order.data_ptr(), starts.data_ptr(),
                             t.data_ptr(), out.data_ptr(),
                             sums[0].data_ptr() if col_sums else None,
                             sums[1].data_ptr() if col_sums else None,
                             p, m, ell, _vec4(t, out), _build.stream_of(values))
    _build.check(err, "spmm_t")
    spmm_t.launches += 1
    return result


spmm.launches = 0
spmm_t.launches = 0
