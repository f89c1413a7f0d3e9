"""K5 spmm and K6 spmm_t: sparse-times-dense products — the CUDA kernels' wrappers.

Replace the TPU kernels ``repro.kernels.spmm.spmm`` and ``spmm_t``
(``csrc/spmm.cu``). Over compact sparse rows W (values (n, m), indices
(n, m) in [0, p)) and a narrow dense operand of l columns:

    spmm:    T = W @ Ω      (n, l)
    spmm_t:  Y = Wᵀ @ T     (p, l)

The reference plans VMEM tiles (``plan_tiles``, ``tile_vmem_bytes``). Here
``spmm`` holds windows of Ω's rows in shared memory, on the plan of
:func:`spmm_plan` (splits of the coordinate range), where a row keeps enough
of Ω's rows for the windows to pay (:func:`windows_pay`); elsewhere its row
kernel takes every row. K6's transposition holds fixed column pieces and
slabs. They take any p below 2^31 and any l. What they do need is checked
here: float32 operands (the plain versions keep the reference's promotion
rule for other types, see ``kernels.ref.spmm_out_dtype``), int32 indices,
and fewer than 2^31 entries. Indices must lie in [0, p): the kernels do not
check them.

``spmm``'s windowed kernel needs rows whose indices increase strictly (every
sketch's); a pass on the device flags any other row, and those rows go to
the row kernel, one warp a row. Repeated calls are bit-identical; with one
split the result is bit-equal to the row kernel's.

``spmm_t`` first transposes the entries into columns
(:func:`transpose_columns`, a CUDA kernel whose plain version is
:func:`column_buckets`, a stable sort): each column's (row, value) pairs in row
order. Its kernel then sums each column in that order without atomics, so
repeated calls are bit-identical. With ``col_sums=True`` the same launch also
returns each column's Σv and Σv² (the range-finder's ``sum_w`` and ``diag``),
just as reproducible.

:func:`cluster_sums` is K6 applied to Lloyd's center update: the rows'
indices stay the same across a fit's iterations, so their transposition is
built once (:func:`transpose_columns`) and each iteration walks it against the
labels' one-hot columns (:func:`spmm_t_columns`), in row order, so the sums
are bit-reproducible where float atomics would not be. The counts are
integers, which :func:`cluster_counts` adds exactly in any order.

On a CPU tensor the wrappers compute the plain versions; on a CUDA tensor
they launch the kernel or raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import sm_count


def _check_rows(values: torch.Tensor, indices: torch.Tensor):
    _build.require(values, torch.float32, 2, "values")
    _build.require(indices, torch.int32, 2, "indices", device=values.device)
    if indices.shape != values.shape:
        raise ValueError(f"indices {tuple(indices.shape)} != values {tuple(values.shape)}")
    if values.numel() >= 1 << 31:
        raise ValueError(f"{values.numel()} entries: the kernels index them with int32")


def _check(values: torch.Tensor, indices: torch.Tensor, dense: torch.Tensor, what: str):
    _check_rows(values, indices)
    _build.require(dense, torch.float32, 2, what, device=values.device)


def _vec4(*ts: torch.Tensor) -> int:
    """1 when every operand's rows are whole float4s (l % 4 == 0, 16-byte aligned)."""
    return int(all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0 for t in ts))


# the windowed kernel (csrc/spmm.cu kWinRows, kWindow): rows a block and Ω
# rows a window; a block holds two windows and a ring of 64 pairs a row, and
# one block runs an SM (1024 threads)
WIN_ROWS, WINDOW = 96, 160
SMEM_LIMIT = 227 * 1024            # the shared memory a block may ask for
MAX_SPLITS = 64


def windows_pay(m: int, p: int) -> bool:
    """Whether the windowed kernel takes the rows (else the row kernel takes
    them all): where a row keeps at least 1/32 of Ω's rows. On an H100 at
    n = 4096, l = 128 the windows win at m/p = 0.05 (the low-rank path's) and
    0.25 and lose at 0.01 (PERF.md §6)."""
    return 32 * m >= p


class SpmmPlan(NamedTuple):
    splits: int      # S, blocks a row tile (coordinate ranges)
    span: int        # Ω rows a split, a multiple of WINDOW
    smem: int        # shared memory a block, bytes
    blocks: int      # the grid


def spmm_plan(n: int, p: int, ell: int, sms: int, splits: int | None = None) -> SpmmPlan:
    """The windowed kernel's plan for T (n, l) = W·Ω over p columns on a card
    of ``sms`` SMs (:func:`sm_count`).

    A block holds two windows of WINDOW Ω rows by one chunk of columns (128,
    or 32 when l is not a multiple of 4) and each row's ring of pairs. S
    splits the coordinate range so the grid fills the card: the smallest S
    whose grid has at least one block an SM and fills its last wave to 90 %,
    or the one that fills it best, or, where even S = MAX_SPLITS (or one
    window a split) is short of that, the most splits there are. ``splits``
    fixes S.
    """
    smem = 2 * WINDOW * (128 if ell % 4 == 0 else 32) * 4 + WIN_ROWS * 64 * 8
    tiles = max(1, -(-n // WIN_ROWS))
    windows = max(1, -(-p // WINDOW))
    if splits is None:
        cap = min(windows, MAX_SPLITS)
        full = [s for s in range(1, cap + 1) if tiles * s >= sms]
        fill = {s: tiles * s / (-(-tiles * s // sms) * sms) for s in full}
        good = [s for s in full if fill[s] >= 0.9]
        splits = good[0] if good else max(full, key=lambda s: fill[s]) if full else cap
    span = -(-windows // splits) * WINDOW
    splits = max(1, -(-p // span))     # every split holds at least one window
    return SpmmPlan(splits, span, smem, tiles * splits)


def spmm(values: torch.Tensor, indices: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """T (n, l) = W @ dense for compact sparse rows W and dense (p, l): the
    windowed kernel on :func:`spmm_plan`'s plan where :func:`windows_pay`,
    else the row kernel."""
    if values.device.type == "cpu":
        return _ref.ref_spmm(values, indices, dense)
    (n, m), (p, ell) = values.shape, dense.shape
    plan = spmm_plan(n, p, ell, sm_count(values.device)) if windows_pay(m, p) else None
    out, launched = _launch(values, indices, dense, plan)
    spmm.launches += launched
    return out


def _launch(values, indices, dense, plan: SpmmPlan | None):
    """(T, launched): the windowed kernel on ``plan``, or with no plan the
    row kernel on every row (one warp a row, Ω gathered from L2)."""
    _check(values, indices, dense, "dense")
    n, m = values.shape
    p, ell = dense.shape
    out = torch.empty((n, ell), dtype=torch.float32, device=values.device)
    if not (n and ell):
        return out, False
    if m == 0:
        return out.zero_(), False
    splits, span = (plan.splits, plan.span) if plan else (0, 0)
    words = 1 + n + (splits * n * ell if splits > 1 else 0) if plan else 0
    scratch = torch.empty(words, dtype=torch.int32, device=values.device)
    lib = _build.library("spmm")
    with _build.on_device(values):
        err = lib.spmm_f32(values.data_ptr(), indices.data_ptr(), dense.data_ptr(),
                           out.data_ptr(), scratch.data_ptr(), n, m, p, ell, _vec4(dense, out),
                           splits, span, _build.stream_of(values))
    _build.check(err, "spmm")
    return out, True


def column_buckets(indices: torch.Tensor, p: int):
    """(order, starts): the flat positions of ``indices`` stably sorted by
    column, as int32, and the (p + 1,) int32 offsets of each column's run.

    Column c's entries are ``order[starts[c]:starts[c + 1]]``, in row order.
    """
    keys, order = torch.sort(indices.reshape(-1), stable=True)
    cols = torch.arange(p + 1, dtype=keys.dtype, device=keys.device)
    starts = torch.searchsorted(keys, cols, out_int32=True)
    return order.to(torch.int32), starts


# the transposition's tiling (csrc/spmm.cu kTileRows, kPiece, kScanBlock)
TILE_ROWS, PIECE, SCAN_BLOCK = 64, 512, 256


def transpose_plan(n: int, m: int, p: int) -> tuple[bool, int, int]:
    """(fast, tile_rows, words): the transposition's passes, its tiles' rows
    and its scratch in int32 words, for n rows of m entries over p columns.

    The fast passes (64-row tiles, a 64-bit row mask and a count a (tile,
    column), each row's boundaries at every 512 columns) run where their
    scratch fits in the entry arrays' size, 2·n·m words. Otherwise the general
    passes run, over tiles wide enough for their counts (a word a (tile,
    column)) to fit there too, or over one tile of p counts where n·m < p/2.
    Both also hold a flag a row, the scan's block sums and a flag.
    """
    extra = n + -(-p // SCAN_BLOCK) + 1
    tiles = -(-n // TILE_ROWS)
    words = 3 * tiles * p + n * (-(-p // PIECE) + 1) + extra
    if words <= 2 * n * m:
        return True, TILE_ROWS, words
    rows = -(-n // max(1, min(n, 2 * n * m // p)))
    return False, rows, -(-n // rows) * p + extra


def transpose_columns(values: torch.Tensor, indices: torch.Tensor, p: int):
    """Compact rows → columns: (pairs, starts).

    ``pairs`` (n·m, 2) int32 holds each entry's row and its value's bits
    (``pairs[:, 1].view(torch.float32)``), column by column; column c's
    entries are ``pairs[starts[c]:starts[c + 1]]``, in row order and within a
    row in j order: the order of :func:`column_buckets`, the plain version.
    """
    n, m = values.shape
    if values.device.type == "cpu":
        order, starts = column_buckets(indices, p)
        pairs = torch.stack([order // max(m, 1),
                             values.reshape(-1)[order.long()].view(torch.int32)], dim=1)
        return pairs, starts
    _check_rows(values, indices)
    dev = values.device
    starts = torch.zeros(p + 1, dtype=torch.int32, device=dev)
    pairs = torch.empty((n * m, 2), dtype=torch.int32, device=dev)
    if n * m == 0 or p == 0:
        return pairs, starts
    fast, rows, words = transpose_plan(n, m, p)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    lib = _build.library("spmm")
    with _build.on_device(values):
        err = lib.transpose_columns_f32(values.data_ptr(), indices.data_ptr(), scratch.data_ptr(),
                                        starts.data_ptr(), pairs.data_ptr(), n, m, p, rows,
                                        int(fast), _build.stream_of(values))
    _build.check(err, "transpose_columns")
    transpose_columns.launches += 1
    return pairs, starts


def _spmm_t(values: torch.Tensor, indices: torch.Tensor, t: torch.Tensor, p: int,
            col_sums: bool, entries):
    """(result, launched): K6's column walk over ``entries(values, indices,
    p)``, either (pairs, starts) from :func:`transpose_columns` or (order,
    starts) from :func:`column_buckets`."""
    _check(values, indices, t, "t")
    n, m = values.shape
    ell = t.shape[1]
    if t.shape[0] != n:
        raise ValueError(f"t has {t.shape[0]} rows, values {n}")
    out = torch.empty((p, ell), dtype=torch.float32, device=values.device)
    sums = torch.empty((2, p), dtype=torch.float32, device=values.device) if col_sums else None
    result = (out, sums[0], sums[1]) if col_sums else out
    if not p or not (ell or col_sums):
        return result, False
    if n * m == 0:
        out.zero_()
        if col_sums:
            sums.zero_()
        return result, False
    first, starts = entries(values, indices, p)
    pairs, order = (first, None) if first.ndim == 2 else (None, first)
    lib = _build.library("spmm")
    with _build.on_device(values):
        err = lib.spmm_t_f32(pairs.data_ptr() if pairs is not None else None, values.data_ptr(),
                             order.data_ptr() if order is not None else None,
                             starts.data_ptr(), t.data_ptr(), out.data_ptr(),
                             sums[0].data_ptr() if col_sums else None,
                             sums[1].data_ptr() if col_sums else None,
                             p, m, ell, _vec4(t, out), _build.stream_of(values))
    _build.check(err, "spmm_t")
    return result, True


def spmm_t(values: torch.Tensor, indices: torch.Tensor, t: torch.Tensor,
           p: int, col_sums: bool = False):
    """Y (p, l) = Wᵀ @ t for compact sparse rows W (n over p columns), t (n, l);
    with ``col_sums``, (Y, Σ_i W[i, c], Σ_i W[i, c]²), the sums (p,) float32."""
    if values.device.type == "cpu":
        return _ref.ref_spmm_t(values, indices, t, p, col_sums)
    result, launched = _spmm_t(values, indices, t, p, col_sums, transpose_columns)
    spmm_t.launches += launched
    return result


def spmm_t_columns(pairs: torch.Tensor, starts: torch.Tensor, t: torch.Tensor,
                   p: int) -> torch.Tensor:
    """Y (p, l) = Wᵀ @ t over W's transposition ``(pairs, starts)`` from
    :func:`transpose_columns`: K6's walk alone, for a caller that multiplies
    one W by many t (W's n rows are t's rows)."""
    ell = t.shape[1]
    if t.device.type == "cpu":
        rows = pairs[:, 0].long()
        cols = torch.repeat_interleave(torch.arange(p), starts[1:] - starts[:-1])
        y = torch.zeros((p, ell), dtype=torch.float32)
        return y.index_add_(0, cols, pairs[:, 1].view(torch.float32)[:, None] * t[rows])
    _build.require(pairs, torch.int32, 2, "pairs")
    _build.require(starts, torch.int32, 1, "starts", device=pairs.device)
    _build.require(t, torch.float32, 2, "t", device=pairs.device)
    if starts.shape[0] != p + 1:
        raise ValueError(f"starts has {starts.shape[0]} offsets, need p + 1 = {p + 1}")
    out = torch.empty((p, ell), dtype=torch.float32, device=t.device)
    if not (p and ell):
        return out
    if pairs.shape[0] == 0:
        return out.zero_()
    lib = _build.library("spmm")
    with _build.on_device(t):
        err = lib.spmm_t_f32(pairs.data_ptr(), None, None, starts.data_ptr(), t.data_ptr(),
                             out.data_ptr(), None, None, p, 1, ell, _vec4(t, out),
                             _build.stream_of(t))
    _build.check(err, "spmm_t")
    spmm_t.launches += 1
    return out


def segment_sums(values: torch.Tensor, order: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """(S,) float32: segment s sums ``values[order[k]]`` over k in
    [starts[s], starts[s + 1]) — K6's walk over flat positions with no product
    columns, a warp a segment, its lanes' shares added in a fixed tree: the
    same bits from run to run. ``values`` (N,) float32, ``order`` (N,) and
    ``starts`` (S + 1,) int32 (a stable sort by key and its runs)."""
    if values.device.type == "cpu":
        return _ref.ref_segment_sums(values, order, starts)
    _build.require(values, torch.float32, 1, "values")
    _build.require(order, torch.int32, 1, "order", device=values.device)
    _build.require(starts, torch.int32, 1, "starts", device=values.device)
    segs = starts.shape[0] - 1
    sums = torch.empty((2, max(segs, 0)), dtype=torch.float32, device=values.device)
    if segs <= 0 or order.shape[0] == 0:
        return sums[0].zero_()
    lib = _build.library("spmm")
    with _build.on_device(values):
        err = lib.spmm_t_f32(None, values.data_ptr(), order.data_ptr(), starts.data_ptr(), None,
                             None, sums[0].data_ptr(), sums[1].data_ptr(), segs, 1, 0, 0,
                             _build.stream_of(values))
    _build.check(err, "spmm_t")
    spmm_t.launches += 1
    return sums[0]


def cluster_counts(indices: torch.Tensor, labels: torch.Tensor, k: int, p: int) -> torch.Tensor:
    """(K, p) float32: how many rows labelled k kept each coordinate — an
    integer histogram of ``labels·p + indices`` (int32 where K·p allows), exact
    whatever order the card adds in. ``labels`` (r, n) counts r labellings of
    the rows side by side: (r, K, p)."""
    n = indices.shape[0]
    lab = labels.reshape(-1, n)
    r = lab.shape[0]
    dtype = torch.int32 if r * k * p < 2**31 else torch.int64
    lab = lab.to(dtype) + torch.arange(r, dtype=dtype, device=lab.device)[:, None] * k
    flat = (lab[:, :, None] * p + indices.to(dtype)[None]).reshape(-1)
    counts = torch.zeros(r * k * p, dtype=torch.int32, device=indices.device)
    counts.index_add_(0, flat, torch.ones(1, dtype=torch.int32, device=indices.device)
                      .expand(flat.numel()))
    return counts.view(tuple(labels.shape[:-1]) + (k, p)).to(torch.float32)


def cluster_sums(values: torch.Tensor, indices: torch.Tensor, labels: torch.Tensor,
                 k: int, p: int, columns=None):
    """(sums, counts) (K, p) float32 of the kept values of the rows labelled
    k (labels (n,) in [0, K)): the sums Wᵀ·onehot by K6's walk over the rows'
    transposition ``columns`` ((pairs, starts) from :func:`transpose_columns`,
    built here if not given), each column summed in row order as
    ``kernels.ref.ref_cluster_sums`` sums it; the counts by
    :func:`cluster_counts`. ``labels`` (r, n) labels the rows under r
    hypotheses in one walk over r·K columns: (r, K, p) each."""
    if values.device.type == "cpu":
        return _ref.ref_cluster_sums(values, indices, labels, k, p)
    n = values.shape[0]
    lab = labels.long().reshape(-1, n)
    r = lab.shape[0]
    cols = lab + torch.arange(r, device=lab.device)[:, None] * k       # (r, n) in [0, r·K)
    pairs, starts = columns if columns is not None else transpose_columns(values, indices, p)
    onehot = torch.zeros((n, r * k), dtype=torch.float32, device=values.device)
    onehot.scatter_(1, cols.T, 1.0)
    shape = tuple(labels.shape[:-1]) + (k, p)
    sums = spmm_t_columns(pairs, starts, onehot, p).T.reshape(shape)
    return sums, cluster_counts(indices, labels, k, p)


def spmm_t_from_buckets(values: torch.Tensor, indices: torch.Tensor, t: torch.Tensor,
                        p: int, col_sums: bool = False):
    """:func:`spmm_t` with the column walk fed by :func:`column_buckets`
    (a stable torch.sort) through flat positions: the same sums in the same
    order, kept only to check :func:`spmm_t` and its transposition bit for bit
    on the card. Not counted as a launch."""
    return _spmm_t(values, indices, t, p, col_sums, lambda v, i, p: column_buckets(i, p))[0]


spmm.launches = 0
spmm_t.launches = 0
transpose_columns.launches = 0
