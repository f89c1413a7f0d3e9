"""Roofline models of the port's kernels (the port of ``repro.roofline.kernels``).

One model for each function that a kernel of ``kernels/`` computes:

    sketch_fused_roofline    K1 (p ≤ 2^15) and K3's cluster gather above   csrc/hadamard.cu
    fwht_roofline            K2 (p ≤ 2^15) and K3 above                    csrc/hadamard.cu
    spmm_roofline            K5                                            csrc/spmm.cu
    spmm_t_roofline          K6                                            csrc/spmm.cu
    sparse_assign_roofline   K4                                            csrc/sparse_assign.cu

``hbm_bytes`` and ``flops`` are the FUNCTION's least work, whatever
implements it: every operand read once, every result written once, and the
algorithm's operations (float32, on the CUDA cores: K1–K6 do their
arithmetic there). Where the work depends on the data (the Ω rows a sparse
product touches) it counts what the data needs. They are the bound's
numerator, and a redesign of a kernel leaves them as they are.

``schedule_bytes`` is what the port's current schedule moves through device
memory, from the kernels' own planners (``fwht.chunk_plan``,
``spmm.spmm_plan``, ``spmm.windows_pay``, ``spmm.transpose_plan``): each
pass's sweeps, a gathered operand once for each entry that gathers it. It
is a diagnostic printed beside the bound, never its denominator, and is at
least ``hbm_bytes``.

The reference's models instead follow the TPU kernels' tiling and price them
at the TPU's peaks; none of that carries over.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import fwht as _fwht
from repro_torch.kernels import spmm as _spmm
from repro_torch.roofline import hw

F32 = 4          # bytes of a float32 or an int32


@dataclasses.dataclass(frozen=True)
class KernelRoofline:
    """The least work of one call, and what the port's schedule moves."""

    name: str
    n: int                # rows a call processes
    hbm_bytes: int        # the function's least device-memory traffic
    flops: int            # its float32 operations
    schedule_bytes: int   # what the current schedule moves (diagnostic)

    @property
    def mem_us(self) -> float:
        return self.hbm_bytes / hw.HBM_BW * 1e6

    @property
    def compute_us(self) -> float:
        return self.flops / hw.PEAK_FLOPS_FP32 * 1e6

    @property
    def us(self) -> float:
        """The roofline time: the larger of the memory and compute legs."""
        return max(self.mem_us, self.compute_us)

    @property
    def ms(self) -> float:
        return self.us / 1e3

    @property
    def bound(self) -> str:
        """What bounds it: "bytes" or "operations"."""
        return "bytes" if self.mem_us >= self.compute_us else "operations"

    @property
    def rows_per_sec(self) -> float:
        return self.n / (self.us / 1e6)


def _pow2ceil(p: int) -> int:
    return 1 << max(p - 1, 1).bit_length() if p & (p - 1) else p


def _log2(p: int) -> int:
    return p.bit_length() - 1


def _sweeps(p: int) -> int:
    """Read-and-write sweeps of an (n, p) array that K2/K3 make on the H100:
    one, and K3's register passes above C_max·2^15."""
    if p <= _fwht.MAX_P_SINGLE:
        return 1
    return 1 + _fwht.chunk_plan(p, hw.MAX_CLUSTER)[2]


def fwht_roofline(n: int, p: int) -> KernelRoofline:
    """y = H·(d ⊙ x) (or d ⊙ (H·x)) over n rows of p (padded to a power of
    two): x read and y written once, the p signs read once; per value
    log2(p) butterfly additions, the sign and the 1/√p scale. K3's register
    passes above C_max·2^15 sweep the rows again."""
    pp = _pow2ceil(max(p, 2))
    hbm = F32 * (2 * n * pp + pp)
    sched = F32 * (2 * n * pp * _sweeps(pp) + pp)
    return KernelRoofline("fwht", n, hbm, n * pp * (_log2(pp) + 2), sched)


def sketch_fused_roofline(n: int, p: int, m: int) -> KernelRoofline:
    """values (n, m) = (H·(d ⊙ x))[i, idx[i]]: x and the signs read once,
    the (n, m) int32 indices read and the values written; per value log2(p)
    additions and the sign, per kept value the scale. Up to C_max·2^15 the
    schedule is that one pass; above it K3 writes the (n, p) transform and a
    gather reads the kept values back."""
    pp = _pow2ceil(max(p, 2))
    hbm = F32 * (n * pp + pp + 2 * n * m)
    if pp <= hw.MAX_CLUSTER << _fwht.CHUNK_LOG:
        sched = hbm
    else:
        sched = F32 * (2 * n * pp * _sweeps(pp) + pp + 3 * n * m)
    return KernelRoofline("sketch_fused", n, hbm, n * pp * (_log2(pp) + 1) + n * m, sched)


def spmm_roofline(n: int, m: int, p: int, ell: int) -> KernelRoofline:
    """T (n, l) = W @ Ω for n compact rows of m kept (value, int32 index)
    pairs over p columns: the rows read once, the Ω rows they can touch
    read once (min(p, n·m): every row where n·m ≥ p), T written once;
    2·n·m·l operations.

    The schedule: where ``spmm.windows_pay``, each tile of WIN_ROWS rows
    reads every window of Ω, and with S > 1 splits the partial sums are
    written and read back; else the row kernel gathers Ω's row for every
    entry."""
    hbm = F32 * (2 * n * m + min(p, n * m) * ell + n * ell)
    if _spmm.windows_pay(m, p):
        plan = _spmm.spmm_plan(n, p, ell, hw.SM_COUNT)
        tiles = max(1, -(-n // _spmm.WIN_ROWS))
        partials = 2 * plan.splits * n * ell if plan.splits > 1 else 0
        sched = F32 * (2 * n * m + tiles * p * ell + partials + n * ell)
    else:
        sched = F32 * (2 * n * m + n * m * ell + n * ell)
    return KernelRoofline("spmm", n, hbm, 2 * n * m * ell, sched)


def spmm_t_roofline(n: int, m: int, p: int, ell: int, col_sums: bool = False) -> KernelRoofline:
    """Y (p, l) = Wᵀ @ t for n compact rows over p columns and t (n, l): the
    rows and t read once, Y written once (with ``col_sums`` also Σv and Σv²
    per column, 3 operations an entry more); 2·n·m·l operations.

    The schedule: the transposition (``spmm.transpose_plan``) reads the rows,
    writes its scratch and reads it back, and writes the (row, value) pairs
    and the p + 1 offsets; the walk reads them and gathers t's row for every
    entry."""
    sums = 2 * p if col_sums else 0
    hbm = F32 * (2 * n * m + n * ell + p * ell + sums)
    words = _spmm.transpose_plan(n, m, p)[2] if n * m and p else 0
    trans = 2 * n * m + 2 * words + 2 * n * m + (p + 1)
    walk = 2 * n * m + (p + 1) + n * m * ell + p * ell + sums
    sched = F32 * (trans + walk)
    flops = 2 * n * m * ell + (3 * n * m if col_sums else 0)
    return KernelRoofline("spmm_t", n, hbm, flops, sched)


def sparse_assign_roofline(n: int, m: int, r: int, k: int, p: int) -> KernelRoofline:
    """d[i, k] = Σ_j (v_ij − μ_k[idx_ij])² and its argmin over k, for r sets
    of K centers over p: the rows and the centers read once, the (r, n, K)
    distances and (r, n) argmins written; a subtraction, a multiply and an
    add a (kept value, center).

    The schedule lays the centers out by coordinate (read, and written as
    (p, ld), ld = r·K padded to whole float4s), then gathers a coordinate's
    ld values for every kept entry."""
    hbm = F32 * (2 * n * m + r * k * p + r * n * (k + 1))
    ld = -(-r * k // 4) * 4
    sched = F32 * (r * k * p + p * ld + 2 * n * m + n * m * ld + r * n * (k + 1))
    return KernelRoofline("sparse_assign", n, hbm, 3 * n * m * k * r, sched)
