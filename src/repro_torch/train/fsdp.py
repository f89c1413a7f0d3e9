"""FSDP placement of the trainer's state over the ranks of a data-parallel
mesh: each rank holds its block of every parameter and moment leaf, and one
contiguous range of whole chunks of the error-feedback residual.

**Where a block comes from.** A leaf's block is the data-axes part of
``trainer.state_shardings(state, mesh, dp_only=True)`` (the reference's
specs): a leaf whose spec splits a dimension over the mesh's positions is
cut along it into one block a rank, in rank order; a leaf whose spec is
``()`` (norms, biases, a dimension the mesh does not divide, the factored
second moments: the reference's specs replicate them) stays whole on every
rank. A mesh places only with one position a rank, every axis carrying data.

**The residual** is the reference's one residual (not one a rank), cut where
the compressor needs it: rank r holds the values of the zero-padded flat
gradient vector (the reference's flatten order, ``utils/tree.py``) in its
range of whole chunks ``contiguous_blocks(nc, world)[r]``, one 1-D part a
parameter leaf (empty where the leaf lies outside the range), in the dtype
the reference's residual leaf has (the gradient's).

**The step** (``trainer.make_train_fn`` on a :class:`PlacedState`): the
forward gathers each layer's blocks whole inside ``models.common.run_blocks``
and the leaves outside the layer stack where the loss function starts; the
backward reduce-scatters each gathered leaf's gradient into a float32
accumulator of the rank's block, and the gradients of the whole leaves are
all-reduced. Compression then moves the blocks into the chunk ranges
(:func:`to_chunks`, one all-to-all), round-trips the rank's own chunks
(``grad_compress.compress_range``: K2 and the masks of those rows) against
the rank's part of the residual, and moves ĝ back to the blocks and the
whole leaves (:func:`from_chunks`, a second all-to-all). AdamW runs on the
blocks (``optimizer.adamw_update(layout=)``).

Each collective counts the bytes a rank sends to the other ranks under
``grad_compress.exchange_bytes{mode=}``: ``fsdp-all-gather`` (parameters
gathered), ``fsdp-reduce-scatter`` (their gradients), ``fsdp-all-reduce``
(the whole leaves' gradients, the norm, the factored moments' statistics),
``fsdp-to-chunks`` and ``fsdp-from-chunks`` (the two all-to-alls).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as torch_dist

from repro_torch.cluster.bootstrap import Mesh, contiguous_blocks, process_index
from repro_torch.core.grad_compress import CompressConfig, count_exchange
from repro_torch.models.common import all_gather_dim
from repro_torch.utils.tree import tree_leaves_with_path, tree_unflatten

RES = "['residual']"


@dataclasses.dataclass(frozen=True)
class Place:
    """Where one leaf lies: its whole ``shape`` and the dimension cut into
    ``world`` blocks, one a rank in rank order (None: whole on every rank)."""

    shape: tuple[int, ...]
    dim: int | None
    world: int

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def block_shape(self) -> tuple[int, ...]:
        s = list(self.shape)
        if self.dim is not None:
            s[self.dim] //= self.world
        return tuple(s)

    def block(self, t, rank: int):
        """Rank ``rank``'s block of the whole leaf ``t`` (a view of a tensor
        or of an array)."""
        if self.dim is None:
            return t
        size = self.shape[self.dim] // self.world
        return t[(slice(None),) * self.dim + (slice(rank * size, (rank + 1) * size),)]

    # a block along ``dim`` is, in the whole leaf's flat order, one run of
    # ``run`` values in every ``row`` values, at ``rank · run``
    @property
    def row(self) -> int:
        return math.prod(self.shape[self.dim:])

    @property
    def run(self) -> int:
        return self.row // self.world

    def below(self, x: int, rank: int) -> int:
        """How many values of ``rank``'s block lie before the whole leaf's
        flat index ``x``: the block's own flat index there."""
        return (x // self.row) * self.run + min(max(x % self.row - rank * self.run, 0), self.run)

    def pieces(self, t0: int, t1: int, rank: int):
        """Values ``[t0, t1)`` of ``rank``'s block (its own flat order) as
        (t, rows, cols, x): ``rows × cols`` values from block index t, at the
        whole leaf's flat index x with rows ``row`` apart."""
        if t0 >= t1:
            return
        L = self.run
        f0, f1 = -(-t0 // L), t1 // L

        def at(t):
            return (t // L) * self.row + rank * L + t % L

        if f0 > f1:                      # inside one run
            yield t0, 1, t1 - t0, at(t0)
            return
        if t0 < f0 * L:
            yield t0, 1, f0 * L - t0, at(t0)
        if f1 > f0:
            yield f0 * L, f1 - f0, L, at(f0 * L)
        if t1 > f1 * L:
            yield f1 * L, 1, t1 - f1 * L, at(f1 * L)


def _specs(tree, prefix: str = ""):
    """(name, spec) of a tree of specs (tuples are its leaves), by ``keystr``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _specs(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _specs(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _split_dim(spec: tuple, mesh: Mesh, name: str) -> int | None:
    """The dimension ``spec`` cuts over the mesh's positions (None: whole)."""
    dims = []
    for d, e in enumerate(spec):
        axes = () if e is None else e if isinstance(e, tuple) else (e,)
        if math.prod(mesh.shape[a] for a in axes) > 1:
            if tuple(a for a in mesh.axis_names if a in axes) != axes or \
                    math.prod(mesh.shape[a] for a in axes) != mesh.size:
                raise ValueError(f"{name}: the spec {spec} does not cut one block a position of "
                                 f"{mesh} in rank order")
            dims.append(d)
    if len(dims) > 1:
        raise ValueError(f"{name}: the spec {spec} cuts more than one dimension")
    return dims[0] if dims else None


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """The placement of one trainer state over the ranks of ``mesh``: a
    :class:`Place` a leaf (by ``keystr`` name; the residual's leaves are
    the parameters'), the parameters' names in the reference's flatten
    order, and the chunk ranges of the residual and of compression."""

    mesh: Mesh
    rank: int
    places: dict
    params: tuple[str, ...]
    chunk_p: int

    @property
    def world(self) -> int:
        return self.mesh.size

    @classmethod
    def of(cls, state: dict, mesh: Mesh, chunk_p: int = CompressConfig.chunk_p) -> "Layout":
        """The layout of ``state`` (whole leaves, or their shapes on the meta
        device) on ``mesh``, for this process's rank."""
        from repro_torch.train.trainer import state_shardings

        if mesh is None or mesh.size < 2 or mesh.owners != tuple(range(mesh.size)):
            raise ValueError(f"placement needs a mesh of one position a rank over more than "
                             f"one rank, got {mesh}")
        specs = dict(_specs(state_shardings(state, mesh, dp_only=True)))
        places = {}
        for name, leaf in tree_leaves_with_path(state):
            if name.startswith(RES):
                continue
            dim = _split_dim(specs[name], mesh, name)
            places[name] = Place(tuple(leaf.shape), dim, mesh.size)
        params = tuple(name for name, _ in tree_leaves_with_path(state["params"]))
        return cls(mesh, process_index(), places, params, chunk_p)

    def param(self, i: int) -> Place:
        return self.places["['params']" + self.params[i]]

    @functools.cached_property
    def offsets(self) -> tuple[int, ...]:
        out, off = [], 0
        for i in range(len(self.params)):
            out.append(off)
            off += self.param(i).numel
        return tuple(out + [off])

    @property
    def n(self) -> int:
        """The parameters' count: the flat vector's length before padding."""
        return self.offsets[-1]

    @property
    def n_chunks(self) -> int:
        return -(-self.n // self.chunk_p)

    @functools.cached_property
    def chunk_ranges(self) -> tuple[tuple[int, int], ...]:
        """Each rank's chunks ``[c0, c1)``."""
        return tuple((b[0], b[-1] + 1) if b else (0, 0)
                     for b in contiguous_blocks(self.n_chunks, self.world))

    def flat_range(self, rank: int) -> tuple[int, int]:
        """Rank ``rank``'s flat positions ``[A, B)`` of the padded vector."""
        c0, c1 = self.chunk_ranges[rank]
        return c0 * self.chunk_p, c1 * self.chunk_p

    def part(self, i: int, rank: int) -> tuple[int, int]:
        """The flat indices ``[a, b)`` of parameter leaf ``i`` (its own flat
        order) in rank ``rank``'s range."""
        A, B = self.flat_range(rank)
        o, n = self.offsets[i], self.param(i).numel
        a, b = min(max(A - o, 0), n), min(max(B - o, 0), n)
        return a, max(a, b)

    def segment(self, i: int, src: int, dst: int) -> tuple[int, int]:
        """The values ``[t0, t1)`` of rank ``src``'s block of parameter leaf
        ``i`` (a leaf cut over the ranks) in rank ``dst``'s range."""
        a, b = self.part(i, dst)
        pl = self.param(i)
        return pl.below(a, src), pl.below(b, src)

    def chunk_bytes(self) -> dict[str, int]:
        """The bytes this rank sends the other ranks in a step's two
        all-to-alls (float32): its blocks' values in their ranges, then its
        range's values of their blocks and of every whole leaf."""
        me, others = self.rank, [q for q in range(self.world) if q != self.rank]
        to = back = 0
        for i in range(len(self.params)):
            if self.param(i).dim is None:
                a, b = self.part(i, me)
                back += len(others) * (b - a)
                continue
            for q in others:
                t0, t1 = self.segment(i, me, q)
                to += t1 - t0
                t0, t1 = self.segment(i, q, me)
                back += t1 - t0
        return {"fsdp-to-chunks": 4 * to, "fsdp-from-chunks": 4 * back}

    def state_bytes(self, state_like: dict) -> int:
        """The bytes of ``state_like``'s leaves (whole, or on meta) that this
        rank holds once placed: its blocks, the whole leaves, its part of
        the residual."""
        total = 0
        for name, leaf in tree_leaves_with_path(state_like):
            if name.startswith(RES):
                i = self.params.index(name[len(RES):])
                a, b = self.part(i, self.rank)
                total += (b - a) * leaf.element_size()
            else:
                total += math.prod(self.places[name].block_shape) * leaf.element_size()
        return total


def ring_bytes(buf: torch.Tensor, world: int) -> int:
    """The bytes a rank sends in a ring all-reduce of ``buf`` (what the
    ``fsdp-all-reduce`` count adds)."""
    return 2 * (world - 1) * buf.numel() * buf.element_size() // world


class PlacedState(dict):
    """A trainer state placed over the ranks (the module docstring): the
    reference's tree of the rank's blocks, whole leaves and residual parts,
    and its :class:`Layout`. The step, ``checkpoint.save`` and
    ``checkpoint.restore`` read the layout; a step updates it in place."""

    def __init__(self, tree: dict, layout: Layout):
        super().__init__(tree)
        self.layout = layout


def place_state(state: dict, mesh: Mesh, chunk_p: int = CompressConfig.chunk_p,
                device=None) -> PlacedState:
    """This rank's placed state of the whole ``state`` (the same on every
    rank, e.g. ``trainer.init_state``'s from one key): each leaf's block
    copied, on ``device`` (default: the leaf's); a leaf on the meta device
    (a shape) becomes zeros there, so a caller need not build the whole
    moments. The caller drops ``state``."""
    layout = Layout.of(state, mesh, chunk_p)
    leaves = []
    for name, leaf in tree_leaves_with_path(state):
        dev = leaf.device if device is None else device
        if name.startswith(RES):
            a, b = layout.part(layout.params.index(name[len(RES):]), layout.rank)
            part = leaf.reshape(-1)[a:b]
        else:
            part = layout.places[name].block(leaf, layout.rank)
        if leaf.device.type == "meta" and torch.device(dev).type != "meta":
            leaves.append(torch.zeros(part.shape, dtype=part.dtype, device=dev))
        else:
            leaves.append(part.to(dev, memory_format=torch.contiguous_format, copy=True))
    return PlacedState(tree_unflatten(state, leaves), layout)


def gather_leaf(t: torch.Tensor, place: Place) -> torch.Tensor:
    """The whole leaf of this rank's block ``t``, on every rank."""
    if place.dim is None:
        return t
    return all_gather_dim(t, place.dim, mode="fsdp-gather-state")


def gather_residual(parts: list[torch.Tensor], layout: Layout) -> list[torch.Tensor]:
    """The whole residual leaves (float32, flat) from every rank's parts:
    one all-gather of the ranks' ranges, each padded to the longest."""
    A, B = layout.flat_range(layout.rank)
    longest = max(b - a for a, b in (layout.flat_range(r) for r in range(layout.world)))
    dev = parts[0].device if parts else torch.device("cpu")
    mine = torch.zeros((longest,), dtype=torch.float32, device=dev)
    for i, p in enumerate(parts):
        a, b = layout.part(i, layout.rank)
        o = layout.offsets[i]
        mine[o + a - A:o + b - A] = p
    every = torch.empty((layout.world * longest,), dtype=torch.float32, device=dev)
    torch_dist.all_gather_into_tensor(every, mine)
    count_exchange("fsdp-gather-state", (layout.world - 1) * longest * 4)
    flat = torch.cat([every[r * longest:r * longest + (layout.flat_range(r)[1]
                                                       - layout.flat_range(r)[0])]
                      for r in range(layout.world)])
    return [flat[layout.offsets[i]:layout.offsets[i + 1]] for i in range(len(layout.params))]


def gather_state(state: PlacedState) -> dict:
    """The whole state of a placed one, on every rank, in tensors of its own
    (a diagnostic: it holds the whole state)."""
    layout = state.layout
    named = tree_leaves_with_path(state)
    res = [leaf for name, leaf in named if name.startswith(RES)]
    whole_res = iter(gather_residual(res, layout)) if res else None
    leaves = []
    for name, leaf in named:
        if name.startswith(RES):
            i = layout.params.index(name[len(RES):])
            leaves.append(next(whole_res).to(leaf.dtype).view(layout.param(i).shape))
        else:
            place = layout.places[name]
            leaves.append(leaf.clone() if place.dim is None else gather_leaf(leaf, place))
    return tree_unflatten(dict(state), leaves)


# an all-to-all moves at most about this many float32 values a rank (1 GiB;
# a leaf larger than that goes alone), so its buffers stay small beside the
# state's
MOVE_VALUES = 1 << 28


def _batches(layout: Layout):
    """The parameter leaves in runs of consecutive indices, each run about
    ``MOVE_VALUES`` values a rank: every rank forms the same runs."""
    run, size = [], 0
    for i in range(len(layout.params)):
        n = layout.param(i).numel // layout.world
        if run and size + n > MOVE_VALUES:
            yield run
            run, size = [], 0
        run.append(i)
        size += n
    if run:
        yield run


def to_chunks(grads: list, layout: Layout) -> torch.Tensor:
    """This rank's range ``[A, B)`` of the flat float32 gradient vector
    (zero-padded past n) from every rank's ``grads``: per parameter leaf the
    rank's block (a leaf cut over the ranks) or the whole leaf, float32.
    All-to-alls (one a run of leaves, :func:`_batches`) move the blocks'
    values into their ranges; each rank copies its range's part of a whole
    leaf from its own copy."""
    R, me = layout.world, layout.rank
    A, B = layout.flat_range(me)
    dev = grads[0].device
    out = torch.zeros((B - A,), dtype=torch.float32, device=dev)
    for run in _batches(layout):
        cut = [i for i in run if layout.param(i).dim is not None]
        sends = [[(i, *layout.segment(i, me, q)) for i in cut] for q in range(R)]
        recvs = [[(i, *layout.segment(i, r, me)) for i in cut] for r in range(R)]

        def pack(buf):
            off = 0
            for q in range(R):
                for i, t0, t1 in sends[q]:
                    buf[off:off + t1 - t0] = grads[i].reshape(-1)[t0:t1]
                    off += t1 - t0

        recv = _all_to_all(pack, sends, recvs, dev, "fsdp-to-chunks", me)
        off = 0
        for r in range(R):
            for i, t0, t1 in recvs[r]:
                pl, base = layout.param(i), layout.offsets[i] - A
                for t, rows, cols, x in pl.pieces(t0, t1, r):
                    dst = out.as_strided((rows, cols), (pl.row, 1), out.storage_offset() + base + x)
                    dst.copy_(recv[off + t - t0:off + t - t0 + rows * cols].view(rows, cols))
                off += t1 - t0
        del recv
    for i in range(len(layout.params)):
        if layout.param(i).dim is None:
            a, b = layout.part(i, me)
            o = layout.offsets[i] - A
            out[o + a:o + b] = grads[i].reshape(-1)[a:b]
    return out


def from_chunks(rng: torch.Tensor, layout: Layout) -> list[torch.Tensor]:
    """The inverse of :func:`to_chunks`: from every rank's range of the flat
    vector (this rank's ``rng``), per parameter leaf this rank's block (a
    leaf cut over the ranks) or the whole leaf, float32, in the leaf's
    shape. An all-to-all a run of leaves; a whole leaf's parts go to every
    rank."""
    R, me = layout.world, layout.rank
    A, _ = layout.flat_range(me)
    out = [torch.empty((layout.param(i).numel if layout.param(i).dim is None
                        else math.prod(layout.param(i).block_shape),),
                       dtype=torch.float32, device=rng.device)
           for i in range(len(layout.params))]

    def span(i, holder, owner):
        """The values of ``holder``'s block of leaf i (a whole leaf: its flat
        indices) that rank ``owner``'s range holds."""
        if layout.param(i).dim is None:
            return layout.part(i, owner)
        return layout.segment(i, holder, owner)

    for run in _batches(layout):
        sends = [[(i, *span(i, q, me)) for i in run] for q in range(R)]
        recvs = [[(i, *span(i, me, r)) for i in run] for r in range(R)]

        def pack(buf):
            off = 0
            for q in range(R):
                for i, t0, t1 in sends[q]:
                    pl, base = layout.param(i), layout.offsets[i] - A
                    if pl.dim is None:
                        buf[off:off + t1 - t0] = rng[base + t0:base + t1]
                    else:
                        for t, rows, cols, x in pl.pieces(t0, t1, q):
                            src = rng.as_strided((rows, cols), (pl.row, 1),
                                                 rng.storage_offset() + base + x)
                            buf[off + t - t0:off + t - t0 + rows * cols].view(rows, cols).copy_(src)
                    off += t1 - t0

        recv = _all_to_all(pack, sends, recvs, rng.device, "fsdp-from-chunks", me)
        off = 0
        for r in range(R):
            for i, t0, t1 in recvs[r]:
                out[i][t0:t1] = recv[off:off + t1 - t0]
                off += t1 - t0
        del recv
    return [o.view(layout.param(i).shape if layout.param(i).dim is None
                   else layout.param(i).block_shape) for i, o in enumerate(out)]


def _all_to_all(pack, sends: list, recvs: list, device, mode: str, me: int) -> torch.Tensor:
    """One all_to_all_single of float32 values: ``sends[q]`` / ``recvs[r]``
    list the (leaf, t0, t1) spans this rank sends rank q / receives from rank
    r, in order; ``pack(buf)`` writes the sends into ``buf``. Returns the
    received values, by rank, in ``recvs``' order."""
    send_n = [sum(t1 - t0 for _, t0, t1 in spans) for spans in sends]
    recv_n = [sum(t1 - t0 for _, t0, t1 in spans) for spans in recvs]
    buf = torch.empty((sum(send_n),), dtype=torch.float32, device=device)
    pack(buf)
    recv = torch.empty((sum(recv_n),), dtype=torch.float32, device=device)
    torch_dist.all_to_all_single(recv, buf, recv_n, send_n)
    count_exchange(mode, 4 * (sum(send_n) - send_n[me]))
    return recv
