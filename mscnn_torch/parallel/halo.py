"""H bands of the MS-CNN trunk: the band plan, the halo exchange, the gather.

The data x space step (`parallel/spmd.py`) splits every image's rows over
the mesh's "space" axis. JAX's GSPMD partitioner inserts the halo
exchanges of each window itself; the port does it by hand here:

  * `BandPlan`: which rows of each trunk level (the image, then each 2x2 /
    2 ceil-mode pool's output) each space rank holds. Rank s holds image
    rows [s H / S, (s + 1) H / S); a pool's output row j belongs to the
    rank whose band holds input row 2j, so a band at level l + 1 is
    [ceil(lo / 2), ceil(hi / 2)) and the bands may turn uneven (72 rows
    over 2 ranks reach pool3 as 9-row bands, pool3's output as 5 and 4).
    The banded region ends at conv4_3 (`depth` 3: three pools inside),
    or earlier where a band would be thinner than a halo; `region` names
    its layers, for the trunk (where to gather) and the step (which
    gradients a rank contributes);
  * `Band`: one rank's view of the plan in one step, with the collectives
    (`Comm`). `conv` pads its band with one row of each neighbour and
    crops the rows its SAME convolution computed from them; where another
    conv follows, it exchanges the pre-activation's edge rows and applies
    the ReLU to the haloed rows, so that the one tensor the ReLU saves is
    the one the next conv saves (one copy of a layer's output); `pool` takes
    one row of the next rank where its last window straddles the edge and
    drops its first row where that window is the previous rank's;
    `conv1_block` gives the fused conv1 block (K2, or the s2d form) the
    input rows its pooled rows read (a 1-3 row halo) and crops the
    pooled rows; `gather` hands every rank the whole map of every image;
  * `exchange` is an autograd function: its backward sends the halo rows'
    gradients to the ranks that own those rows, which add them to their
    edge rows. The gather's backward takes this rank's own piece of the
    gradient its own loss computed (every rank computes the same loss
    after the gather; `parallel/spmd.py` counts each gradient once).

Every exchange is one all-gather over the space group of each rank's
first and last k rows (k: the largest halo of that exchange), on bytes:
gloo and NCCL alike move any dtype that way. A band is activated for one
step with `banding(band)`, which `models/mscnn.py::trunk` reads
(`current`): the trunk has no argument for it, and the context ends with
the step, so no other caller of the trunk sees it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("mscnn_band", default=None)

DEPTH = 3          # pools inside the banded region: it ends at conv4_3
CONV1_HALO = 3     # the most image rows the conv1 block takes from a neighbour


def current():
    """The band `banding` activated, or None (the whole-image trunk)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def banding(band):
    """Activate `band` for the trunk calls inside the block."""
    token = _ACTIVE.set(band)
    try:
        yield band
    finally:
        _ACTIVE.reset(token)


def _pooled(lo: int, hi: int) -> Tuple[int, int]:
    """A band's rows after a 2x2 / 2 ceil-mode pool."""
    return (lo + 1) // 2, (hi + 1) // 2


class BandPlan:
    """The rows of each trunk level that each of `space` ranks holds, for an
    image of `height` rows (geometry only; no collective).

    levels[l] = (rows of level l, [(lo, hi) of rank s]); level 0 is the
    image. `banded` is False where the image is not split (one space rank,
    H % S != 0 as in JAX's `batch_shardings`, or a band thinner than the
    conv1 block's halo); then every space rank holds whole images."""

    def __init__(self, height: int, space: int,
                 layers: Sequence[Tuple[str, bool]]):
        """layers: the trunk's convs in order, each with whether a 2x2 pool
        follows it (`models/mscnn.py`'s VGG_BLOCKS / POOL_AFTER)."""
        self.height, self.space = int(height), int(space)
        rows = self.height
        bounds = [(s * rows // space, (s + 1) * rows // space) for s in range(space)]
        self.levels = [(rows, bounds)]
        for _ in range(DEPTH):
            rows = (rows + 1) // 2
            bounds = [_pooled(lo, hi) for lo, hi in bounds]
            self.levels.append((rows, bounds))
        self.banded = space > 1 and self.height % space == 0 and all(
            hi - lo >= CONV1_HALO for lo, hi in self.levels[0][1])
        # the region's end: the deepest level whose bands all hold a row
        # (unsplit images are gathered over the data axis at conv4_3)
        self.depth = DEPTH
        if self.banded:
            self.depth = 0
            while self.depth < DEPTH and all(
                    hi > lo for lo, hi in self.levels[self.depth + 1][1]):
                self.depth += 1
        # the convs on the band: those before the region's last pool, and
        # the one that pool follows (the gather takes its output)
        region, level = [], 0
        for name, pooled in layers:
            region.append(name)
            if pooled:
                if level == self.depth:
                    break
                level += 1
        self.region = tuple(region)

    def rows(self, level: int, s: int) -> Tuple[int, int]:
        """(lo, hi) of space rank s's band at `level`."""
        if not self.banded:
            return 0, self.levels[level][0]
        return self.levels[level][1][s]

    def conv_needs(self, level: int) -> List[Tuple[int, int]]:
        """(top, bottom) halo rows of each rank for a 3x3 SAME conv: one row
        of each neighbour, none past the image's edges."""
        n = self.levels[level][0]
        return [(int(lo > 0), int(hi < n)) for lo, hi in self.levels[level][1]]

    def pool_needs(self, level: int) -> List[Tuple[int, int]]:
        """A 2x2 / 2 pool: one row of the next rank where the band ends on
        an odd row inside the image (its last window straddles the edge)."""
        n = self.levels[level][0]
        return [(0, int(hi % 2 == 1 and hi < n)) for _, hi in self.levels[level][1]]

    def conv1_span(self, s: int) -> Tuple[int, int]:
        """The image rows [g0, g1) the conv1 block (conv1_1, conv1_2, pool1)
        reads for rank s's pooled rows: the rows of its pool windows,
        widened by the two convolutions' two rows, within the image. g0 is
        even, so the block's pool windows are the whole image's."""
        n, bounds = self.levels[0]
        lo, hi = bounds[s]
        lo2, hi2 = lo + lo % 2, min(hi + hi % 2, n)
        return max(lo2 - 2, 0), min(hi2 + 2, n)

    def conv1_needs(self) -> List[Tuple[int, int]]:
        out = []
        for s, (lo, hi) in enumerate(self.levels[0][1]):
            g0, g1 = self.conv1_span(s)
            out.append((lo - g0, g1 - hi))
        return out


class Comm:
    """The collectives of a data x space step: all-gathers over the space
    group (this rank's row of the mesh) and over every rank. Rank r of the
    default group is mesh position (r // S, r % S). Without a process
    group (a one-device mesh) nothing is exchanged."""

    def __init__(self, data: int, space: int, rank: int):
        self.data, self.space, self.rank = data, space, rank
        self.d, self.s = divmod(rank, space)
        self.size = data * space
        self.space_group = None
        if self.size > 1 and space > 1 and data > 1:
            # every rank makes every group, in the same order
            for d in range(data):
                g = dist.new_group([d * space + s for s in range(space)])
                if d == self.d:
                    self.space_group = g

    def all_gather(self, t: torch.Tensor, space_only: bool = False) -> list:
        """Every rank's `t` (same shape and dtype on each), in rank order:
        over the space group, or over every rank. Moved as bytes."""
        n = self.space if space_only else self.size
        if n == 1:
            return [t]
        src = t.contiguous().reshape(-1).view(torch.uint8)
        outs = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(outs, src, group=self.space_group if space_only else None)
        return [o.view(t.dtype).reshape(t.shape) for o in outs]


@dataclasses.dataclass
class BandStats:
    """What one step's band moved: bytes this rank put into the halo
    exchanges (forward and backward) and into the gathers, and their
    counts."""
    halo_bytes: int = 0
    halo_calls: int = 0
    gather_bytes: int = 0
    gather_calls: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Exchange(torch.autograd.Function):
    """x (this rank's band) -> the band with `needs[s]` = (top, bottom) rows
    of its neighbours above and below it; backward: the halo rows'
    gradients go back to their owners."""

    @staticmethod
    def forward(ctx, x, band, needs):
        comm, s = band.comm, band.comm.s
        k = max(max(t, b) for t, b in needs)
        h = x.shape[1]
        edges = torch.cat([x[:, :k], x[:, h - k:]], 1)
        band.on_exchange(edges, before=True)
        got = comm.all_gather(edges, space_only=True)
        band.on_exchange(edges, before=False)
        top, bot = needs[s]
        parts = ([got[s - 1][:, 2 * k - top:]] if top else []) + [x] + \
            ([got[s + 1][:, :bot]] if bot else [])
        ctx.band, ctx.needs, ctx.k, ctx.h = band, needs, k, h
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        band, needs, k, h = ctx.band, ctx.needs, ctx.k, ctx.h
        comm, s = band.comm, band.comm.s
        top, bot = needs[s]
        send = g.new_zeros((g.shape[0], 2 * k) + tuple(g.shape[2:]))
        # the first half: the rows of the previous rank's end (right-aligned);
        # the second: the rows of the next rank's start
        send[:, k - top:k] = g[:, :top]
        send[:, k:k + bot] = g[:, top + h:]
        band.on_exchange(send, before=True, backward=True)
        got = comm.all_gather(send, space_only=True)
        band.on_exchange(send, before=False, backward=True)
        gx = g[:, top:top + h].clone()
        if s + 1 < comm.space and needs[s + 1][0]:
            t = needs[s + 1][0]
            gx[:, h - t:] += got[s + 1][:, k - t:k]
        if s > 0 and needs[s - 1][1]:
            b = needs[s - 1][1]
            gx[:, :b] += got[s - 1][:, k:k + b]
        return gx, None, None


class _Gather(torch.autograd.Function):
    """This rank's piece (its images, its band) -> the whole batch's map;
    backward: this rank's piece of the gradient."""

    @staticmethod
    def forward(ctx, x, band, level):
        plan, comm = band.plan, band.comm
        n = plan.levels[level][0]
        spans = [plan.rows(level, s) for s in range(comm.space)]
        hmax = max(hi - lo for lo, hi in spans)
        piece = x
        if x.shape[1] < hmax:
            piece = torch.cat([x, x.new_zeros((x.shape[0], hmax - x.shape[1])
                                              + tuple(x.shape[2:]))], 1)
        band.on_gather(piece, before=True)
        got = comm.all_gather(piece)
        band.on_gather(piece, before=False)
        S = comm.space
        images = []
        for d in range(comm.data):
            if plan.banded:
                images.append(torch.cat([got[d * S + s][:, :hi - lo]
                                         for s, (lo, hi) in enumerate(spans)], 1))
            else:
                images.append(got[d * S][:, :n])
        ctx.band, ctx.level, ctx.b = band, level, x.shape[0]
        return torch.cat(images, 0)

    @staticmethod
    def backward(ctx, g):
        band, b = ctx.band, ctx.b
        lo, hi = band.plan.rows(ctx.level, band.comm.s)
        d = band.comm.d
        return g[d * b:(d + 1) * b, lo:hi].contiguous(), None, None


class Band:
    """One rank's band of a step: the trunk's hooks (`conv`, `pool`,
    `conv1_block`, `gather`), their collectives and what they moved
    (`stats`). mark: the step's timing callback, called with "trunk"
    before and "halo" / "gather" after each exchange ("backward" before
    and "halo" after one in the backward pass)."""

    def __init__(self, plan: BandPlan, comm: Comm,
                 mark: Optional[Callable[[str], None]] = None):
        self.plan, self.comm = plan, comm
        self.mark = mark or (lambda name: None)
        self.stats = BandStats()

    def on_exchange(self, t, *, before: bool, backward: bool = False):
        if before:
            self.mark("backward" if backward else "trunk")
        else:
            self.stats.halo_bytes += _nbytes(t)
            self.stats.halo_calls += 1
            self.mark("halo")

    def on_gather(self, t, *, before: bool):
        if before:
            self.mark("trunk")
        else:
            self.stats.gather_bytes += _nbytes(t)
            self.stats.gather_calls += 1
            self.mark("gather")

    def _exchange(self, x, needs: Sequence[Tuple[int, int]]):
        return _Exchange.apply(x, self, list(needs))

    def conv(self, fn: Callable, x, level: int, *, haloed: bool = False,
             keep_halo: bool = False):
        """relu(fn(x)) over this rank's band at `level`; fn: a 3x3 SAME conv
        and its bias, no ReLU. x: the band, or (haloed) the band with its
        conv halo, as this method returns it with keep_halo. keep_halo:
        return the band with the halo the next conv at this level reads:
        the pre-activation's edge rows are exchanged and the ReLU runs on
        the haloed rows, so its output is the next conv's input (`crop`
        gives the band's rows of it)."""
        if not self.plan.banded:
            return torch.relu(fn(x))
        needs = self.plan.conv_needs(level)
        top, bot = needs[self.comm.s]
        xe = x if haloed else self._exchange(x, needs)
        y = fn(xe)[:, top:xe.shape[1] - bot]
        return torch.relu(self._exchange(y, needs) if keep_halo else y)

    def crop(self, x, level: int):
        """The band's rows of a haloed tensor (`conv(keep_halo=True)`)."""
        if not self.plan.banded:
            return x
        top, bot = self.plan.conv_needs(level)[self.comm.s]
        return x[:, top:x.shape[1] - bot]

    def pool(self, x, level: int, pool: Callable):
        """pool (2x2 / 2, ceil mode) of this rank's band at `level`: the
        band's rows at level + 1."""
        if not self.plan.banded:
            return pool(x)
        needs = self.plan.pool_needs(level)
        lo, _ = self.plan.rows(level, self.comm.s)
        xe = self._exchange(x, needs) if any(b for _, b in needs) else x
        return pool(xe[:, lo % 2:])

    def conv1_block(self, fn: Callable, x):
        """fn (conv1_1 -> ReLU -> conv1_2 -> ReLU -> pool1, SAME) over the
        image rows this rank's pooled rows read; returns its pool1 band."""
        if not self.plan.banded:
            return fn(x)
        s = self.comm.s
        g0, _ = self.plan.conv1_span(s)
        lo1, hi1 = self.plan.rows(1, s)
        y = fn(self._exchange(x, self.plan.conv1_needs()))
        return y[:, lo1 - g0 // 2:hi1 - g0 // 2]

    def gather(self, x, level: int):
        """The whole map of every image of the batch, from every rank's piece."""
        if self.comm.size == 1:
            return x
        return _Gather.apply(x, self, level)
