"""Data-parallel tree learner: rows sharded over a mesh of devices.

Port of ``lightgbm_tpu/parallel/data_parallel.py`` (reference:
src/treelearner/data_parallel_tree_learner.cpp: each rank histograms its
row shard, the histograms are summed across ranks, and every rank scans
the same sums, so every rank picks the same split).

A :class:`Mesh` is an ordered list of ``torch.device`` along one
``"data"`` axis (:func:`make_mesh`). Shard k owns a contiguous block of
the rows, the first ``N % n`` blocks one row longer than the others, and
holds its binned rows on its device. :class:`DataParallelTreeLearner` is
a :class:`~..treelearner.serial.SerialTreeLearner` that changes only
what the mesh changes:

- ``_stage_bins``: each shard's block of the binned rows on its device
  (a view of the learner's matrix when the shard lies on the learner's
  device, a copy on another card);
- ``_leaf_histogram`` and the root's sums: one launch of the histogram
  kernel per shard over that shard's rows (K1 for f32 rows, K2 for int8,
  the int16 instance for 16-bit; the uint16 build past 256 bins), then
  the reduce: the shards' partials summed in shard order 0..n-1 in their
  own dtype (integer sums are exact whatever the order). Bundled (EFB)
  rows reduce the [Gp, Bg, 4] bundle histogram and unpack it after the
  reduce, with the reduced totals (reference ``_mesh_hist``, :281-288);
- the compaction part of the split step: the smaller child's rows are
  listed per shard, in ascending local order, from one cumsum over all
  rows (a shard's list starts at the count of the child's rows before
  the shard), into one [n, max rows + 1] buffer with the n lengths on
  the device, so the step makes no host read.

Everything else is the serial learner's: the root's scan,
``_finish_split``, the scans, the record layout, the whole-tree loop and
its capture, the per-split loop and the capability paths (CEGB,
monotone, per-node masks), and ``train_many``. The partition of a split
runs over every row on the learner's device, which holds all of them
(a shard on that device is a view of its rows).

Unlike the reference's mesh learner, which histograms the smaller child
with a masked pass over every row (``_children_histograms``, :377-384)
because compacting rows *across* shards would need an all-to-all, each
shard compacts its own rows here (what LightGBM's data-parallel ranks
do). The sums are the same: byte-equal in integer mode; in f32 each
shard's partial is the same adds on the CPU and the shards add in
order, so f32 trees are held at level (b) to the serial learner's, and
a one-shard mesh is text-equal to it.

A mesh whose shards all lie on the learner's device (one card, the CPU,
or one card named n times) keeps the whole-tree step one captured CUDA
graph; a mesh over several cards runs the step eagerly (copies between
cards), as does the multi-process learner (``distributed.py``).
Forced splits are ignored by the mesh learners with the reference's
warning (``data_parallel.py:191-195``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as TF

from ..io.dataset import BinnedDataset
from ..ops.histogram import build_histogram
from ..ops.quantize import sum_gh
from ..treelearner.serial import SerialTreeLearner
from ..utils import log
from ..utils.log import LightGBMError


class Mesh:
    """An ordered list of devices along one axis (``"data"``). A mesh
    built by hand may name a device more than once (n logical shards on
    one card); :func:`make_mesh` never does."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise LightGBMError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise LightGBMError("a mesh's devices are of one type, got %s"
                                % [str(d) for d in self.devices])

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return "Mesh(%s)" % [str(d) for d in self.devices]


def make_mesh(n_devices: Optional[int] = None,
              device_type: str = "cuda") -> Mesh:
    """A 1-D mesh (reference ``make_mesh``, :75): on ``cuda`` the first
    ``n_devices`` visible cards (all of them by default); on ``cpu``
    ``n_devices`` CPU shards (1 by default), the counterpart of the
    reference tests' forced host devices. Asking for more cards than
    are visible raises: the mesh never shrinks quietly."""
    if n_devices is not None and int(n_devices) < 1:
        raise LightGBMError("a mesh needs at least one device, got %s"
                            % n_devices)
    if device_type == "cpu":
        return Mesh([torch.device("cpu")] * int(n_devices or 1))
    if device_type != "cuda":
        raise LightGBMError("no mesh of %r devices (cuda or cpu)"
                            % device_type)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible == 0:
        raise LightGBMError("a cuda mesh needs a CUDA device; no CUDA "
                            "device is visible")
    n = visible if n_devices is None else int(n_devices)
    if n > visible:
        raise LightGBMError("a mesh of %d cards was asked for; %d are "
                            "visible" % (n, visible))
    return Mesh([torch.device("cuda", i) for i in range(n)])


class Shard(NamedTuple):
    """One shard's rows: its device, first row, row count and binned
    rows on its device."""
    device: torch.device
    offset: int
    size: int
    bins: torch.Tensor


def shard_sizes(n_rows: int, n_shards: int) -> List[int]:
    """Contiguous balanced blocks: the first ``n_rows % n_shards`` one
    row longer."""
    base, extra = divmod(n_rows, n_shards)
    return [base + (k < extra) for k in range(n_shards)]


def padded_rows(n: int) -> int:
    """The rows the root's f32 sums of ``n`` rows are taken over (the
    serial learner's: the reference's padding to a multiple of 4096
    above n)."""
    return -(-(n + 1) // 4096) * 4096


class _MeshLearner:
    """What every mesh learner shares: the mesh, forced splits ignored,
    and a step captured only when it stays on the learner's device.
    Mixed in before :class:`SerialTreeLearner`."""

    def __init__(self, config, dataset: BinnedDataset,
                 device: torch.device, mesh: Mesh):
        self.mesh = mesh
        if mesh.devices[0].type != torch.device(device).type:
            raise LightGBMError("mesh %r and learner device %s differ in "
                                "type" % (mesh, device))
        super().__init__(config, dataset, device)

    def _load_forced_splits(self, config):
        if config.forcedsplits_filename:
            log.warning("forcedsplits_filename is only implemented in the "
                        "serial (single-device) learner; IGNORED by "
                        "mesh-parallel learners")
        return None

    def _captures_steps(self) -> bool:
        return all(d == self.device for d in self.mesh.devices)


class DataParallelTreeLearner(_MeshLearner, SerialTreeLearner):
    """Leaf-wise grower over row-sharded binned data: per split, one
    kernel launch per shard over the smaller child's rows of that shard,
    the partials summed, the sibling by subtraction, the serial scans."""

    # ------------------------------------------------------------------
    # rows per shard
    # ------------------------------------------------------------------
    def _stage_bins(self, dataset: BinnedDataset, ncols: int) -> None:
        super()._stage_bins(dataset, ncols)
        dev, N = self.device, self.N
        sizes = shard_sizes(N, self.mesh.size)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(int)
        self.shards: List[Shard] = []
        for d, o, n in zip(self.mesh.devices, offsets, sizes):
            block = self.bins[o:o + n]
            self.shards.append(Shard(d, int(o), int(n),
                                     block if d == dev else block.to(d)))
        S = len(sizes)
        self._nmax = max(sizes)
        shard_of_row = torch.repeat_interleave(
            torch.arange(S, device=dev), torch.tensor(sizes, device=dev))
        offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
        #: each row's id within its shard, its slot base in the [S, nmax +
        #: 1] row lists, and its shard's trash slot
        self._local_rows = (torch.arange(N, device=dev)
                            - offs.index_select(0, shard_of_row)).to(
                                torch.int32)
        self._shard_of_row = shard_of_row
        self._slot_base = shard_of_row * (self._nmax + 1)
        self._last_row = offs + torch.tensor(sizes, device=dev) - 1
        self._bounds = torch.tensor(list(offsets) + [N], dtype=torch.int32,
                                    device=dev)

    def _root(self, state) -> None:
        # a shard on another card gets the tree's rows once, at its root
        self._gh_copies = {
            k: state.gh[sh.offset:sh.offset + sh.size].to(sh.device)
            for k, sh in enumerate(self.shards) if sh.device != self.device}
        super()._root(state)

    def _shard_gh(self, gh: torch.Tensor, k: int) -> torch.Tensor:
        """Shard ``k``'s rows of the tree's ``gh``: a view on the
        learner's device, else the copy staged at the root."""
        sh = self.shards[k]
        if sh.device == self.device:
            return gh[sh.offset:sh.offset + sh.size]
        return self._gh_copies[k]

    def _reduce(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The shards' partials summed in shard order on the learner's
        device, in their own dtype."""
        out = parts[0].to(self.device)
        for p in parts[1:]:
            out = out + p.to(self.device)
        return out

    def _root_sums(self, gh: torch.Tensor) -> torch.Tensor:
        """Each shard's channel sums (the serial learner's over its rows),
        reduced."""
        return self._reduce([
            sum_gh(gh[sh.offset:sh.offset + sh.size], padded_rows(sh.size))
            for sh in self.shards])

    def _leaf_histogram(self, gh: torch.Tensor,
                        idx: Optional[torch.Tensor] = None,
                        count: Optional[torch.Tensor] = None,
                        totals: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """The reduced [Fp, B, 4] histogram of every row (``idx`` None)
        or of an ascending global row list (the per-split loop's, cut at
        the shard boundaries by one host read)."""
        if count is not None:
            raise LightGBMError("a mesh learner lists a child's rows per "
                                "shard (_child_parts)")
        width = self._width()
        if idx is None:
            parts = [build_histogram(sh.bins, self._shard_gh(gh, k), width,
                                     f64=self._f64)
                     for k, sh in enumerate(self.shards)]
        else:
            cuts = torch.searchsorted(idx, self._bounds).tolist()
            parts = [build_histogram(
                sh.bins, self._shard_gh(gh, k), width,
                (idx[cuts[k]:cuts[k + 1]] - sh.offset).to(sh.device),
                f64=self._f64) for k, sh in enumerate(self.shards)]
        return self._unpack(self._reduce(parts), gh, totals)

    def _row_list_buffers(self):
        """Row lists [S, nmax + 1] (slot nmax of each is its trash), the
        rows' local ids, and the S list lengths."""
        dev, S = self.device, len(self.shards)
        return (torch.zeros((S, self._nmax + 1), dtype=torch.int32,
                            device=dev),
                self._local_rows,
                torch.zeros(S, dtype=torch.int32, device=dev))

    def _child_parts(self, buf, child: torch.Tensor,
                     valid: torch.Tensor) -> List[torch.Tensor]:
        """Each shard's partial histogram of leaf ``child``'s rows (none
        unless ``valid``): the rows are listed per shard from one cumsum
        and each shard's list is summed by the kernel's device-count
        entry. No host read."""
        st = buf.state
        is_child = (st.leaf_of_row == child) & valid
        pos = torch.cumsum(is_child, 0, dtype=torch.int32)
        ends = pos.index_select(0, self._last_row)
        starts = TF.pad(ends[:-1], (1, 0))
        buf.count.copy_(ends - starts)
        local = pos - 1 - starts.index_select(0, self._shard_of_row)
        dest = self._slot_base + torch.where(is_child, local, self._nmax)
        buf.idx.view(-1).scatter_(0, dest, buf.rows)
        width = self._width()
        return [build_histogram(sh.bins, self._shard_gh(st.gh, k), width,
                                buf.idx[k].to(sh.device),
                                buf.count[k:k + 1].to(sh.device),
                                f64=self._f64)
                for k, sh in enumerate(self.shards)]

    def _child_histogram(self, buf, child: torch.Tensor,
                         valid: torch.Tensor,
                         totals: torch.Tensor) -> torch.Tensor:
        return self._unpack(self._reduce(self._child_parts(buf, child,
                                                           valid)),
                            buf.state.gh, totals)
