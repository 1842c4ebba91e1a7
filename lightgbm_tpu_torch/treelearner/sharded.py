"""Out-of-core sharded tree learner.

Port of ``lightgbm_tpu/treelearner/sharded.py``. Grows the serial
learner's trees over a :class:`~..io.shards.ShardedBinnedDataset` whose
binned rows never sit on the device all at once: every histogram pass
is an ordered sweep over the memory-mapped shards, each staged by the
double-buffered :class:`~..io.shards.ShardPrefetcher` while the
previous one computes.

What it shares with :class:`~.serial.SerialTreeLearner` (it is one):
the gh staging (quantized rows, the tree's feature mask and
extra_trees key), the root's scan, the split tail
(:meth:`~.serial.SerialTreeLearner._finish_split`: sibling by
subtraction, both children's scans and candidates, the record), the
partition rule (``_go_left`` over a shard's rows) and the record replay
into the host tree. The [N, 4] gh rows and the [N] row->leaf vector
stay on the device (a shard's rows are a contiguous slice of both);
the row ids and the K row lists are one set of buffers of the largest
shard's size, reused by every shard.

**Histograms through the hand kernel.** For each pending leaf, a shard's
rows of the smaller child are compacted in ascending order into a row
list with its length on the device (no host read), and the histogram
kernel (``ops/histogram.py::build_histogram``: K1 for f32 rows, K2 for
int8, the int16 instance for 16-bit) adds that shard's histogram into
the leaf's running accumulator (``into=``). On the CPU the plain
version continues its row-order adds from the running sums, as the
reference's ``_accum_hist`` seeds its scatter, so f32 trees are
text-equal to the in-memory learner's; on the card the f32 partial sums
of a shard are added as a block (another order of adds than one pass:
level (b)/(c)), while integer sums are exact everywhere. The kernel
launches once per shard and histogram pass: the root's pass and one per
pending leaf of each round.

**K splits per sweep** (``tpu_frontier_splits``, default 8; reference
``_grow_kbatch``): a round speculates the top-K candidates of the store
(``ops/split.py::select_frontier``, slot 0 the argmax), routes all K
splits' rows and histograms all K smaller children in one staging
sweep, then validates on the device, slot by slot, that the store's
argmax still names the speculated leaf: an accepted prefix reproduces
the one-split-at-a-time order exactly, a rejected tail is undone (its
rows go back to their leaf) and re-speculated. One host read per round:
the accepted mask and the next speculation. The staging traffic is
paid once per round instead of once per split. Within a shard the K
routings and the K row lists are made by a few [rows, K] ops, not K
sets of them. The round's finish (K validated split tails: subtraction,
two scans each) works on fixed buffers and is captured once per
learner as a CUDA graph and replayed every round on the card (eager on
the CPU), as the serial learner captures its split step.

**Cross-iteration prefetch** (reference ``:491-505``): the sweep started
for a round that never ran (the tree ended), or at the end of
``train``, is kept for the next tree's root, so shard 0 stages while the
boosting layer updates scores and computes gradients.

Refused here, as in the reference (``LightGBMError`` at setup): CEGB,
the intermediate and advanced monotone methods (``basic`` works: it
lives in the scan), forced splits, interaction constraints and
``feature_fraction_bynode``, linear trees, and EFB (a sharded dataset
never bundles). ``tpu_use_f64_hist`` is ignored with a warning.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..io.shards import ShardedBinnedDataset, ShardPrefetcher
from ..models.tree import Tree
from ..obs import compile as obs_compile
from ..obs.registry import registry as obs
from ..ops import split as S
from ..ops.histogram import build_histogram
from ..ops.split import select_frontier, unpack_cat_mask
from ..utils import log
from ..utils.log import LightGBMError
from .serial import (GrowState, SerialTreeLearner, SplitRecord,
                     apply_split_record, go_left_on_device,
                     record_is_valid, record_valid)


#: the record of a speculation slot with no valid candidate
_DEAD = SplitRecord(0, float("-inf"), -1, 0, False, *([0.0] * 10))


def check_sharded_config(config, dataset: ShardedBinnedDataset) -> None:
    """Raise for the modes the sharded learner refuses (reference
    ``_check_unsupported``, sharded.py:524-548)."""
    if dataset.bundle is not None:
        log.fatal("sharded datasets never carry EFB bundles")
    if config.linear_tree:
        log.fatal("linear_tree needs raw rows resident; not supported "
                  "with sharded datasets")
    if config.forcedsplits_filename:
        log.fatal("forced splits are not supported with sharded datasets")
    if (config.cegb_tradeoff < 1.0 or config.cegb_penalty_split > 0.0
            or config.cegb_penalty_feature_coupled
            or config.cegb_penalty_feature_lazy):
        log.fatal("CEGB is not supported with sharded datasets")
    if config.interaction_constraints \
            or 0.0 < float(config.feature_fraction_bynode) < 1.0:
        log.fatal("per-node feature masks (interaction_constraints / "
                  "feature_fraction_bynode) are not supported with "
                  "sharded datasets")
    if config.monotone_constraints and any(
            int(v) != 0 for v in config.monotone_constraints) \
            and config.monotone_constraints_method != "basic":
        log.fatal("monotone_constraints_method=%s needs resident "
                  "histogrammed rescans; only 'basic' is supported with "
                  "sharded datasets" % config.monotone_constraints_method)


class _RoundBuffers(NamedTuple):
    """The sweep rounds' fixed buffers (one set per learner; the captured
    finish reads and writes them in place)."""
    state: GrowState
    leaves: torch.Tensor       # [K] int64: the speculated leaves
    rows: torch.Tensor         # [K, W] f32: their record rows
    hists: torch.Tensor        # [K, Fp, B, 4]: the smaller children's
    next_leaf: torch.Tensor    # 0-d int64: the first new leaf's id
    n_valid: torch.Tensor      # 0-d int64: slots speculated this round
    accepted: torch.Tensor     # [K] bool
    qscale: Optional[torch.Tensor]  # [2] f32 (quantized mode)


class ShardedTreeLearner(SerialTreeLearner):
    """Leaf-wise grower over memory-mapped binned shards."""

    def __init__(self, config, dataset: ShardedBinnedDataset,
                 device: torch.device):
        check_sharded_config(config, dataset)
        super().__init__(config, dataset, device)
        if self._f64:
            log.warning("tpu_use_f64_hist is ignored on the sharded path "
                        "(f32 running sums per leaf)")
            self._f64 = False
        self._offsets = [int(o) for o in dataset.shard_offsets]
        self._sizes = [int(n) for n in dataset.shard_sizes]
        self._K = max(1, min(int(config.tpu_frontier_splits), self.L - 1))
        # one set for all shards, sliced to a shard's size: row ids and
        # the K row lists with a trash slot (the kernel reads a list's
        # length from the device; the launches of one shard are ordered
        # before the next shard's scatter on the stream)
        n_max = max(self._sizes)
        self._rows = torch.arange(n_max, dtype=torch.int32, device=device)
        self._idx = torch.zeros((self._K, n_max + 1), dtype=torch.int32,
                                device=device)
        self._counts = torch.zeros(self._K, dtype=torch.int32,
                                   device=device)
        self._slots = torch.arange(self._K, device=device)
        self._rb: Optional[_RoundBuffers] = None
        self._round_graph = None
        self._next_sweep = None
        self.grow_stats.update(dict.fromkeys(
            ("sweeps", "hist_passes", "rounds", "rejected"), 0))

    # ------------------------------------------------------------------
    # SerialTreeLearner hooks
    # ------------------------------------------------------------------
    def _stage_bins(self, dataset, ncols: int) -> None:
        """No resident matrix: the prefetcher stages shards per sweep."""
        self.prefetcher = ShardPrefetcher(dataset, self.Fp, self.device)

    @property
    def bins(self):
        raise LightGBMError("this operation re-scores the training rows "
                            "from a resident bin matrix (DART drops, "
                            "rollback, init_model replay); not supported "
                            "with sharded out-of-core datasets")

    def bin_blocks(self):
        """(first row, [n_k, Fp] device bins) of every shard, in order,
        staged by the prefetcher (the boosting layer's score replay)."""
        for k, bins in self.prefetcher.sweep():
            yield self._offsets[k], bins

    def supports_train_many(self) -> bool:
        return False

    def reset_config(self, config) -> None:
        check_sharded_config(config, self.dataset)
        super().reset_config(config)
        K = max(1, min(int(config.tpu_frontier_splits), self.L - 1))
        if K != self._K:
            raise LightGBMError("tpu_frontier_splits cannot change while "
                                "a sharded learner trains")
        # the captured finish holds the old split parameters
        self._round_graph = None

    def _sweep(self):
        self.grow_stats["sweeps"] += 1
        return self.prefetcher.sweep()

    def _root_histogram(self, gh: torch.Tensor,
                        sums_raw: torch.Tensor) -> torch.Tensor:
        """The root's histogram: one pass over every shard's rows, added
        shard by shard into one accumulator (the sweep stashed by the
        previous tree when there is one)."""
        hist = torch.zeros((self.Fp, self.B, 4),
                           dtype=self._acc_dtype(gh), device=self.device)
        sweep, self._next_sweep = self._next_sweep, None
        if sweep is None:
            sweep = self._sweep()
        for k, bins in sweep:
            o, n = self._offsets[k], self._sizes[k]
            build_histogram(bins, gh[o:o + n], self.B, into=hist)
        self.grow_stats["hist_passes"] += 1
        return hist

    @staticmethod
    def _acc_dtype(gh: torch.Tensor) -> torch.dtype:
        return torch.float32 if gh.dtype.is_floating_point else torch.int32

    # ------------------------------------------------------------------
    def release_prefetch(self) -> None:
        """Drop the cross-iteration sweep (it holds a staged shard); the
        next tree starts a fresh one."""
        self._next_sweep = None

    def _round_buffers(self, gh: torch.Tensor) -> _RoundBuffers:
        """The fixed buffers, made at the first tree; each tree copies
        its rows and scales into them."""
        if self._rb is None:
            dev, K = self.device, self._K
            state = self._new_state(torch.empty_like(gh))
            self._rb = _RoundBuffers(
                state=state,
                leaves=torch.zeros(K, dtype=torch.int64, device=dev),
                rows=torch.zeros((K, self._record_width),
                                 dtype=torch.float32, device=dev),
                hists=torch.zeros((K, self.Fp, self.B, 4),
                                  dtype=self._acc_dtype(gh), device=dev),
                next_leaf=torch.zeros((), dtype=torch.int64, device=dev),
                n_valid=torch.zeros((), dtype=torch.int64, device=dev),
                accepted=torch.zeros(K, dtype=torch.bool, device=dev),
                qscale=(torch.empty(2, dtype=torch.float32, device=dev)
                        if self._quantized else None))
        rb = self._rb
        rb.state.gh.copy_(gh)
        if rb.qscale is not None:
            rb.qscale.copy_(self._qscale)
        return rb

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag: Optional[torch.Tensor] = None
              ) -> Tuple[Tree, torch.Tensor]:
        """Grow one tree over the shard sweeps; returns the host Tree and
        the device [N] row->leaf vector, as the serial learner does."""
        with obs.scope("tree::stage_gh"):
            gh = self._stage_tree(grad, hess, bag)
            obs.watch_ready("tree::stage_gh", gh)
        rb = self._round_buffers(gh)
        self._root(rb.state)
        tree = Tree(self.L)
        with obs.scope("tree::shard_rounds"):
            self._grow_rounds(tree, rb)
        if self._next_sweep is None:
            # the next tree's root sweep starts now: shard 0 stages while
            # the boosting layer updates scores and takes gradients
            self._next_sweep = self._sweep()
        # the buffers are the next tree's
        return tree, rb.state.leaf_of_row.clone()

    # ------------------------------------------------------------------
    def _speculate(self, rb: _RoundBuffers) -> None:
        """The top-K candidates into ``rb.leaves`` / ``rb.rows``, each
        row's gain the selection value."""
        leaves, vals = select_frontier(rb.state.cand[:, S.GAIN], self._K)
        rb.leaves.copy_(leaves)
        rb.rows.copy_(rb.state.cand.index_select(0, leaves))
        rb.rows[:, S.GAIN] = vals

    def _read_round(self, rb: _RoundBuffers, with_accepted: bool):
        """One host read: the accepted mask of the round just finished
        (when ``with_accepted``) and the next speculation's records."""
        parts = [rb.leaves.to(torch.float32)[:, None], rb.rows]
        packed = torch.cat(parts, dim=1).view(-1)
        if with_accepted:
            packed = torch.cat([rb.accepted.to(torch.float32), packed])
        host = packed.tolist()
        acc = None
        if with_accepted:
            acc, host = [v > 0.5 for v in host[:self._K]], host[self._K:]
        W = self._record_width
        recs = []
        for i in range(self._K):
            leaf = int(host[i * (1 + W)])
            row = host[i * (1 + W) + 1:(i + 1) * (1 + W)]
            gain = row[S.GAIN]
            if row[S.FEATURE] >= 0 and np.isfinite(gain) and gain > 0.0:
                recs.append(SplitRecord.from_row(leaf, row, self.layout))
            else:
                # a dead slot (an empty candidate's fill values)
                recs.append(_DEAD._replace(leaf=leaf))
        self.grow_stats["record_reads"] += 1
        return acc, recs

    def _grow_rounds(self, tree: Tree, rb: _RoundBuffers) -> None:
        """Sweep rounds until the tree has L leaves or no valid split."""
        L = self.L
        self._speculate(rb)
        # the first round's sweep starts before the read below
        pending = self._sweep() if L > 1 else None
        _, recs = self._read_round(rb, False)
        next_leaf = 1
        while next_leaf < L:
            n_slots = min(self._K, L - next_leaf)
            n_valid = 0
            while n_valid < n_slots and record_is_valid(recs[n_valid]):
                n_valid += 1
            if n_valid == 0:
                break
            if pending is None:
                pending = self._sweep()
            rb.next_leaf.fill_(next_leaf)
            rb.n_valid.fill_(n_valid)
            self._sweep_round(rb, pending, n_valid, next_leaf)
            # the next round's sweep starts before this round's read
            pending = (self._sweep() if next_leaf + n_valid < L
                       else None)
            self._finish_round(rb, n_valid)
            self._speculate(rb)
            acc, new_recs = self._read_round(rb, True)
            n_acc = 0
            while n_acc < n_valid and acc[n_acc]:
                n_acc += 1
            for rec in recs[:n_acc]:
                apply_split_record(tree, self.dataset, rec)
            self.grow_stats["rounds"] += 1
            self.grow_stats["rejected"] += n_valid - n_acc
            self.grow_stats["steps"] += n_acc
            recs = new_recs
            next_leaf += n_acc
            if n_acc == 0:
                break   # slot 0 is the argmax: never reached
        # a sweep started for a round that did not run is a whole fresh
        # sweep: the next tree's root takes it
        self._next_sweep = pending

    def _round_columns(self, rb: _RoundBuffers, next_leaf: int):
        """Per-slot values of the round's routing, as [K, 1] columns for
        [K, n] broadcasts (slot-major, so a cumsum runs along the rows of
        one slot, PyTorch's fast scan): the split features, their
        thresholds, default directions and missing rules, the
        categorical masks ([K, B]), the new leaves' ids, the smaller
        children's ids and which slots are live."""
        meta, rows = self.meta, rb.rows
        f = torch.clamp(rows[:, S.FEATURE], min=0.0).long()
        live = self._slots < rb.n_valid
        new = next_leaf + self._slots
        smaller_is_left = (rows[:, S.LEFT_TOTAL_COUNT]
                           <= rows[:, S.RIGHT_TOTAL_COUNT])
        small = torch.where(smaller_is_left, rb.leaves, new)
        cols = dict(
            f=f, tbin=rows[:, S.THRESHOLD_BIN].to(torch.int32)[:, None],
            dl=(rows[:, S.DEFAULT_LEFT] > 0.0)[:, None],
            mt=meta.missing_type.index_select(0, f)[:, None],
            nan=(meta.num_bin.index_select(0, f) - 1)[:, None],
            zero=meta.zero_bin.index_select(0, f)[:, None],
            leaf=torch.where(live, rb.leaves, -2).to(torch.int32)[:, None],
            new=new.to(torch.int32)[:, None],
            small=torch.where(live, small, -2).to(torch.int32)[:, None])
        if self._has_cat:
            cols["cat"] = (rows[:, S.IS_CATEGORICAL] > 0.0)[:, None]
            cols["mask"] = unpack_cat_mask(rows[:, self.layout.cat_words],
                                           self.B)
        return cols

    def _sweep_round(self, rb: _RoundBuffers, sweep, n_valid: int,
                     next_leaf: int) -> None:
        """One staging sweep of a round: per shard, route the rows of
        every speculated split (the leaf's rows that split sends right
        go to ``next_leaf + i``), then histogram every split's smaller
        child in this shard into its running accumulator. The
        speculated leaves are distinct, so the routings commute and each
        child's rows are those the one-split-at-a-time order would
        give; a row moves at most once, by the one slot of its leaf."""
        st = rb.state
        rb.hists.zero_()
        c = self._round_columns(rb, next_leaf)
        for k, bins in sweep:
            o, nk = self._offsets[k], self._sizes[k]
            seg = st.leaf_of_row[o:o + nk]
            gh = st.gh[o:o + nk]
            col = self._bin_columns(bins, c["f"])            # [K, nk]
            gl = go_left_on_device(col, c["tbin"], c["dl"], c["mt"],
                                   c["nan"], c["zero"])
            if self._has_cat:
                gl = torch.where(c["cat"], c["mask"].gather(1, col.long()),
                                 gl)
            move = (seg[None, :] == c["leaf"]) & ~gl
            seg.copy_(torch.where(move.any(dim=0),
                                  (move.to(torch.int32)
                                   * c["new"]).sum(dim=0, dtype=torch.int32),
                                  seg))
            is_small = seg[None, :] == c["small"]
            pos = torch.cumsum(is_small, dim=1, dtype=torch.int32)
            self._counts.copy_(pos[:, -1])
            dest = torch.where(is_small, pos - 1, nk)
            idx = self._idx[:, :nk + 1]
            idx.scatter_(1, dest.long(),
                         self._rows[:nk][None].expand(self._K, nk))
            for i in range(n_valid):
                build_histogram(bins, gh, self.B, idx[i],
                                self._counts[i:i + 1], into=rb.hists[i])
        self.grow_stats["hist_passes"] += n_valid

    def _bin_columns(self, bins: torch.Tensor,
                     f: torch.Tensor) -> torch.Tensor:
        """[K, n] int32 bin values of columns ``f`` of ``bins`` (slot
        major)."""
        if bins.dtype == torch.uint16:
            v = bins.view(torch.int16).index_select(1, f)
            return (v.to(torch.int32) & 0xFFFF).t().contiguous()
        return bins.index_select(1, f).t().contiguous().to(torch.int32)

    def _finish_round(self, rb: _RoundBuffers, n_valid: int) -> None:
        """Validate and apply the round's splits: on the card the
        captured finish (:meth:`_finish_all` over all K slots) replays,
        on the CPU it runs eagerly over the ``n_valid`` speculated ones
        (the others would write nothing)."""
        if self.device.type != "cuda":
            self._finish_all(rb, n_valid)
            return
        if self._round_graph is None:
            self._capture_round(rb)
            return
        self._round_graph.replay()
        self.grow_stats["replays"] += 1

    def _capture_round(self, rb: _RoundBuffers) -> None:
        """Run this round's finish eagerly on a side stream (the warm-up
        the ``torch.cuda.graphs`` docs ask for; it is the round's real
        finish), then capture it as the learner's graph. The capture
        itself runs nothing: the state is left as the eager run made it.
        A failure raises: there is no fallback."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._finish_all(rb)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            # thread_local: a server or another learner may use the
            # card from its own thread meanwhile (the refresh loop);
            # "global" would make their syncs fail this capture
            with torch.cuda.graph(graph,
                                  capture_error_mode="thread_local"):
                self._finish_all(rb)
        except RuntimeError as exc:
            raise LightGBMError("sharded learner: capturing the round's "
                                "finish as a CUDA graph failed: %s"
                                % exc) from exc
        seconds = time.perf_counter() - t0
        self.grow_stats["captures"] += 1
        self.grow_stats["capture_ms"] += 1e3 * seconds
        obs_compile.record_graph_capture("sharded.finish_round", seconds)
        self._round_graph = graph

    def _finish_all(self, rb: _RoundBuffers,
                    slots: Optional[int] = None) -> None:
        """The round's K validated split tails on the fixed buffers, with
        no host read: slot i is accepted while every earlier slot was,
        it was speculated (``i < n_valid``) and the store's argmax still
        names its leaf (the one-split order); an accepted slot runs the
        serial learner's split tail (``_finish_split``), a rejected one
        writes nothing and its rows go back to its leaf. Fills
        ``rb.accepted``. ``slots`` (all K by default) bounds the slots
        visited; the ones past it are rejected."""
        st, L = rb.state, self.L
        slots = self._K if slots is None else slots
        rb.accepted.zero_()
        alive = torch.ones((), dtype=torch.bool, device=self.device)
        for i in range(slots):
            leaf = rb.leaves[i:i + 1]
            new_leaf = torch.clamp(rb.next_leaf + i, max=L - 1).view(1)
            best = torch.argmax(st.cand[:, S.GAIN]).view(1)
            ok = (alive & (rb.n_valid > i) & (best == leaf)[0]
                  & record_valid(rb.rows[i]))
            self._finish_split(st, leaf, new_leaf, rb.rows[i], rb.hists[i],
                               ok, rb.qscale)
            rb.accepted[i] = ok
            alive = ok
        lor = st.leaf_of_row
        for i in range(slots):
            back = ((rb.n_valid > i) & ~rb.accepted[i]
                    & (lor == (rb.next_leaf + i).to(torch.int32)))
            lor.copy_(torch.where(back, rb.leaves[i].to(torch.int32), lor))
