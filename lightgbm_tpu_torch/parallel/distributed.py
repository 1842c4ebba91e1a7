"""Multi-process distributed training over ``torch.distributed``.

Port of ``lightgbm_tpu/parallel/distributed.py`` (reference: the
machine-list bootstrap, src/network/linkers_socket.cpp:166; rank-sharded
BinMapper construction with Allgather, src/io/dataset_loader.cpp:
1070-1240):

- :func:`initialize` starts the process group
  (``torch.distributed.init_process_group``): the coordinator address
  becomes the init method (``tcp://host:port``, or ``file://path`` for
  ranks on one host) and the process id the rank. The backend is
  explicit: NCCL where each rank has its own card, gloo on the CPU.
  NCCL refuses two ranks on one card, so two ranks on one card pass
  ``backend="gloo"``, which all-reduces CUDA tensors through the host.
  The group's timeout is the collective bound of ``dtrain.py``
  (``LIGHTGBM_TPU_DTRAIN_TIMEOUT_S``). :func:`rank_device` gives each
  NCCL rank its own card (``LOCAL_RANK``, else the rank modulo the
  visible cards) and refuses two ranks of one host on one card. The
  NCCL path needs two cards and is not verified.
- :func:`distributed_binned_dataset`: each rank samples its local rows
  (seed ``data_random_seed + rank``), the samples and their counts are
  all-gathered as CPU tensors (f64 rows, exactly), and every rank builds
  the same mappers from the rank-ordered sample, then bins its own rows.
- :class:`DistributedDataParallelLearner`: the data-parallel learner
  over this rank's rows, one shard on this rank's device; its reduce is
  ``all_reduce(SUM)`` of the kernel's output (and of the root's sums)
  across the ranks, so every rank scans the same sums and grows the
  same tree. A sum of two partials is the same in either order, so two
  ranks give the trees of an in-process two-shard mesh on the same row
  split.

The reference pads every process's rows to one block size because one
global JAX array must split evenly over the devices, and finds the pad
rows by their zero total-count channel (:184). Here no array spans the
ranks: only histograms and sums, whose shapes every rank shares, cross
them, so each rank keeps exactly its own rows and needs no pad rows.

gloo's collectives cannot be captured in a CUDA graph, so this learner
runs its whole-tree step eagerly (one all-reduce per split, and a sync:
gloo stages CUDA tensors through the host). NCCL's could be captured on
two cards; that path is not verified and runs eagerly too. Quantized
gradients fall back to f32 with the reference's warning (:131-142), and
``train_many`` is off (:117).
"""
from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, resolve_device
from ..io.dataset import BinnedDataset
from ..ops.quantize import sum_gh
from ..utils import log
from ..utils.log import LightGBMError
from .data_parallel import DataParallelTreeLearner, Mesh, padded_rows

_host_group = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Start the process group (reference ``initialize``, :40;
    Network::Init). ``coordinator_address`` is ``host:port``, a
    ``tcp://`` or ``file://`` URL, or None for the ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``backend`` defaults to NCCL when a card is visible (each rank its
    own card) and gloo otherwise."""
    from .dtrain import collective_timeout
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        method = "env://"
    elif "://" in coordinator_address:
        method = coordinator_address
    else:
        method = "tcp://" + coordinator_address
    kw = {}
    seconds = collective_timeout()
    if seconds > 0:
        kw["timeout"] = datetime.timedelta(seconds=seconds)
    dist.init_process_group(backend=backend, init_method=method,
                            world_size=-1 if num_processes is None
                            else int(num_processes),
                            rank=-1 if process_id is None
                            else int(process_id), **kw)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_group():
    """The group for CPU-tensor collectives: the default group under
    gloo, a gloo group beside an NCCL one (NCCL moves only CUDA
    tensors)."""
    global _host_group
    if dist.get_backend() == "gloo":
        return None
    if _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return _host_group


def all_gather_host(t: torch.Tensor) -> list:
    """Every rank's CPU tensor ``t`` (one shape on every rank), in rank
    order."""
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t, group=host_group())
    return out


def rank_device(config: Config) -> torch.device:
    """This rank's device. On the CPU, the CPU. Under NCCL every rank
    needs a card of its own (NCCL refuses two ranks on one card): the
    card is ``gpu_device_id`` when the rank's params set it, else
    ``LOCAL_RANK`` (set by ``torchrun``), else the rank modulo the
    visible cards; it becomes the current device, and two ranks of one
    host on one card raise. Under gloo every rank takes
    ``gpu_device_id``'s card (the first by default): ranks may share a
    card there."""
    from .dtrain import run_collective
    device = resolve_device(config)
    if device.type != "cuda" or dist.get_backend() != "nccl":
        return device
    if int(config.gpu_device_id) >= 0:
        index = int(config.gpu_device_id)
    elif os.environ.get("LOCAL_RANK") is not None:
        index = int(os.environ["LOCAL_RANK"])
    else:
        index = rank() % torch.cuda.device_count()
    device = torch.device("cuda", index)
    torch.cuda.set_device(device)
    cards = [None] * world_size()
    run_collective(lambda: dist.all_gather_object(
        cards, (socket.gethostname(), index), group=host_group()),
        what="card_allgather")
    if len(set(cards)) < len(cards):
        log.fatal("NCCL needs a card per rank; the ranks' (host, card) "
                  "are %s. Set LOCAL_RANK or gpu_device_id per rank, or "
                  "pass backend='gloo' to share a card" % cards)
    return device


def global_mesh(device: torch.device) -> Mesh:
    """This rank's part of the mesh that spans the process group: its
    one device (reference ``global_mesh``, :51, a mesh over every
    device of every process)."""
    return Mesh([device])


def distributed_binned_dataset(local_X: np.ndarray, config: Config,
                               label: Optional[Sequence[float]] = None,
                               **kw) -> BinnedDataset:
    """Distributed binning (reference ``distributed_binned_dataset``,
    :56): sample locally, all-gather the samples, build identical
    mappers everywhere, bin only the local rows."""
    from .dtrain import run_collective
    local_X = np.asarray(local_X, dtype=np.float64)
    n_local = local_X.shape[0]
    n_proc = world_size()
    per_proc = max(1, config.bin_construct_sample_cnt // n_proc)
    rng = np.random.RandomState(config.data_random_seed + rank())
    take = min(per_proc, n_local)
    idx = (np.sort(rng.choice(n_local, take, replace=False))
           if take < n_local else np.arange(n_local))
    sample = local_X[idx]
    counts = torch.cat(run_collective(
        lambda: all_gather_host(torch.tensor([take], dtype=torch.int64)),
        what="sample_count_allgather")).numpy()
    max_take = int(counts.max())
    # pad to one shape for the all-gather; the counts trim it back
    padded = np.zeros((max_take, local_X.shape[1]), dtype=np.float64)
    padded[:take] = sample
    gathered = run_collective(
        lambda: all_gather_host(torch.from_numpy(padded)),
        what="sample_allgather")
    full_sample = np.concatenate([g.numpy()[:int(c)]
                                  for g, c in zip(gathered, counts)])
    cfg2 = Config.from_params(dict(config.raw_params,
                                   bin_construct_sample_cnt=len(
                                       full_sample)))
    template = BinnedDataset.from_matrix(full_sample, cfg2)
    ds = BinnedDataset.from_matrix(local_X, config, label=label,
                                   reference=template, **kw)
    ds.num_total_features = template.num_total_features
    return ds


class DistributedDataParallelLearner(DataParallelTreeLearner):
    """The data-parallel learner over this rank's rows, its histograms
    and root sums all-reduced across the process group (reference
    ``DistributedDataParallelLearner``, :111)."""

    def __init__(self, config, local_dataset: BinnedDataset,
                 device: torch.device):
        if not dist.is_initialized():
            raise LightGBMError("the distributed learner needs an "
                                "initialized process group "
                                "(parallel.distributed.initialize)")
        #: all-reduces run and their wall time (a stream sync first on
        #: the card, so the kernel is not counted)
        self.comm_stats = {"allreduces": 0, "allreduce_ms": 0.0}
        super().__init__(config, local_dataset, device,
                         global_mesh(torch.device(device)))

    def _init_quantization(self, config) -> None:
        # the reference stages each process's rows on the host, where the
        # tree's global scale and per-row draw are not at hand (:131-142)
        self._quantized = False
        self._qscale = None
        if config.use_quantized_grad:
            log.warning("use_quantized_grad is not supported by the "
                        "multi-process distributed learner; training "
                        "falls back to exact f32 histograms")

    def supports_train_many(self) -> bool:
        return False

    def _captures_steps(self) -> bool:
        return False

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place. Under gloo a CUDA
        tensor goes through the host (a stream sync)."""
        staged = (t.device.type == "cuda"
                  and dist.get_backend() == "gloo")
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        buf = t.cpu() if staged else t
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        if staged:
            t.copy_(buf)
        self.comm_stats["allreduce_ms"] += 1e3 * (time.perf_counter() - t0)
        self.comm_stats["allreduces"] += 1
        return t

    def _reduce(self, parts) -> torch.Tensor:
        return self._all_reduce(parts[0].contiguous())

    def _root_sums(self, gh: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(sum_gh(gh, padded_rows(self.N)))

    def local_leaf_assignment(self, leaf_of_row: torch.Tensor) -> np.ndarray:
        """This rank's rows' leaves (reference :193): the partition the
        learner returns is already the local one."""
        return leaf_of_row.cpu().numpy()
