"""Tree-learner factory (port of ``lightgbm_tpu/treelearner``).

``tree_learner`` picks the learner (reference:
src/treelearner/tree_learner.cpp:15-55): ``serial``, or one of the mesh
learners of ``parallel/`` (``data``, ``feature``, ``voting``; the config
resolves ``data_parallel`` and the other upstream spellings), over the
``mesh`` given, else ``make_mesh`` of the learner's device type sized by
``mesh_shape`` (``"data=4"``). With ``mesh_shape`` unset the mesh is the
learner's own device: a mesh over several cards is asked for, never
implied, until a two-card run has verified it (ROADMAP gaps).

The reference promotes a default ``serial`` learner on an accelerator
to its 1-device-mesh data learner (``lightgbm_tpu/treelearner/
__init__.py:30-49``), whose trees its tests pin to the serial
learner's, because there one dispatch per tree beats a host round trip
per split. The port does not copy this: its serial learner already
grows the whole tree as one captured CUDA graph, and a 1-device mesh
gives its trees text-equal. A sharded (out-of-core) dataset has one
learner, the shard-sweep :class:`~.sharded.ShardedTreeLearner`, as in
the reference (``:17-28``).
"""
from __future__ import annotations

import torch

from ..utils import log
from .serial import SerialTreeLearner


def mesh_size(config):
    """The device count of ``mesh_shape`` (its first axis; None when
    unset), as the reference reads it (``:60-70``)."""
    shape = str(config.mesh_shape or "")
    if not shape:
        return None
    try:
        return int(shape.split(",")[0].split("=")[1])
    except (IndexError, ValueError):
        log.fatal("cannot parse mesh_shape=%r (e.g. \"data=4\")" % shape)


def create_tree_learner(config, dataset, device: torch.device, mesh=None):
    name = config.tree_learner
    from ..io.shards import ShardedBinnedDataset
    if isinstance(dataset, ShardedBinnedDataset):
        if name != "serial":
            log.warning("tree_learner=%s requested but the dataset is "
                        "sharded (out-of-core); using the sharded "
                        "shard-sweep learner" % name)
        from .sharded import ShardedTreeLearner
        return ShardedTreeLearner(config, dataset, device)
    if name == "serial":
        return SerialTreeLearner(config, dataset, device)
    from ..parallel import (DataParallelTreeLearner,
                            FeatureParallelTreeLearner, Mesh,
                            VotingParallelTreeLearner, make_mesh)
    if mesh is None:
        n = mesh_size(config)
        mesh = (Mesh([device]) if n is None
                else make_mesh(n, torch.device(device).type))
    cls = {"data": DataParallelTreeLearner,
           "feature": FeatureParallelTreeLearner,
           "voting": VotingParallelTreeLearner}.get(name)
    if cls is None:
        log.fatal("Unknown tree learner type %s" % name)
    log.info("tree_learner=%s over %r" % (name, mesh))
    return cls(config, dataset, device, mesh)


__all__ = ["SerialTreeLearner", "create_tree_learner"]
