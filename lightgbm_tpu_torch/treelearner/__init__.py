"""Tree-learner factory (port of ``lightgbm_tpu/treelearner``).

The reference promotes ``tree_learner=serial`` on an accelerator to its
1-device-mesh data learner (``lightgbm_tpu/treelearner/__init__.py:41``),
which its tests pin to the same trees as the serial learner. The port
keeps the serial learner on every device; the mesh learners are ROADMAP
item 22. A sharded (out-of-core) dataset has one learner, the shard-sweep
:class:`~.sharded.ShardedTreeLearner`, as in the reference (``:17-28``).
"""
from __future__ import annotations

import torch

from ..utils.log import unsupported
from .serial import SerialTreeLearner


def create_tree_learner(config, dataset, device: torch.device):
    if config.tree_learner != "serial":
        unsupported("tree_learner=%s" % config.tree_learner, "item 22")
    from ..io.shards import ShardedBinnedDataset
    if isinstance(dataset, ShardedBinnedDataset):
        from .sharded import ShardedTreeLearner
        return ShardedTreeLearner(config, dataset, device)
    return SerialTreeLearner(config, dataset, device)


__all__ = ["SerialTreeLearner", "create_tree_learner"]
