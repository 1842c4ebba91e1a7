"""Training over several devices and processes.

Port of ``lightgbm_tpu/parallel`` (reference: src/network/ and the
data-, feature- and voting-parallel tree learners). In one process a
:class:`Mesh` lists the devices the rows (``data``, ``voting``) or the
features (``feature``) are sharded over; each shard runs the histogram
kernel over its part and the partials are summed in shard order.
Across processes, ``distributed`` and ``dtrain`` train over a
``torch.distributed`` group, all-reducing the kernel's histograms.
"""
from .data_parallel import DataParallelTreeLearner, Mesh, make_mesh
from .feature_parallel import FeatureParallelTreeLearner
from .voting_parallel import VotingParallelTreeLearner

__all__ = ["DataParallelTreeLearner", "FeatureParallelTreeLearner",
           "VotingParallelTreeLearner", "make_mesh", "Mesh"]
