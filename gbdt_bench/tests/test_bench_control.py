"""The control and the faults, at a size a test run holds, through the
rest of a run with the harness's look for a chip skipped: the sound
program comes out correct; the control (the lower precision: bf16
gradients for training, the f32 walk for prediction) and each fault (a
step that leaves its state unchanged, half of the batch left out, an
answer altered where it is produced; for training also a tree learner
that scans half of the features and, where the cell compares the floor,
one that ignores the hessian floor) come out not correct. One card runs
each cell, so no exchange between chips can be left out."""
import pytest
import torch

from gbdt_bench import calibrate

CASES = [(w, v, v == "sound")
         for w, variants in (
             # higgs.train does not compare leaf_floor_gap: at its size no
             # leaf falls under the floor even with the floor off
             ("higgs.train", ("sound", "bf16", "unchanged", "half",
                              "altered", "altered_metric", "partial_scan")),
             ("mslr.train", ("sound", "bf16", "unchanged", "half",
                             "altered", "altered_metric", "partial_scan",
                             "no_leaf_floor")),
             ("higgs.predict", ("sound", "f32", "unchanged", "half",
                                "altered")))
         for v in variants]


@pytest.mark.parametrize("workload,variant,correct", CASES)
def test_control_and_faults(workload, variant, correct):
    torch.set_num_threads(2)
    rec = calibrate.readings(workload, 2147483659, 0.3, variant,
                             torch.device("cpu"), small=True)
    assert rec["correct"] is correct, rec["numbers"]
