"""Row generators, one module per configuration's ``data.generator``.
Each gives ``make(spec, seed, device)``: the rows and labels of a run,
made on ``device`` from ``torch.Generator`` streams seeded by the run's
seed and handed back as host arrays, as a user hands them to the
program (float32 rows, float64 labels)."""
import importlib

import torch


def generator_for(name: str):
    return importlib.import_module(__name__ + "." + name).make


def torch_generator(seed: int, stream: int, device: torch.device):
    """A generator for stream ``stream`` of ``seed``: any whole number
    seed, folded into the 64 bits ``manual_seed`` takes."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + int(stream)) % (1 << 63))
    return g
