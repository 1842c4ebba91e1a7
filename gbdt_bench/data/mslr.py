"""MSLR-WEB30K-shaped ranking rows (136 dense features, labels 0-4 in
queries): query lengths log-normal with a mean near 120, one query of the
longest length, and for the training part lengths adjusted to the stated
row count; a third of the features constant within a query; a third of
the rest heavy-tailed; labels cut from a noisy linear relevance at the
stated label shares. The relevance weights and the query lengths are
fixed (``relevance_seed``, ``lengths_seed``); rows and noise follow the
seed. The
pattern is the reference bench's ``make_mslr_like``."""
from __future__ import annotations

import numpy as np
import torch

from . import torch_generator

_F = 136
_QUERY_COLS = 45          # the last 45 columns are query-level


def _lengths(q: int, max_len: int, total, rng: np.random.Generator):
    lengths = np.clip(np.round(rng.lognormal(np.log(90.0), 0.75, q)), 1,
                      max_len).astype(np.int64)
    lengths[rng.integers(q)] = max_len
    if total is not None:
        keep = int(np.argmax(lengths == max_len))
        while True:
            diff = int(total) - int(lengths.sum())
            if diff == 0:
                break
            pick = rng.integers(q, size=min(abs(diff), q))
            pick = pick[pick != keep]
            np.add.at(lengths, pick, int(np.sign(diff)))
            np.clip(lengths, 1, max_len, out=lengths)
            lengths[keep] = max_len
    return lengths


def _part(q: int, total, spec, w, seed, stream, device):
    # the query lengths are fixed by ``lengths_seed``, so every seed does
    # the same work; the rows and the noise follow the seed
    rng = np.random.default_rng([int(spec["lengths_seed"]), stream])
    lengths = _lengths(q, int(spec["max_query_len"]), total, rng)
    n = int(lengths.sum())
    g = torch_generator(seed, stream, device)
    X = torch.randn((n, _F), generator=g, device=device)
    qid = torch.repeat_interleave(
        torch.arange(q, device=device),
        torch.from_numpy(lengths).to(device))
    qfeat = torch.randn((q, _QUERY_COLS), generator=g, device=device)
    X[:, _F - _QUERY_COLS:] = qfeat[qid]
    X[:, 1:91:3] = X[:, 1:91:3].abs() ** 1.5
    latent = (X * w).sum(dim=1) + torch.randn(
        n, generator=g, device=device) * 0.8
    return X, latent, lengths


def make(spec: dict, seed: int, device: torch.device) -> dict:
    wr = np.random.RandomState(int(spec["relevance_seed"]))
    w = np.zeros(_F, dtype=np.float32)
    w[wr.choice(91, 24, replace=False)] = wr.randn(24) * 0.6
    w[91:96] = wr.randn(5) * 0.3
    w = torch.from_numpy(w).to(device)
    shares = np.cumsum(spec["label_shares"])[:-1]
    out = {}
    cuts = None
    for part, stream in (("train", 0), ("held_out", 1)):
        q = int(spec[part + "_queries"])
        if q == 0:
            continue
        total = spec.get(part + "_rows")
        X, latent, lengths = _part(q, total, spec, w, seed, stream, device)
        if cuts is None:
            # the training part's quantiles cut both parts
            lat = latent.double().cpu().numpy()
            cuts = torch.from_numpy(np.quantile(lat, shares)).to(device)
        y = torch.searchsorted(cuts, latent.double().contiguous()).double()
        out[part] = {"X": X.cpu().numpy(), "label": y.cpu().numpy(),
                     "group": lengths}
        del X, latent
    return out
