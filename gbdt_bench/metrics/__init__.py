"""Per-layer metric readers: ``<name>.py`` (or ``<part before the first
dot>.py``) with ``read(ctx) -> float or None``; ``ctx`` is a
:class:`gbdt_bench.harness.Layer`. A reader that finds nothing to read
returns None and the metric is left out of the result line."""
import os


def names_in(ctx, folder: str):
    """The non-empty, non-comment lines of every ``.txt`` file in
    ``metrics/<folder>/``: a later PR adds a file beside the others."""
    d = os.path.join(ctx.bench_dir, "metrics", folder)
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".txt"):
            with open(os.path.join(d, f)) as fh:
                out += [ln.strip() for ln in fh
                        if ln.strip() and not ln.startswith("#")]
    return out


def splits(trees) -> int:
    return sum(t.num_leaves - 1 for t in trees)
