"""OpenMetrics text-format primitives: escaping, sample lines, parsing.

The port's own copy of ``lightgbm_tpu/obs/openmetrics.py`` (the port
imports nothing of the JAX package). Split out of :mod:`obs.export` so
the format layer has ZERO package dependencies — no registry, no
relative imports — and can be loaded by path by a report script. The
metric prefix stays ``lightgbm_tpu_``: a deployment's dashboards read
the same names from either package.

- :mod:`obs.gateway` re-renders pushed snapshots with injected
  ``{rank=,process=}`` labels and must share one escaping/parsing
  contract with :func:`obs.export.render_openmetrics` (which re-exports
  everything here, so existing ``from obs.export import
  parse_openmetrics`` call sites are unchanged).

The format is the OpenMetrics-style subset the exporter emits:
``# TYPE`` headers, ``name{label="value"} number`` sample lines, a
``# EOF`` terminator. :func:`parse_openmetrics` is strict (raises
ValueError on a malformed sample line) — the round-trip tests depend
on malformed text failing loudly, and the gateway turns that ValueError
into an HTTP 400 instead of silently aggregating garbage.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

kPrefix = "lightgbm_tpu_"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _san(name: str) -> str:
    s = _NAME_RE.sub("_", name)
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def _esc(label_value) -> str:
    return (str(label_value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _lbl(labels, extra=()) -> str:
    """Render a ``{k="v",...}`` label block (empty string when there
    are no labels)."""
    pairs = list(labels or ()) + list(extra)
    if not pairs:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _esc(v)) for k, v in pairs)


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_][a-zA-Z0-9_]*)(?:\{(.*)\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_TYPE_RE = re.compile(r'^#\s*TYPE\s+(\S+)\s+(\S+)\s*$')

Sample = Tuple[str, Tuple[Tuple[str, str], ...]]


def parse_openmetrics(text: str) -> Dict[Sample, float]:
    """Parse OpenMetrics-style text back into
    ``{(name, ((label, value), ...)): float}``. Raises ValueError on a
    malformed sample line — the round-trip tests depend on strictness."""
    out: Dict[Sample, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError("malformed sample line: %r" % line)
        name, labels_raw, value = m.groups()
        labels = []
        if labels_raw:
            matched = _LABEL_RE.findall(labels_raw)
            stripped = _LABEL_RE.sub("", labels_raw).replace(",", "").strip()
            if stripped:
                raise ValueError("malformed labels: %r" % labels_raw)
            # single left-to-right scan: sequential .replace() passes
            # would let an escaped backslash donate its second half to
            # a following 'n' or '"' (r'C:\\nightly' -> 'C:\' + \n)
            unesc = re.compile(r"\\(.)")
            labels = [(k, unesc.sub(
                lambda m: "\n" if m.group(1) == "n" else m.group(1), v))
                for k, v in matched]
        out[(name, tuple(sorted(labels)))] = float(value)
    return out


def parse_type_headers(text: str) -> Dict[str, str]:
    """``# TYPE name kind`` headers of an OpenMetrics document —
    the family metadata :func:`parse_openmetrics` deliberately skips.
    The gateway carries these through aggregation so a re-rendered
    family keeps its original kind."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        m = _TYPE_RE.match(line.strip())
        if m is not None:
            out[m.group(1)] = m.group(2)
    return out


def metric_value(parsed: Dict[Sample, float], name: str,
                 **labels) -> Optional[float]:
    """Convenience lookup into :func:`parse_openmetrics` output."""
    key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
    return parsed.get(key)


def sum_metric(parsed: Dict[Sample, float], name: str,
               **labels) -> float:
    """Sum every sample of ``name`` whose labels INCLUDE the given
    pairs (a family-level aggregate where :func:`metric_value` is an
    exact-key lookup) — e.g. total stage seconds of one rank across
    all its stages."""
    want = set((k, str(v)) for k, v in labels.items())
    total = 0.0
    for (n, lbls), v in parsed.items():
        if n == name and want.issubset(set(lbls)):
            total += v
    return total
