"""Fleet-level federation of per-replica Prometheus expositions (port of
paddle_tpu/obs/fleetmetrics.py, a copy).

The router scrapes every replica's `/metrics` body and serves ONE
merged exposition on `/metrics/fleet`, so serve_bench and operators
read fleet-wide series without per-replica math:

- **counters** sum exactly across replicas per label set — a fleet
  total equals the sum of the per-replica scrapes by construction;
- **histograms** merge by summing the per-`le` cumulative bucket
  counts plus `_sum`/`_count`. Every replica builds its histograms
  from the same `DEFAULT_BUCKETS` layout (obs/metrics.py), so the
  bucket edges line up and the merge is exact — quantiles estimated
  from the merged buckets are the same as quantiles over the pooled
  observations, up to the usual one-bucket interpolation error;
- **gauges** do NOT sum meaningfully (occupancy is per-process), so
  each child is re-labelled with a `replica` label and exposed
  side by side.

Everything here is pure text -> text: the parser understands the
0.0.4 exposition format obs/metrics.py renders (HELP/TYPE headers,
escaped label values, `_bucket`/`_sum`/`_count` histogram children)
and the renderer re-emits the same format, so a fleet exposition is
scrapeable by the same consumers (sse.parse_prometheus_values,
serve_bench quantile helpers) as a single replica's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.obs.metrics import _escape, _fmt

LabelSet = Tuple[Tuple[str, str], ...]   # sorted (name, value) pairs


class ParsedFamily:
    """One metric family parsed out of an exposition body."""

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str = "untyped", help: str = ""):
        self.name = name
        self.kind = kind
        self.help = help
        # (suffix, labels, value): suffix is "", "_bucket", "_sum",
        # or "_count"; labels EXCLUDE `le` for buckets (it rides the
        # labels of the sample line but is split out by the parser)
        self.samples: List[Tuple[str, LabelSet, Optional[str], float]] = []


def _parse_labels(body: str) -> Dict[str, str]:
    """Parse `a="x",b="y"` honouring \\" and \\\\ escapes."""
    out: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        eq = body.index("=", i)
        name = body[i:eq].strip().lstrip(",").strip()
        i = eq + 1
        if i >= n or body[i] != '"':
            raise ValueError(f"bad label value at {body[i:]!r}")
        i += 1
        chars: List[str] = []
        while i < n:
            c = body[i]
            if c == "\\" and i + 1 < n:
                nxt = body[i + 1]
                chars.append({"n": "\n"}.get(nxt, nxt))
                i += 2
                continue
            if c == '"':
                i += 1
                break
            chars.append(c)
            i += 1
        out[name] = "".join(chars)
        while i < n and body[i] in ", ":
            i += 1
    return out


def _parse_sample(line: str) -> Tuple[str, Dict[str, str], float]:
    """`name{labels} value` -> (name, labels, value)."""
    if "{" in line:
        name, rest = line.split("{", 1)
        body, tail = rest.rsplit("}", 1)
        labels = _parse_labels(body) if body else {}
        value = float(tail.strip())
    else:
        name, tail = line.split(None, 1)
        labels = {}
        value = float(tail.strip())
    return name.strip(), labels, value


def parse_exposition(text: str) -> Dict[str, ParsedFamily]:
    """Parse one Prometheus 0.0.4 text body into families keyed by
    family name (histogram `_bucket`/`_sum`/`_count` samples fold into
    the histogram family declared by its `# TYPE` line)."""
    fams: Dict[str, ParsedFamily] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("TYPE", "HELP"):
                name = parts[2]
                fam = fams.setdefault(name, ParsedFamily(name))
                if parts[1] == "TYPE":
                    fam.kind = parts[3].strip() if len(parts) > 3 \
                        else "untyped"
                else:
                    fam.help = parts[3] if len(parts) > 3 else ""
            continue
        sample_name, labels, value = _parse_sample(line)
        fam, suffix = _resolve_family(fams, sample_name)
        le = labels.pop("le", None) if suffix == "_bucket" else None
        key: LabelSet = tuple(sorted(labels.items()))
        fam.samples.append((suffix, key, le, value))
    return fams


def _resolve_family(fams: Dict[str, ParsedFamily],
                    sample_name: str) -> Tuple[ParsedFamily, str]:
    if sample_name in fams:
        return fams[sample_name], ""
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            fam = fams.get(base)
            if fam is not None and fam.kind == "histogram":
                return fam, suffix
    return fams.setdefault(sample_name, ParsedFamily(sample_name)), ""


def _le_sort_key(le: str) -> float:
    return math.inf if le == "+Inf" else float(le)


def _render_labels(key: LabelSet, extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def federate(expositions: Dict[str, str]) -> str:
    """Merge `{replica_label: exposition_text}` into one fleet-wide
    exposition. Counters/histograms aggregate across replicas per
    label set; gauges (and untyped samples) gain a `replica` label
    and stay per-replica."""
    parsed = {rep: parse_exposition(text)
              for rep, text in expositions.items()}
    # family name -> (kind, help), first declaration wins
    meta: Dict[str, Tuple[str, str]] = {}
    for fams in parsed.values():
        for name, fam in fams.items():
            if name not in meta or meta[name][0] == "untyped":
                meta[name] = (fam.kind, fam.help)

    lines: List[str] = []
    for name in sorted(meta):
        kind, help_text = meta[name]
        per_rep = [(rep, parsed[rep].get(name))
                   for rep in sorted(parsed)]
        per_rep = [(rep, fam) for rep, fam in per_rep
                   if fam is not None and fam.samples]
        if not per_rep:
            continue
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        if kind == "counter":
            lines.extend(_merge_sums(name, per_rep))
        elif kind == "histogram":
            lines.extend(_merge_histograms(name, per_rep))
        else:
            lines.extend(_label_by_replica(name, per_rep))
    return "\n".join(lines) + ("\n" if lines else "")


def _merge_sums(name: str,
                per_rep: List[Tuple[str, ParsedFamily]]) -> List[str]:
    totals: Dict[LabelSet, float] = {}
    for _, fam in per_rep:
        for suffix, key, _, value in fam.samples:
            if suffix:
                continue
            totals[key] = totals.get(key, 0.0) + value
    return [f"{name}{_render_labels(key)} {_fmt(totals[key])}"
            for key in sorted(totals)]


def _merge_histograms(name: str,
                      per_rep: List[Tuple[str, ParsedFamily]]
                      ) -> List[str]:
    buckets: Dict[LabelSet, Dict[str, float]] = {}
    sums: Dict[LabelSet, float] = {}
    counts: Dict[LabelSet, float] = {}
    for _, fam in per_rep:
        for suffix, key, le, value in fam.samples:
            if suffix == "_bucket" and le is not None:
                b = buckets.setdefault(key, {})
                b[le] = b.get(le, 0.0) + value
            elif suffix == "_sum":
                sums[key] = sums.get(key, 0.0) + value
            elif suffix == "_count":
                counts[key] = counts.get(key, 0.0) + value
    lines: List[str] = []
    for key in sorted(buckets):
        for le in sorted(buckets[key], key=_le_sort_key):
            lbl = _render_labels(key, extra=f'le="{le}"')
            lines.append(f"{name}_bucket{lbl} {_fmt(buckets[key][le])}")
        lbl = _render_labels(key)
        lines.append(f"{name}_sum{lbl} {_fmt(sums.get(key, 0.0))}")
        lines.append(
            f"{name}_count{lbl} {_fmt(counts.get(key, 0.0))}")
    return lines


def _label_by_replica(name: str,
                      per_rep: List[Tuple[str, ParsedFamily]]
                      ) -> List[str]:
    lines: List[str] = []
    for rep, fam in per_rep:
        for suffix, key, _, value in fam.samples:
            if suffix:
                continue
            merged: LabelSet = tuple(sorted(
                dict(key, replica=rep).items()))
            lines.append(f"{name}{_render_labels(merged)} {_fmt(value)}")
    return lines


def counter_totals(text: str) -> Dict[str, float]:
    """{family: summed value across label sets} for every counter in
    an exposition — the equality check serve_bench's fleet-obs cell
    runs between /metrics/fleet and the per-replica scrapes.
    Declaration-only families (a TYPE/HELP header whose labelled
    children have never incremented render no sample lines) are
    omitted, mirroring federate(), which drops them from the fleet
    body."""
    out: Dict[str, float] = {}
    for name, fam in parse_exposition(text).items():
        if fam.kind != "counter":
            continue
        values = [v for sfx, _, _, v in fam.samples if not sfx]
        if values:
            out[name] = sum(values)
    return out


def histogram_buckets(text: str, family: str) -> Dict[str, float]:
    """Per-`le` cumulative counts for one histogram family, summed
    over label sets — exact-merge comparison helper."""
    fam = parse_exposition(text).get(family)
    if fam is None:
        return {}
    out: Dict[str, float] = {}
    for suffix, _, le, value in fam.samples:
        if suffix == "_bucket" and le is not None:
            out[le] = out.get(le, 0.0) + value
    return out
