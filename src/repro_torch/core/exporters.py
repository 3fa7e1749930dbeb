"""Wire-format exporters for telemetry snapshots and trace dumps (the port's
copy of `repro.core.exporters`).

Three formats, all pure functions over the versioned snapshot dicts so
they can run offline over archived JSON as well as live registries:

- :func:`telemetry_to_prometheus` — Prometheus text exposition
  (format 0.0.4) for a ``repro.telemetry/v1`` snapshot.
- :func:`trace_to_perfetto` — Chrome/Perfetto ``trace_event`` JSON for a
  ``repro.trace/v1`` dump; loads directly in https://ui.perfetto.dev
  with one named thread-track per recorder track and instant events for
  faults.
- :func:`trace_to_otlp` — OTLP-JSON (``ExportTraceServiceRequest``
  shape: resourceSpans → scopeSpans → spans) for the same dump, with
  requests mapped to trace IDs and causal parents to ``parentSpanId``.

All output is deterministic: keys sorted, label sets sorted, tracks in
snapshot order (which is itself sorted).
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.core import telemetry as _telemetry
from repro_torch.core import tracing as _tracing

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    out = _NAME_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def _split_label_key(key: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Invert telemetry's ``name{k=v,k2=v2}`` label-key encoding."""
    if "{" not in key:
        return key, []
    name, rest = key.split("{", 1)
    rest = rest.rstrip("}")
    labels = []
    for part in rest.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels.append((k, v))
    return name, labels


def _prom_labels(labels: List[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_prom_escape(v)}"'
                     for k, v in sorted(labels))
    return "{" + inner + "}"


def _fmt_num(v: float) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def telemetry_to_prometheus(snapshot: Dict[str, object]) -> str:
    """Render a ``repro.telemetry/v1`` snapshot as Prometheus text.

    Counters get a ``_total`` suffix; histograms expand to cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count``; span aggregates
    become ``span_count`` / ``span_total_seconds`` / ``span_max_seconds``
    with the span path as a label.  Output is sorted and ends with a
    newline, per the exposition format.
    """
    schema = snapshot.get("schema")
    if schema != _telemetry.SCHEMA:
        raise ValueError(f"expected {_telemetry.SCHEMA} snapshot, got {schema!r}")
    lines: List[str] = []

    # group metric rows by base name so TYPE headers aren't repeated
    families: Dict[str, Tuple[str, List[str]]] = {}

    def add(base: str, mtype: str, row: str) -> None:
        fam = families.setdefault(base, (mtype, []))
        fam[1].append(row)

    for key in sorted(snapshot.get("counters", {})):
        name, labels = _split_label_key(key)
        base = _prom_name(name) + "_total"
        v = snapshot["counters"][key]
        add(base, "counter", f"{base}{_prom_labels(labels)} {_fmt_num(v)}")

    for key in sorted(snapshot.get("gauges", {})):
        name, labels = _split_label_key(key)
        base = _prom_name(name)
        v = snapshot["gauges"][key]
        add(base, "gauge", f"{base}{_prom_labels(labels)} {_fmt_num(v)}")

    for key in sorted(snapshot.get("histograms", {})):
        name, labels = _split_label_key(key)
        base = _prom_name(name)
        h = snapshot["histograms"][key]
        cum = 0
        for edge, n in zip(h["buckets_s"], h["counts"]):
            cum += n
            le = sorted(labels) + [("le", _fmt_num(float(edge)))]
            add(base, "histogram",
                f"{base}_bucket{_prom_labels(le)} {cum}")
        le = sorted(labels) + [("le", "+Inf")]   # includes the overflow bucket
        add(base, "histogram",
            f"{base}_bucket{_prom_labels(le)} {h['count']}")
        add(base, "histogram",
            f"{base}_sum{_prom_labels(labels)} {_fmt_num(float(h['sum_s']))}")
        add(base, "histogram",
            f"{base}_count{_prom_labels(labels)} {h['count']}")

    for key in sorted(snapshot.get("spans", {})):
        s = snapshot["spans"][key]
        labels = [("path", key)]
        add("span_count", "counter",
            f"span_count{_prom_labels(labels)} {s['count']}")
        add("span_total_seconds", "counter",
            f"span_total_seconds{_prom_labels(labels)} "
            f"{_fmt_num(float(s['total_s']))}")
        add("span_max_seconds", "gauge",
            f"span_max_seconds{_prom_labels(labels)} "
            f"{_fmt_num(float(s['max_s']))}")

    add("modeled_clock_seconds", "gauge",
        f"modeled_clock_seconds {_fmt_num(float(snapshot.get('clock_s', 0.0)))}")

    for base in sorted(families):
        mtype, rows = families[base]
        lines.append(f"# TYPE {base} {mtype}")
        lines.extend(rows)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Chrome / Perfetto trace_event JSON
# ---------------------------------------------------------------------------

def _track_order(tracks: Dict[str, object]) -> List[str]:
    """serve first, streamer last, worker/stage tracks in between sorted."""
    names = list(tracks)
    def rank(n: str) -> Tuple[int, str]:
        if n == _tracing.SERVE_TRACK:
            return (0, n)
        if n == _tracing.STREAM_TRACK:
            return (2, n)
        return (1, n)
    return sorted(names, key=rank)


def trace_to_perfetto(trace: Dict[str, object]) -> Dict[str, object]:
    """Convert a ``repro.trace/v1`` dump to Chrome ``trace_event`` JSON.

    One pid, one tid per recorder track (named via ``M``/``thread_name``
    metadata).  Span events ("X") carry ``ts``/``dur`` in microseconds
    (floats, so sub-µs modeled durations survive); instants become
    ``ph: "i"`` with thread scope.  Fault events keep their ``fault.``
    name prefix so they are findable in the Perfetto query bar.
    """
    schema = trace.get("schema")
    if schema != _tracing.SCHEMA:
        raise ValueError(f"expected {_tracing.SCHEMA} dump, got {schema!r}")
    tracks = trace.get("tracks", {})
    order = _track_order(tracks)
    events: List[dict] = []
    pid = 1
    for tid, name in enumerate(order, start=1):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    for tid, tname in enumerate(order, start=1):
        tr = tracks[tname]
        for ev in tr["events"]:
            args = dict(ev.get("args", {}))
            if "rid" in ev:
                args["rid"] = ev["rid"]
            if "seq" in ev:
                args["seq"] = ev["seq"]
            out = {"name": ev["name"], "pid": pid, "tid": tid,
                   "ts": ev["ts"] / 1000.0}
            if args:
                out["args"] = {k: args[k] for k in sorted(args)}
            if ev["ph"] == "X":
                out["ph"] = "X"
                out["dur"] = ev.get("dur", 0) / 1000.0
            else:
                out["ph"] = "i"
                out["s"] = "t"
            events.append(out)
        if tr.get("dropped"):
            events.append({"ph": "i", "s": "t", "name": "trace.dropped",
                           "pid": pid, "tid": tid, "ts": 0.0,
                           "args": {"dropped": tr["dropped"]}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# OTLP-JSON spans
# ---------------------------------------------------------------------------

def _otlp_attr(k: str, v: object) -> dict:
    if isinstance(v, bool):
        val = {"boolValue": v}
    elif isinstance(v, int):
        val = {"intValue": str(v)}
    elif isinstance(v, float):
        val = {"doubleValue": v}
    else:
        val = {"stringValue": str(v)}
    return {"key": k, "value": val}


def _trace_id(rid: Optional[int]) -> str:
    # one trace per request; rid-less events share the run-level trace 0
    return format(0 if rid is None else int(rid) + 1, "032x")


def _span_id(track_idx: int, eid: int) -> str:
    return format(((track_idx + 1) << 40) | (eid + 1), "016x")


def trace_to_otlp(trace: Dict[str, object],
                  service_name: str = "dejavu-repro") -> Dict[str, object]:
    """Convert a ``repro.trace/v1`` dump to an OTLP-JSON
    ``ExportTraceServiceRequest`` document.

    Each request ID becomes its own 128-bit trace ID (rid-less events
    share trace 0); span IDs encode (track, eid) so causal ``parent``
    links resolve to ``parentSpanId`` within the serve track.  Instant
    events export as zero-length spans, which every OTLP backend
    accepts.
    """
    schema = trace.get("schema")
    if schema != _tracing.SCHEMA:
        raise ValueError(f"expected {_tracing.SCHEMA} dump, got {schema!r}")
    tracks = trace.get("tracks", {})
    order = _track_order(tracks)
    # `parent` eids always reference the serve track (spans live there)
    serve_ti = order.index(_tracing.SERVE_TRACK) if _tracing.SERVE_TRACK in order else 0
    spans: List[dict] = []
    for ti, tname in enumerate(order):
        tr = tracks[tname]
        for ev in tr["events"]:
            rid = ev.get("rid")
            start = int(ev["ts"])
            end = start + int(ev.get("dur", 0))
            attrs = [_otlp_attr("track", tname)]
            if "seq" in ev:
                attrs.append(_otlp_attr("seq", ev["seq"]))
            for k in sorted(ev.get("args", {})):
                attrs.append(_otlp_attr(k, ev["args"][k]))
            span = {
                "traceId": _trace_id(rid),
                "spanId": _span_id(ti, ev["eid"]),
                "name": ev["name"],
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(start),
                "endTimeUnixNano": str(end),
                "attributes": attrs,
            }
            if ev.get("parent") is not None:
                span["parentSpanId"] = _span_id(serve_ti, ev["parent"])
            spans.append(span)
    return {
        "resourceSpans": [{
            "resource": {"attributes": [
                _otlp_attr("service.name", service_name),
            ]},
            "scopeSpans": [{
                "scope": {"name": "repro.tracing", "version": "1"},
                "spans": spans,
            }],
        }],
    }


def dumps(doc: Dict[str, object]) -> str:
    """Canonical JSON serialisation shared by exporter CLI/test paths."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))
