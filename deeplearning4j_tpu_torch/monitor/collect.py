"""Fleet trace collection: N ring buffers -> ONE Perfetto document.

Counterpart of deeplearning4j_tpu/monitor/collect.py. The port has no
router yet, so the collectors pull from plain servers: ``router_url`` is
any server answering ``/trace`` (its ``/stats`` names no replicas) and
``extra_urls`` adds the others.

Every process in the serving tier exposes its tracer's ring buffer at
``GET /trace`` (router and replicas alike). Because all tracers anchor
timestamps to the shared wall-clock epoch (``monitor/tracing.py``) and
every span carries the router-minted ``trace_id``, concatenating the
buffers *is* the merge: the router's ``route``/``attempt`` spans and
each replica's ``http_request → enqueue → bucket → device → readback``
chain land on one timeline, grouped per process by the ``process_name``
metadata events each export carries.

The collector discovers replicas from the router's ``/stats`` (the
``replicas`` table is keyed by upstream URL), pulls every ``/trace``,
rebases timestamps to the earliest event (Perfetto prefers small ts),
and writes a single Chrome trace-event JSON.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Iterable, Optional

__all__ = ["fetch_json", "collect_fleet_trace", "collect_requests",
           "merge_docs", "flight_counter_events"]


def fetch_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def merge_docs(docs: Iterable[dict], rebase: bool = True) -> dict:
    """Merge Chrome trace-event documents into one.

    Metadata (``M``) events are kept per pid and deduplicated; timed
    events are pooled, optionally rebased so the earliest timestamp
    becomes 0, and sorted."""
    meta, events, seen_meta = [], [], set()
    for doc in docs:
        for ev in doc.get("traceEvents", ()):
            if ev.get("ph") == "M":
                key = (ev.get("pid"), ev.get("name"),
                       json.dumps(ev.get("args", {}), sort_keys=True))
                if key not in seen_meta:
                    seen_meta.add(key)
                    meta.append(ev)
            elif "ts" in ev:
                events.append(ev)
    if rebase and events:
        t0 = min(ev["ts"] for ev in events)
        events = [{**ev, "ts": ev["ts"] - t0} for ev in events]
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def flight_counter_events(diag: dict, pid: str = "train-telemetry") -> list:
    """Perfetto counter-track events from a flight-recorder diagnostics
    document (``GET /train/diagnostics``).

    One ``ph: "C"`` event per (record, stat column) with per-layer series
    in ``args`` — Perfetto renders each column as one multi-series
    counter track (``train/grad_norm``, ``train/update_ratio``, ...)
    under the given pid, on the SAME wall-clock µs timeline the span
    tracer anchors to (``monitor/tracing.py``), so step telemetry lines
    up with the fit spans in a merged fleet trace."""
    events = [{"ph": "M", "pid": pid, "name": "process_name",
               "args": {"name": pid}}]
    cols = diag.get("cols", ())
    for rec in diag.get("records", ()):
        ts = float(rec["time"]) * 1e6        # wall-clock µs (tracer epoch)
        layers = rec.get("layers", {})
        for col in cols:
            series = {name: stats.get(col, 0.0)
                      for name, stats in layers.items()}
            if series:
                events.append({"ph": "C", "pid": pid, "ts": ts,
                               "name": f"train/{col}", "args": series})
    return events


def collect_fleet_trace(router_url: str,
                        extra_urls: Iterable[str] = (),
                        path: Optional[str] = None,
                        timeout: float = 10.0,
                        rebase: bool = True) -> dict:
    """Pull ``/trace`` from the router and every replica it routes to,
    merge, and (optionally) write to ``path``.

    ``router_url`` may also be a plain replica — anything serving
    ``/trace``; replica discovery just comes up empty. ``extra_urls``
    adds processes the router does not know about (e.g. the online
    learning service). Unreachable members are skipped, not fatal: a
    fleet trace with one replica missing is still a fleet trace."""
    base = router_url.rstrip("/")
    urls = [base]
    try:
        stats = fetch_json(base + "/stats", timeout=timeout)
        urls.extend(u.rstrip("/") for u in
                    sorted(stats.get("replicas", {})))
    except Exception:
        pass
    urls.extend(u.rstrip("/") for u in extra_urls)
    docs, pulled = [], []
    for u in dict.fromkeys(urls):       # dedupe, keep order
        try:
            docs.append(fetch_json(u + "/trace", timeout=timeout))
            pulled.append(u)
        except Exception:
            continue
        try:
            # training telemetry counter tracks (members without a flight
            # recorder answer 404 — skipped like any unreachable surface)
            diag = fetch_json(u + "/train/diagnostics", timeout=timeout)
            docs.append({"traceEvents": flight_counter_events(
                diag, pid=f"train-telemetry {u}")})
        except Exception:
            pass
    doc = merge_docs(docs, rebase=rebase)
    doc["collectedFrom"] = pulled
    if path:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def _base_rid(rid) -> str:
    """Router attempt ids are ``rid#aN``; the base rid joins an attempt's
    replica record back to its router annotation."""
    return rid.split("#", 1)[0] if isinstance(rid, str) else str(rid)


def collect_requests(router_url: str,
                     extra_urls: Iterable[str] = (),
                     n: Optional[int] = None,
                     path: Optional[str] = None,
                     timeout: float = 10.0) -> dict:
    """Pull ``GET /requests`` from the router and every replica it routes
    to, and merge the wide-event journals by request id.

    Same discovery and resilience contract as
    :func:`collect_fleet_trace`: replicas come from the router's
    ``/stats``, ``router_url`` may be a plain replica, unreachable fleet
    members are skipped. The merge joins each router annotation record to
    the replica records of all its attempts (``rid#aN`` → base ``rid``),
    producing one entry per request::

        {"collectedFrom": [...], "requests": [
            {"request_id": rid, "ts": earliest, "router": {...} | None,
             "attempts": [replica records, journal order]}, ...]}
    """
    base = router_url.rstrip("/")
    urls = [base]
    try:
        stats = fetch_json(base + "/stats", timeout=timeout)
        urls.extend(u.rstrip("/") for u in
                    sorted(stats.get("replicas", {})))
    except Exception:
        pass
    urls.extend(u.rstrip("/") for u in extra_urls)
    q = "/requests" if n is None else f"/requests?n={int(n)}"
    merged: dict = {}
    pulled = []
    for u in dict.fromkeys(urls):       # dedupe, keep order
        try:
            doc = fetch_json(u + q, timeout=timeout)
        except Exception:
            continue
        pulled.append(u)
        for rec in doc.get("records", ()):
            rid = _base_rid(rec.get("request_id"))
            entry = merged.setdefault(
                rid, {"request_id": rid, "ts": None,
                      "router": None, "attempts": []})
            ts = rec.get("ts")
            if ts is not None and (entry["ts"] is None
                                   or ts < entry["ts"]):
                entry["ts"] = ts
            if rec.get("source") == "router":
                entry["router"] = rec
            else:
                entry["attempts"].append(rec)
    requests = sorted(merged.values(),
                      key=lambda e: (e["ts"] is None, e["ts"] or 0.0))
    doc = {"collectedFrom": pulled, "requests": requests}
    if path:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
