#!/usr/bin/env python
"""torch_alert_check — evaluate an alert rule pack against a journal or a
live exporter (the port's counterpart of tools/alert_check.py).

Three modes over one rule file (docs/observability.md §10):

- **replay**: ``--journal run.jsonl`` rebuilds the fleet's gauge/counter
  history from the journal's event stream (``shard_down`` /
  ``shard_respawn`` flip ``serve_shard_up``, ``serve_poisoned`` bumps
  the poison counter, ``journey`` records bump request counters), drives
  a `SeriesStore` + `AlertManager` along the recorded timestamps, and
  prints every firing/resolved transition the rules would have
  produced. If the journal already holds live ``alert`` events (a run
  with ``timeseries=True``), the replay is cross-checked against them.
- **live**: ``--url http://HOST:PORT`` reads the exporter's ``/alerts``
  report and, per rule, the ``/query`` window for its series, and
  prints the current status of each rule.
- **self-check**: ``--self-check`` runs synthetic fake-clock scenarios
  (threshold + hysteresis, ``for_`` hold, absence, rate, and a
  journal-replay round trip) — the CI gate.

Rule files are JSON: ``{"rules": [{...}, ...]}`` or a bare list, each
entry in `AlertRule.to_dict()` form (``"for"`` spells the hold). With
no ``--rules``, the default fleet pack is used.

Exit code is 0 unless a check fails, ``--fail-on-firing`` is set and
an alert is still firing at the end (replay) / right now (live), or a
``--expect-fire RULE`` never fired during the replay.

Unlike the stdlib-only renderers (fleet_top, journal_diff), this tool
imports `dispatches_tpu_torch.obs` — the rules must evaluate with the
exact store/manager semantics the port's fleet runs, not a
reimplementation. It reads the port's journals and exporters (and the
JAX package's: the records are the same) and touches no device.

Usage:
    python tools/torch_alert_check.py --journal run.jsonl
    python tools/torch_alert_check.py --journal run.jsonl --rules rules.json --fail-on-firing
    python tools/torch_alert_check.py --url http://127.0.0.1:9100 --fail-on-firing
    python tools/torch_alert_check.py --self-check
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from dispatches_tpu_torch.obs.alerts import (  # noqa: E402
    AlertManager,
    AlertRule,
    default_fleet_rules,
    rule_from_dict,
)
from dispatches_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from dispatches_tpu_torch.obs.timeseries import SeriesStore  # noqa: E402


# ---------------------------------------------------------------------------
# rule files


def load_rules(path: Optional[str]) -> List[AlertRule]:
    if path is None:
        return default_fleet_rules()
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    entries = doc.get("rules") if isinstance(doc, dict) else doc
    if not isinstance(entries, list):
        raise ValueError(f"{path}: expected a list or {{'rules': [...]}}")
    return [rule_from_dict(e) for e in entries]


# ---------------------------------------------------------------------------
# journal replay


def _read_journal(path: str) -> List[Dict[str, Any]]:
    records = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue  # torn tail line of a crashed run
    return records


class _ReplayClock:
    """Mutable clock the replay advances record by record."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def replay(
    records: Sequence[Dict[str, Any]],
    rules: Sequence[AlertRule],
) -> Dict[str, Any]:
    """Drive the rule pack along a journal's event stream. Returns the
    transitions produced, the rules that fired, what is still firing at
    the end, and the journal's own live alert events for cross-check."""
    clk = _ReplayClock()
    reg = MetricsRegistry()
    store = SeriesStore(reg, clock=clk)
    mgr = AlertManager(store, rules, clock=clk, journal=False)

    events = [
        r for r in records
        if r.get("kind") in ("event", "journey") and r.get("ts") is not None
    ]
    events.sort(key=lambda r: float(r["ts"]))
    live_alerts = [r for r in events if r.get("name") == "alert"]

    # every shard the journal mentions starts up — the journal only
    # records transitions, not the initial spawn — and counters that the
    # rate rules watch start at 0 so their first increase has a baseline
    for r in events:
        if str(r.get("name", "")).startswith("shard_") and "shard" in r:
            reg.set_gauge("serve_shard_up", 1.0, shard=str(r["shard"]))
    for rule in rules:
        if rule.kind == "rate":
            reg.inc(rule.series, 0, **dict(rule.labels or {}))

    transitions: List[Dict[str, Any]] = []
    if not events:
        return {"transitions": [], "fired": {}, "firing": [],
                "live_alerts": live_alerts, "events": 0}
    t0 = float(events[0]["ts"])
    for r in events:
        clk.t = float(r["ts"]) - t0
        name = r.get("name")
        if r.get("kind") == "journey":
            reg.inc("serve_requests_total")
        elif name == "shard_down":
            reg.set_gauge("serve_shard_up", 0.0, shard=str(r.get("shard")))
        elif name == "shard_respawn":
            reg.set_gauge("serve_shard_up", 1.0, shard=str(r.get("shard")))
        elif name == "serve_poisoned":
            reg.inc("poisoned_requests_total")
        store.sample(clk.t)
        transitions.extend(mgr.evaluate(clk.t))
    # one settling pass past the last record so resolutions land
    clk.t += store.tiers[0][0]
    store.sample(clk.t)
    transitions.extend(mgr.evaluate(clk.t))

    fired: Dict[str, int] = {}
    for tr in transitions:
        if tr["phase"] == "firing":
            fired[tr["rule"]] = fired.get(tr["rule"], 0) + 1
    return {
        "transitions": transitions,
        "fired": fired,
        "firing": mgr.firing(),
        "live_alerts": live_alerts,
        "events": len(events),
    }


def run_replay(args: argparse.Namespace, rules: List[AlertRule]) -> int:
    result = replay(_read_journal(args.journal), rules)
    print(
        f"torch_alert_check: replayed {result['events']} journal event(s) "
        f"against {len(rules)} rule(s)"
    )
    for tr in result["transitions"]:
        extra = (
            f" after {tr['duration_s']:.2f}s" if tr["phase"] == "resolved"
            else ""
        )
        print(
            f"  t={tr['t']:8.2f}  {tr['phase']:>8}  {tr['rule']}"
            f"  {tr['series']}  value={tr['value']:.3g}{extra}"
        )
    if not result["transitions"]:
        print("  (no transitions)")
    if result["live_alerts"]:
        live_fired = sum(
            1 for r in result["live_alerts"] if r.get("phase") == "firing"
        )
        replay_fired = sum(result["fired"].values())
        tag = "matches" if live_fired == replay_fired else "DIFFERS FROM"
        print(
            f"  cross-check: journal recorded {live_fired} live firing "
            f"event(s); replay produced {replay_fired} ({tag} live run)"
        )
    rc = 0
    for rule in args.expect_fire or []:
        if rule not in result["fired"]:
            print(f"torch_alert_check: FAIL — expected rule {rule!r} to fire")
            rc = 1
    if args.fail_on_firing and result["firing"]:
        names = sorted({f["rule"] for f in result["firing"]})
        print(f"torch_alert_check: FAIL — still firing at end: {names}")
        rc = 1
    if rc == 0:
        print("torch_alert_check: OK")
    return rc


# ---------------------------------------------------------------------------
# live endpoint


def _get_json(url: str, timeout: float = 3.0) -> Optional[Dict[str, Any]]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read().decode("utf-8"))
        except Exception:
            return None
    except (OSError, ValueError):
        return None


def run_live(args: argparse.Namespace, rules: List[AlertRule]) -> int:
    base = args.url.rstrip("/")
    report = _get_json(base + "/alerts")
    if report is None or not isinstance(report.get("firing"), list):
        print(
            f"torch_alert_check: no /alerts report at {base} "
            "(exporter without an AlertManager attached?)",
            file=sys.stderr,
        )
        report = None
    firing_rules = (
        sorted({f["rule"] for f in report["firing"]}) if report else []
    )
    print(f"torch_alert_check: {base}  rules={len(rules)}")
    for rule in rules:
        q = _get_json(
            base + f"/query?name={urllib.parse.quote(rule.series)}"
            f"&window={rule.window}"
        )
        series = (q or {}).get("series") or []
        points = sum(len(s.get("t") or []) for s in series)
        status = "FIRING" if rule.name in firing_rules else (
            "ok" if points else "no data"
        )
        print(
            f"  {rule.name:>20}  {status:>8}  series={len(series)}"
            f"  points={points}  ({rule.kind} {rule.series}"
            f" {rule.op} {rule.bound:g})"
        )
    if report:
        print(
            f"  server: {len(report['firing'])} firing, "
            f"{len(report.get('history') or [])} recent transition(s), "
            f"{report.get('evals', 0)} eval(s)"
        )
    if args.fail_on_firing and firing_rules:
        print(f"torch_alert_check: FAIL — firing now: {firing_rules}")
        return 1
    print("torch_alert_check: OK")
    return 0


# ---------------------------------------------------------------------------
# self-check


def self_check() -> int:
    failures: List[str] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        print(
            f"  {'PASS' if ok else 'FAIL'}  {name}"
            + (f"  ({detail})" if detail and not ok else "")
        )
        if not ok:
            failures.append(name)

    def fresh(rules: Sequence[AlertRule]) -> Tuple[
        _ReplayClock, MetricsRegistry, SeriesStore, AlertManager
    ]:
        clk = _ReplayClock()
        reg = MetricsRegistry()
        store = SeriesStore(reg, clock=clk)
        return clk, reg, store, AlertManager(
            store, rules, clock=clk, journal=False
        )

    # threshold fire + hysteresis: clears only below clear_bound
    rule = AlertRule(
        name="hot", series="g", op=">", bound=10.0, clear_bound=5.0,
        window=30.0,
    )
    clk, reg, store, mgr = fresh([rule])
    reg.set_gauge("g", 12.0)
    clk.t = 1.0
    store.sample()
    trs = mgr.evaluate()
    check(
        "threshold fires above bound",
        [t["phase"] for t in trs] == ["firing"],
        str(trs),
    )
    reg.set_gauge("g", 8.0)  # below bound, above clear_bound
    clk.t = 2.0
    store.sample()
    trs = mgr.evaluate()
    check("hysteresis holds between bounds", trs == [] and mgr.firing())
    reg.set_gauge("g", 4.0)
    clk.t = 3.0
    store.sample()
    trs = mgr.evaluate()
    check(
        "clears below clear_bound",
        [t["phase"] for t in trs] == ["resolved"] and not mgr.firing(),
        str(trs),
    )

    # for_ hold: no firing until the condition held long enough
    rule = AlertRule(
        name="slow", series="g", op=">", bound=1.0, for_=5.0, window=30.0,
    )
    clk, reg, store, mgr = fresh([rule])
    reg.set_gauge("g", 2.0)
    for t in (1.0, 3.0):
        clk.t = t
        store.sample()
        early = mgr.evaluate()
    check("for_ holds early breaches", early == [])
    clk.t = 7.0
    store.sample()
    trs = mgr.evaluate()
    check(
        "for_ fires once held",
        [t["phase"] for t in trs] == ["firing"],
        str(trs),
    )

    # absence: a once-seen series going silent fires; never-seen is quiet
    rule = AlertRule(name="gone", series="hb", kind="absence", window=10.0)
    clk, reg, store, mgr = fresh([rule])
    clk.t = 1.0
    check("absence silent when never seen", mgr.evaluate() == [])
    reg.set_gauge("hb", 1.0)
    store.sample()
    clk.t = 20.0
    trs = mgr.evaluate()
    check(
        "absence fires after silence",
        [t["phase"] for t in trs] == ["firing"],
        str(trs),
    )

    # rate: a flat counter is quiet; an increasing one fires
    rule = AlertRule(
        name="poison", series="c", kind="rate", bound=0.0, window=60.0,
    )
    clk, reg, store, mgr = fresh([rule])
    reg.inc("c", 0)
    for t in (1.0, 2.0):
        clk.t = t
        store.sample()
        flat = mgr.evaluate()
    check("rate quiet on flat counter", flat == [])
    reg.inc("c", 3)
    clk.t = 3.0
    store.sample()
    trs = mgr.evaluate()
    check(
        "rate fires on increase",
        [t["phase"] for t in trs] == ["firing"],
        str(trs),
    )

    # journal replay round trip: shard_down fires, shard_respawn resolves
    records = [
        {"kind": "event", "ts": 100.0, "name": "shard_spawn", "shard": "0"},
        {"kind": "event", "ts": 100.0, "name": "shard_spawn", "shard": "1"},
        {"kind": "journey", "ts": 101.0, "request_id": "r1"},
        {"kind": "event", "ts": 105.0, "name": "shard_down", "shard": "1",
         "reason": "sigkill"},
        {"kind": "event", "ts": 106.5, "name": "shard_respawn", "shard": "1"},
        {"kind": "event", "ts": 107.0, "name": "serve_poisoned",
         "request_id": "r9"},
    ]
    result = replay(records, default_fleet_rules())
    phases = [
        (t["rule"], t["phase"]) for t in result["transitions"]
        if t["rule"] == "shard_down"
    ]
    check(
        "replay: shard_down fires then resolves",
        phases == [("shard_down", "firing"), ("shard_down", "resolved")],
        str(phases),
    )
    check(
        "replay: poison_rate fires",
        "poison_rate" in result["fired"],
        str(result["fired"]),
    )
    # a rate alert stays firing until the increase leaves its window, so
    # only shard_down must be clean at end-of-replay
    end_rules = {f["rule"] for f in result["firing"]}
    check("replay: shard_down resolved at end",
          "shard_down" not in end_rules, str(end_rules))

    # rule file round trip
    pack = default_fleet_rules()
    doc = json.dumps({"rules": [r.to_dict() for r in pack]})
    back = [rule_from_dict(e) for e in json.loads(doc)["rules"]]
    check("rule file round-trips", back == pack)
    try:
        rule_from_dict({"name": "x", "series": "s", "flavor": "wrong"})
        check("rule_from_dict rejects unknown fields", False)
    except ValueError:
        check("rule_from_dict rejects unknown fields", True)

    print(
        f"torch_alert_check self-check: {'OK' if not failures else 'FAILED'} "
        f"({len(failures)} failure(s))"
    )
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_alert_check.py",
        description="evaluate alert rules against a journal or live exporter",
    )
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--journal", help="journal JSONL to replay")
    src.add_argument("--url", help="exporter base URL (live mode)")
    ap.add_argument("--rules", help="JSON rule file (default: fleet pack)")
    ap.add_argument("--expect-fire", action="append", metavar="RULE",
                    help="fail unless RULE fired during the replay")
    ap.add_argument("--fail-on-firing", action="store_true",
                    help="fail if any alert is (still) firing")
    ap.add_argument("--self-check", action="store_true",
                    help="run the built-in synthetic validation")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check()
    rules = load_rules(args.rules)
    if args.journal:
        return run_replay(args, rules)
    if args.url:
        return run_live(args, rules)
    ap.error("one of --journal / --url / --self-check is required")
    return 2


if __name__ == "__main__":
    sys.exit(main())
