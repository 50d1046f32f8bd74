"""Human-readable rendering of a metrics snapshot (`obs-report`).

Turns one ``Registry.snapshot()`` dict — possibly the merge of many
worker shards — into the terminal report printed by
``benchmarks/run.py obs-report``: engine memo hit rates, DSE/journal
activity, fleet health, and service latency percentiles. Pure
formatting; all numbers come from the snapshot.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .metrics import quantile


def _rate(hit: float, miss: float) -> str:
    tot = hit + miss
    if tot <= 0:
        return "n/a"
    return f"{hit / tot:.1%} ({int(hit)}/{int(tot)})"


def _hist_line(snap: Dict, name: str) -> Optional[str]:
    h = (snap.get("histograms") or {}).get(name)
    if not h or not h.get("count"):
        return None
    p50 = quantile(h["bounds"], h["counts"], 0.50)
    p99 = quantile(h["bounds"], h["counts"], 0.99)
    mean = h["sum"] / h["count"]
    return (f"n={h['count']} mean={mean * 1e3:.3f}ms "
            f"p50={p50 * 1e3:.3f}ms p99={p99 * 1e3:.3f}ms")


def render_report(snap: Dict) -> str:
    """Render one snapshot as the multi-section text report.

    Sections appear only when their metrics are present, so the same
    renderer serves a bench run (engine only), a dse sweep, a
    distributed fleet merge, and a serving session."""
    c = snap.get("counters") or {}
    g = snap.get("gauges") or {}
    lines: List[str] = []

    def sec(title: str) -> None:
        if lines:
            lines.append("")
        lines.append(title)

    eng = {k: v for k, v in c.items() if k.startswith("engine.")}
    if eng:
        sec("engine")
        for memo in ("tiles", "tail", "proj", "ready", "sepcls", "score",
                     "perf"):
            hit = eng.get(f"engine.{memo}_hit", 0)
            miss = eng.get(f"engine.{memo}_miss", 0)
            if hit or miss:
                lines.append(f"  {memo:<7} hit rate  {_rate(hit, miss)}")
        pool = eng.get("engine.score_pool_hit", 0)
        if pool:
            lines.append(f"  pool-memo hits     {int(pool)}")
        batched = eng.get("engine.batch_scored", 0)
        dense = eng.get("engine.dense_scored", 0)
        guard = eng.get("engine.guard_fallback", 0)
        if batched or dense:
            lines.append(f"  batched scored     {int(batched)}")
            lines.append(f"  dense fallback     {int(dense)} "
                         f"(grid-guard: {int(guard)})")
        ev = eng.get("engine.evictions", 0)
        if ev:
            lines.append(f"  arch evictions     {int(ev)}")
        if "engine.arch_bundles" in g:
            lines.append(f"  live arch bundles  "
                         f"{int(g['engine.arch_bundles'])}")

    if any(k.startswith("dse.") for k in c):
        sec("dse")
        lines.append(f"  proposed           {int(c.get('dse.proposed', 0))}")
        lines.append(f"  evaluated          {int(c.get('dse.evaluated', 0))}")
        lines.append(f"  journal hits       "
                     f"{int(c.get('dse.journal_hits', 0))}")
        h = _hist_line(snap, "dse.eval_seconds")
        if h:
            lines.append(f"  eval latency       {h}")

    if any(k.startswith("journal.") for k in c):
        sec("journal")
        lines.append(f"  records            "
                     f"{int(c.get('journal.records', 0))}")
        lines.append(f"  refresh new rows   "
                     f"{int(c.get('journal.refresh_new', 0))}")
        for nm in ("journal.refresh_seconds", "journal.publish_seconds"):
            h = _hist_line(snap, nm)
            if h:
                lines.append(f"  {nm.split('.')[1]:<18} {h}")

    if any(k.startswith("fleet.") for k in c):
        sec("fleet")
        for key, label in (("fleet.batches", "batches"),
                           ("fleet.evaluated", "evaluated"),
                           ("fleet.claims", "lease claims"),
                           ("fleet.stolen", "lease steals"),
                           ("fleet.expired", "lease expiries"),
                           ("fleet.skipped_done", "skipped done")):
            if key in c:
                lines.append(f"  {label:<18} {int(c[key])}")
        if "fleet.workers" in g:
            lines.append(f"  workers reported   {int(g['fleet.workers'])}")
        h = _hist_line(snap, "fleet.batch_eval_seconds")
        if h:
            lines.append(f"  batch eval         {h}")

    if any(k.startswith("serve.") for k in c):
        sec("serve")
        lines.append(f"  requests           "
                     f"{int(c.get('serve.requests', 0))}")
        for src in ("memo", "journal", "search", "coalesced"):
            k = f"serve.served_from.{src}"
            if k in c:
                lines.append(f"  served from {src:<7}{int(c[k])}")
        lines.append(f"  coalesced          "
                     f"{int(c.get('serve.coalesced', 0))}")
        shed = int(c.get("serve.shed", 0))
        if shed:
            lines.append(f"  shed (429)         {shed}")
        lines.append(f"  sweeps run         "
                     f"{int(c.get('serve.sweeps', 0))}")
        compactions = int(c.get("serve.compactions", 0))
        if compactions:
            lines.append(f"  compactions        {compactions}")
        h = _hist_line(snap, "serve.request_seconds")
        if h:
            lines.append(f"  request latency    {h}")
        wp50 = g.get("serve.request_seconds.window.p50")
        wp99 = g.get("serve.request_seconds.window.p99")
        if wp50 is not None or wp99 is not None:
            n = int(g.get("serve.request_seconds.window.count", 0))
            lines.append(f"  recent latency     n={n} "
                         f"p50={(wp50 or 0) * 1e3:.3f}ms "
                         f"p99={(wp99 or 0) * 1e3:.3f}ms "
                         f"(sliding window)")
        slo_ok = c.get("serve.slo.ok")
        slo_breach = c.get("serve.slo.breach")
        if slo_ok is not None or slo_breach is not None:
            burn = g.get("serve.slo.burn_rate", 0.0)
            lines.append(f"  slo                ok={int(slo_ok or 0)} "
                         f"breach={int(slo_breach or 0)} "
                         f"burn_rate={burn:.2f}")
        if "serve.queue.depth" in g:
            lines.append(f"  queue depth (last) "
                         f"{int(g['serve.queue.depth'])}")

    flight = snap.get("flight") or []
    if flight:
        sec("flight recorder (most recent first)")
        lines.append(f"  {'key':<14} {'from':<9} {'outcome':<7} "
                     f"{'admit_ms':>9} {'eval_ms':>9} {'resp_ms':>9} "
                     f"{'total_ms':>9} {'eval':>5}")
        for rec in flight[:10]:
            lines.append(
                f"  {str(rec.get('key', ''))[:12]:<14} "
                f"{str(rec.get('served_from', ''))[:8]:<9} "
                f"{str(rec.get('outcome', ''))[:7]:<7} "
                f"{rec.get('admit_wait_s', 0) * 1e3:>9.2f} "
                f"{rec.get('evaluate_s', 0) * 1e3:>9.2f} "
                f"{rec.get('respond_s', 0) * 1e3:>9.2f} "
                f"{rec.get('total_s', 0) * 1e3:>9.2f} "
                f"{int(rec.get('evaluated', 0)):>5}"
                + (" SLOW" if rec.get("slow") else ""))
        n_slow = sum(1 for r in flight if r.get("slow"))
        if n_slow:
            lines.append(f"  ({n_slow} slow request(s) retained with "
                         "full detail — GET /v1/debug/requests/<key>)")

    if not lines:
        return "(no metrics recorded)\n"
    return "\n".join(lines) + "\n"
