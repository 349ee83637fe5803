"""The program's own spans and counters (snap_rnaseq_tpu_torch/utils/
stats.py's recorder) for the metric readers: the stretch it recorded
while the traced steps' profiler ran, and its totals over the process.
Where the program has no recorder each function returns None, and the
readers that need it find nothing to read."""
from __future__ import annotations


def _stats():
    from snap_rnaseq_tpu_torch.utils import stats
    return stats


def recorded():
    """{"spans": [...], "counts": {...}} of the traced steps, or None."""
    fn = getattr(_stats(), "recorded", None)
    return fn() if fn else None


def counts() -> dict:
    rec = recorded()
    return rec["counts"] if rec else {}


def total_s(name: str):
    """Host seconds the process spent in span `name` (set-up spans),
    or None where it never ran."""
    fn = getattr(_stats(), "totals", None)
    got = fn()["spans"].get(name) if fn else None
    return got[1] if got else None


def batch_host_s(prefix: str):
    """Host s in the outermost spans named `prefix`*, less the sync.*
    spans of the same batches; None where there are none."""
    rec = recorded()
    if not rec:
        return None
    spans = rec["spans"]
    batches = [s for s in spans
               if s["parent"] is None and s["name"].startswith(prefix)]
    if not batches:
        return None
    keys = {(s["seq"], s["thread"]) for s in batches}
    ns = sum(s["end_ns"] - s["start_ns"] for s in batches)
    ns -= sum(s["end_ns"] - s["start_ns"] for s in spans
              if s["name"].startswith("sync.")
              and (s["seq"], s["thread"]) in keys)
    return ns / 1e9


def sync_s() -> float | None:
    """Host seconds in every sync.* span of the traced steps."""
    rec = recorded()
    if not rec:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in rec["spans"]
               if s["name"].startswith("sync.")) / 1e9


def host_us_per_op(ctx: dict, prefix: str):
    """Host us in the batch spans `prefix`*, less their syncs, over the
    device operations of the traced steps."""
    n_ops = (ctx.get("trace") or {}).get("n_ops")
    host_s = batch_host_s(prefix)
    if not n_ops or host_s is None:
        return None
    return host_s * 1e6 / n_ops
