"""The port's spans and counters (utils/stats.py's recorder) on the CPU.

* a paired and a single-end batch give the same outputs, to the bit,
  with and without an active profiler;
* without a profiler the recorder keeps totals and no records;
* under a CPU torch.profiler a span contains the kineto start and end of
  an aten:: operation issued inside it, within 50 us (one clock), and no
  kineto event carries a span's name (no annotation of its own);
* engine.truncated counts the engine's own `truncated` outputs, on the
  device, and keeps none of them;
* the default engines (cuckoo lookup, overflow_tier off) read the
  device only in the rowwise LV's boolean-mask indexes (six syncs);
  overflow_tier adds one a batch, the probe-chain lookup one for its
  stragglers and one a probe window; copies to the device count as syncs
  only where they are one (on a card);
* each phase span's parent is its batch span, in the batch's sequence;
* WaitProfile reads the pipeline.* spans; the totals hold under threads;
* the benchmark's readers of the recorder (benchmark/metrics/) on a
  synthetic recorder and context, and None on an empty one or without a
  recorder."""
import sys
import threading
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run as bench_run
from snap_rnaseq_tpu_torch.index.genome import genome_from_codes
from snap_rnaseq_tpu_torch.index.hash_index import build_index
from snap_rnaseq_tpu_torch.models.paired import PairedAligner
from snap_rnaseq_tpu_torch.models.single import SingleAligner
from snap_rnaseq_tpu_torch.tools import measure
from snap_rnaseq_tpu_torch.utils import stats
from snap_rnaseq_tpu_torch.utils.synth_genome import wgsim_pairs

B = 16
CAND = 8          # few slots: the repeat genome's reads truncate
PAIRED_PHASES = ("quals", "seed", "budget", "expand", "back_half",
                 "dense_topk", "mate_rescue", "pair_join", "outputs")
SINGLE_PHASES = ("seed", "budget", "expand", "aggregate_rows",
                 "rowwise_score", "rowwise_replay")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def repeat_codes():
    """A unit repeated with mutations, then random sequence: seeds with
    many hits, so that CAND slots truncate."""
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 4, 2000, dtype=np.uint8)
    parts = []
    for i in range(30):
        u = unit.copy()
        for _ in range(i):
            p = rng.integers(0, u.size)
            u[p] = (u[p] + 1) % 4
        parts.append(u)
    parts.append(rng.integers(0, 4, 30000, dtype=np.uint8))
    return np.concatenate(parts)


def batch_of(index):
    body = measure.genome_body(index, index.genome.num_bases - 1000)
    r0, q0, r1, q1, _, _ = wgsim_pairs(body, B, 100, seed=1)
    return tuple(torch.from_numpy(x) for x in (r0, q0, r1, q1))


def profiled(fn):
    """fn() under a CPU torch.profiler: (its result, the kineto events,
    the recorder's stretch)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events(), stats.recorded()


@pytest.fixture(scope="module")
def world():
    codes = repeat_codes()
    index = build_index(genome_from_codes(codes), seed_len=20)
    batch = batch_of(index)
    aligners = dict(
        paired=(PairedAligner(index, device="cpu", cand_per_read=CAND),
                batch),
        single=(SingleAligner(index, device="cpu", cand_per_read=CAND),
                batch[:2]))
    runs = {}
    for name, (al, args) in aligners.items():
        plain = al.align_batch_device(*args)
        got, events, rec = profiled(lambda: al.align_batch_device(*args))
        runs[name] = dict(plain=plain, got=got, events=events, rec=rec)
    return dict(index=index, codes=codes, batch=batch, aligners=aligners,
                runs=runs)


@pytest.mark.parametrize("engine", ["paired", "single"])
def test_same_outputs_under_a_profiler(world, engine):
    r = world["runs"][engine]
    assert set(r["got"]) == set(r["plain"])
    for k, v in r["plain"].items():
        torch.testing.assert_close(r["got"][k], v, rtol=0, atol=0,
                                   equal_nan=True, msg=k)


def test_totals_without_records(world):
    al, args = world["aligners"]["paired"]
    rec = stats.recorded()
    before = stats.totals()
    al.align_batch_device(*args)
    after = stats.totals()
    for name in ("engine.paired",) + PAIRED_PHASES:
        calls = 2 if name == "mate_rescue" else 1
        assert (after["spans"][name][0]
                == before["spans"].get(name, (0, 0))[0] + calls), name
        assert after["spans"][name][1] > before["spans"].get(name,
                                                             (0, 0))[1]
    assert after["counts"]["engine.reads"] == \
        before["counts"]["engine.reads"] + 2 * B
    assert stats.recorded() == rec


def test_spans_share_the_profilers_clock():
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stats.span("clock_probe"):
            a @ a
    s, = [s for s in stats.recorded()["spans"] if s["name"] == "clock_probe"]
    e, = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert s["start_ns"] - 50_000 <= e.start_ns() <= e.end_ns() \
        <= s["end_ns"] + 50_000
    assert s["parent"] is None and s["thread"] == "MainThread"


@pytest.mark.parametrize("engine", ["paired", "single"])
def test_no_event_carries_a_span_name(world, engine):
    r = world["runs"][engine]
    names = {s["name"] for s in r["rec"]["spans"]}
    assert f"engine.{engine}" in names
    assert not names & {e.name() for e in r["events"]}
    assert not any(e.is_user_annotation() for e in r["events"])


@pytest.mark.parametrize("engine", ["paired", "single"])
def test_truncated_counts_the_engines_outputs(world, engine):
    r = world["runs"][engine]
    keys = ("truncated0", "truncated1") if engine == "paired" \
        else ("truncated",)
    want = sum(int(np.count_nonzero(r["got"][k].numpy())) for k in keys)
    c = r["rec"]["counts"]
    assert want > 0
    assert c["engine.truncated"] == want
    assert c["engine.reads"] == len(keys) * B
    assert c["engine.batches"] == 1


def test_device_counts_hold_no_engine_tensor():
    """count_device adds on the device into a counter of its own: the
    tensors it is given are not kept (their memory goes back to the
    allocator), and nothing is counted without a profiler."""
    rec = stats.Recorder()
    t = torch.tensor([0, 3, 0, 5], dtype=torch.int32)
    ref = weakref.ref(t)
    rec.count_device("c", t)
    with profile(activities=[ProfilerActivity.CPU]):
        rec.count_device("c", t)
        rec.count_device("c", torch.tensor([1, 1, 0]))
        rec.count_device("s", torch.tensor([2, 0], dtype=torch.int32))
    del t
    assert ref() is None
    assert rec.recorded()["counts"] == {"c": 4, "s": 1}
    assert rec.recorded()["counts"] == {"c": 4, "s": 1}


LV_MASK = {"sync.lv_mask": 1}      # one span, six boolean-mask reads
LV_SYNCS = 6


def sync_spans(rec) -> dict:
    out = {}
    for s in rec["spans"]:
        if s["name"].startswith("sync."):
            out[s["name"]] = out.get(s["name"], 0) + 1
    return out


@pytest.mark.parametrize("engine", ["paired", "single"])
def test_default_syncs_are_the_lv_masks(world, engine):
    rec = world["runs"][engine]["rec"]
    assert sync_spans(rec) == LV_MASK
    assert rec["counts"]["engine.syncs"] == LV_SYNCS
    assert {s["parent"] for s in rec["spans"]
            if s["name"].startswith("sync.")} == {"rowwise_score"}


def test_copies_count_as_syncs_on_a_card_only():
    before = stats.totals()
    t = stats.to_device("probe_copy", torch.arange(4), "cpu")
    assert torch.equal(t, torch.arange(4))
    after = stats.totals()
    assert after["counts"].get("engine.syncs", 0) == \
        before["counts"].get("engine.syncs", 0)
    assert "sync.probe_copy" not in after["spans"]


@pytest.mark.parametrize("engine", ["paired", "single"])
def test_overflow_tier_makes_one_sync(world, engine):
    index, batch = world["index"], world["batch"]
    cls, args = ((PairedAligner, batch) if engine == "paired"
                 else (SingleAligner, batch[:2]))
    al = cls(index, device="cpu", cand_per_read=CAND, overflow_tier=True)
    _out, _events, rec = profiled(lambda: al.align_batch_device(*args))
    # the narrow tier truncated, so the wide back half ran instead
    assert sync_spans(rec) == {**LV_MASK, "sync.overflow_tier": 1}
    assert rec["counts"]["engine.syncs"] == 1 + LV_SYNCS
    s, = [s for s in rec["spans"] if s["name"] == "sync.overflow_tier"]
    assert s["parent"] == f"engine.{engine}"


def test_probe_lookup_counts_its_windows(world, monkeypatch):
    monkeypatch.setenv("SNAP_TPU_LOOKUP", "probe")
    dense = build_index(genome_from_codes(world["codes"]), seed_len=20,
                        load_factor=0.98)
    al = PairedAligner(dense, device="cpu", cand_per_read=CAND)
    before = stats.totals()
    al.align_batch_device(*batch_of(dense))
    after = stats.totals()
    grew = lambda k: after["counts"].get(k, 0) - before["counts"].get(k, 0)
    windows = grew("lookup.probe_windows")
    assert windows >= 1
    assert grew("engine.syncs") == 1 + windows + LV_SYNCS
    calls = lambda t, k: t["spans"].get(k, (0, 0))[0]
    assert calls(after, "sync.probe_pending") - \
        calls(before, "sync.probe_pending") == 1
    assert calls(after, "sync.probe_window") - \
        calls(before, "sync.probe_window") == windows


@pytest.mark.parametrize("engine", ["paired", "single"])
def test_phases_are_children_of_their_batch(world, engine):
    spans = world["runs"][engine]["rec"]["spans"]
    batch, = [s for s in spans if s["name"] == f"engine.{engine}"]
    assert batch["parent"] is None and batch["seq"] > 0
    phases = PAIRED_PHASES if engine == "paired" else SINGLE_PHASES
    for name in phases:
        got = [s for s in spans if s["name"] == name]
        assert len(got) == (2 if name == "mate_rescue" else 1), name
        for s in got:
            assert s["parent"] == batch["name"], name
            assert s["seq"] == batch["seq"], name
            assert batch["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= batch["end_ns"], name


def test_wait_profile_reads_the_pipeline_spans():
    w = stats.WaitProfile()
    assert (w.read_s, w.device_s, w.write_s) == (0.0, 0.0, 0.0)
    with stats.span("pipeline.device"):
        torch.ones(8).sum()
    assert w.device_s > 0 and w.read_s == 0.0 and w.write_s == 0.0
    assert w.summary().startswith("wait profile: read 0.00s, device ")


def test_totals_hold_under_threads():
    """More threads than cores, a short switch interval: no span, count
    or record is lost."""
    rec = stats.Recorder()
    n_threads, n = 16, 300

    def work():
        for _ in range(n):
            with rec.span("t.outer", batch=True):
                with rec.span("t.inner"):
                    rec.count("t.count")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    tot = rec.totals()
    assert tot["spans"]["t.outer"][0] == tot["spans"]["t.inner"][0] \
        == n_threads * n
    assert tot["counts"]["t.count"] == n_threads * n
    got = rec.recorded()
    assert got["counts"]["t.count"] == n_threads * n
    spans = got["spans"]
    assert len(spans) == 2 * n_threads * n
    outer = {(s["seq"], s["thread"]) for s in spans
             if s["name"] == "t.outer"}
    assert len(outer) == n_threads * n
    assert all((s["seq"], s["thread"]) in outer for s in spans
               if s["name"] == "t.inner")


# ------------------------------------------------ the benchmark's readers

def synthetic():
    """A recorder's stretch and totals: two engine batches and a mesh
    batch, each with a 1 ms sync inside."""
    ms = 1_000_000

    def sp(name, parent, seq, t0, t1):
        return dict(name=name, parent=parent, seq=seq, thread="MainThread",
                    start_ns=t0 * ms, end_ns=t1 * ms)
    spans = [sp("sync.overflow_tier", "engine.paired", 1, 2, 3),
             sp("engine.paired", None, 1, 0, 10),
             sp("engine.paired", None, 2, 10, 20),
             sp("sync.probe_window", "seed[0]", 3, 21, 22),
             sp("mesh.paired", None, 3, 20, 40)]
    counts = {"engine.reads": 400, "engine.truncated": 100,
              "engine.batches": 2, "alloc.device_mallocs": 6,
              "alloc.retries": 0, "engine.syncs": 5, "mesh.batches": 1}
    totals = dict(spans={"index.host_tables": (1, 12.5),
                         "index.cuckoo_layout": (1, 3.25)},
                  counts=counts)
    return dict(spans=spans, counts=counts), totals


EXPECTED = {
    "engine.truncated_share": 0.25,
    "engine.mallocs_per_batch": 3.0,
    "engine.host_us_per_op": 19_000 / 100,
    "engine.syncs_per_batch": 2.5,
    "mesh.syncs_per_batch": 5.0,
    "mesh.sync_wait_share": 0.002 / 2.0,
    "mesh.host_us_per_op": 19_000 / 100,
    "index.host_tables_s": 12.5,
    "index.cuckoo_layout_s": 3.25,
}
CTX = {"trace": {"n_ops": 100}, "traced_s": 2.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_recorder(name, monkeypatch):
    rec, totals = synthetic()
    monkeypatch.setattr(stats, "recorded", lambda: rec)
    monkeypatch.setattr(stats, "totals", lambda: totals)
    assert bench_run.read_metric(name, CTX) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing(name, monkeypatch):
    monkeypatch.setattr(stats, "recorded", lambda: dict(spans=[],
                                                        counts={}))
    monkeypatch.setattr(stats, "totals", lambda: dict(spans={}, counts={}))
    assert bench_run.read_metric(name, CTX) is None
    assert bench_run.read_metric(name, {}) is None
    monkeypatch.delattr(stats, "recorded")
    monkeypatch.delattr(stats, "totals")
    assert bench_run.read_metric(name, CTX) is None


def test_op_profile_names_gaps_after_spans():
    """tools/op_profile.py's SpanTimeline on a made-up batch (us): the
    innermost span at a moment, the spans open across a gap, labels."""
    from snap_rnaseq_tpu_torch.tools import op_profile

    def sp(name, t0, t1, thread="MainThread"):
        return dict(name=name, parent=None, seq=1, thread=thread,
                    start_ns=int(t0 * 1e3), end_ns=int(t1 * 1e3))
    spans = [sp("seed", 10, 20), sp("sync.x", 12, 18), sp("expand", 30, 40),
             sp("engine.paired", 0, 100), sp("pipeline.write", 5, 50,
                                             thread="snap-writer")]
    tl = op_profile.SpanTimeline(spans, "MainThread")
    assert tl.label(tl.at(15)) == "engine.paired / seed / sync.x"
    assert tl.label(tl.at(25)) == "engine.paired"
    assert tl.label(tl.at(150)) == "(no span)"
    assert tl.label(tl.across(13, 17)) == "engine.paired / seed / sync.x"
    assert tl.label(tl.across(15, 35)) == "engine.paired"
    dev = [("k1", True, 0.0, 13.0), ("k2", True, 16.0, 19.0),
           ("k3", True, 33.0, 34.0)]
    gaps = op_profile.idle_gaps(dev, [], 5, tl)
    assert [(g["gap_ms"], g["span"]) for g in gaps] == [
        (0.014, "engine.paired"), (0.003, "engine.paired / seed / sync.x")]
