"""The port's bench and profiling tools (snap_rnaseq_tpu_torch/tools/
bench.py, engine_ab.py, phase_profile.py and op_profile.py) on the CPU.

* bench.py's operating point, cand_per_read=64, held to the JAX package on
  a 1.5 Mb hg-like genome at seed length 20 (built by the bench's own
  index step with device cpu, loaded by both packages) and 2 batches of 64
  wgsim pairs: the paired engine (integers bit for bit, pair_log_pall
  within 1e-5), the single-end engine on the paired aligner's device
  state, and the bench's FASTQ-to-SAM run against the JAX package's
  PairedEndPipeline on the same FASTQ (byte for byte without @PG);
* engine_ab: `norescue` against the JAX engine in the same configuration,
  `onehot` equal to `default`, SNAP_TPU_LV_LANES restored after it;
* phase_profile: each phase's output equal to the intermediate the engine
  computes on the same batch, the full batch to align_batch_device, the
  flat phases to flat_align_batch at the engine's per-end config;
* the four tools' command lines at tiny sizes, in a process where `jax`
  and `snap_rnaseq_tpu` cannot be imported (started first, it runs beside
  the JAX compiles): bench's one JSON line with bench.py's keys and the new
  ones, engine_ab's b2048, cand128 and se lines, phase_profile's phase
  names, op_profile's CPU timeline (categories summing to the total, the
  top-n sorted); no device metric carries a number on the CPU;
* each tool raises at its default device without a card.

The JAX side compiles three engines (paired at cand 64, single at cand 64,
paired without the mate rescue); its PairedEndPipeline takes the compiled
paired aligner through `aligner=`, as bench.py:405-407 does."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from snap_rnaseq_tpu.index.hash_index import GenomeIndex as JGenomeIndex
from snap_rnaseq_tpu.models import paired as jp
from snap_rnaseq_tpu.models import single as js
from snap_rnaseq_tpu.models.paired_pipeline import \
    PairedEndPipeline as JPairedEndPipeline
from snap_rnaseq_tpu.models.paired_pipeline import \
    PairedPipelineOptions as JPairedPipelineOptions
from snap_rnaseq_tpu_torch.models import paired as pm
from snap_rnaseq_tpu_torch.models import single as sg
from snap_rnaseq_tpu_torch.models.paired import PairedAligner
from snap_rnaseq_tpu_torch.tools import (bench, engine_ab, measure,
                                         op_profile, phase_profile)

torch.set_num_threads(1)   # beside the other test processes' threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = 1_500_000
B = 64
TOOLS = (bench, engine_ab, phase_profile, op_profile)


def _compare(got, want):
    assert set(want) <= set(got), set(want) - set(got)
    for k, w in want.items():
        w = np.asarray(w)
        g = np.asarray(got[k])
        if w.dtype == np.uint32:
            g = g.astype(np.int32).view(np.uint32)
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _same(got, want, where=""):
    """The same values, to the bit (the same torch code on the same
    inputs), through dicts, tuples and lists of tensors."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True, msg=where)
    else:
        assert got == want, where


def _sam_body(path):
    lines = [l for l in open(path).read().splitlines()
             if not l.startswith("@PG")]
    return "\n".join(lines) + "\n"


_BLOCKED_RUN = r"""
import contextlib, io, json, sys
sys.modules["jax"] = None
sys.modules["snap_rnaseq_tpu"] = None
import torch
torch.set_num_threads(1)
from snap_rnaseq_tpu_torch.tools import bench, engine_ab, op_profile, \
    phase_profile
common = ["--index", sys.argv[1], "--bases", sys.argv[2], "--batch-pairs",
          "4", "--device", "cpu"]
out = {}
for name, mod, argv in (
        ("bench", bench, ["--rounds", "1", "--windows", "2"]),
        ("engine_ab", engine_ab, ["b2048", "cand128", "se", "--rounds", "1",
                                  "--windows", "1"]),
        ("phase_profile", phase_profile, ["--calls", "1",
                                          "--cand-per-read", "64"]),
        ("op_profile", op_profile, ["5", "--batches", "1"])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv + common) == 0
    out[name] = buf.getvalue().splitlines()
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "snap_rnaseq_tpu")
            and sys.modules[m] is not None]
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """bench.py's index at 1.5 Mb, built as the bench builds it (device
    cpu), and the port's paired aligner at cand_per_read=64 on it."""
    tmp = str(tmp_path_factory.mktemp("bench_tools"))
    index, _s, how = measure.open_index(None, tmp, BASES, "cpu")
    assert how == "build"
    d = os.path.join(tmp, f"hg{BASES}_s20")
    assert measure.open_index(None, tmp, BASES, "cpu")[2] == "load"
    batches = measure.pair_batches(index, BASES, B, "cpu", n_batches=2)
    paired = PairedAligner(index, device="cpu", cand_per_read=64)
    return dict(tmp=tmp, dir=d, index=index, paired=paired,
                batches=[tuple(x.numpy() for x in b) for b in batches])


@pytest.fixture(scope="module", autouse=True)
def blocked(world):
    """The tools' command lines with jax blocked, started before the JAX
    compiles of the other tests; the fixture's value waits for them and
    returns their (stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", _BLOCKED_RUN, world["dir"], str(BASES)],
        env=env, cwd=world["tmp"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    box = {}

    def result():
        if "out" not in box:
            box["out"] = proc.communicate(timeout=600)
        return box["out"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _blocked_lines(blocked, tool):
    out, err = blocked()
    line = next((l for l in out.splitlines() if l.startswith("RESULT ")),
                None)
    assert line is not None, err[-3000:]
    return [json.loads(l) for l in json.loads(line[7:])[tool]]


@pytest.fixture(scope="module")
def jax_paired(world):
    return jp.PairedAligner(JGenomeIndex.load(world["dir"]),
                            cand_per_read=64)


@pytest.fixture(scope="module")
def port_paired_out(world):
    return [world["paired"].align_batch(*b) for b in world["batches"]]


def test_paired_engine_at_cand64_matches_jax(world, jax_paired,
                                             port_paired_out):
    for got, b in zip(port_paired_out, world["batches"]):
        want = jax_paired.align_batch(*b)
        _compare(got, want)
        assert set(got) == set(want)
        assert np.asarray(want["pair_found"]).mean() > 0.9


def test_single_on_shared_state_matches_jax(world):
    paired = world["paired"]
    single = measure.single_on_state(paired, cand_per_read=64)
    assert single.state is paired.state          # no second upload
    jsingle = js.SingleAligner(JGenomeIndex.load(world["dir"]),
                               cand_per_read=64)
    for r0, q0, _r1, _q1 in world["batches"]:
        _compare(single.align_batch(r0, q0), jsingle.align_batch(r0, q0))


def test_bench_sam_matches_jax_pipeline(world, jax_paired):
    d = os.path.join(world["tmp"], "sam")
    line = bench.run(world["index"], device="cpu", bases=BASES,
                     batch_pairs=B, rounds=1, windows=1, sam_dir=d,
                     base=world["paired"])
    assert line["extra"]["end_to_end_reads_per_sec"] > 0
    assert line["extra"]["fraction_pairs_found"] > 0.9
    pipe = JPairedEndPipeline(
        JGenomeIndex.load(world["dir"]),
        options=JPairedPipelineOptions(batch_size=B), aligner=jax_paired)
    out = os.path.join(d, "jax.sam")
    stats = pipe.run(os.path.join(d, "r1.fq"), os.path.join(d, "r2.fq"), out)
    assert stats.total_reads == 2 * B * measure.N_BATCHES
    assert _sam_body(os.path.join(d, "out.sam")) == _sam_body(out)


def test_engine_ab_norescue_matches_jax(world):
    eng = engine_ab.config_engine("norescue", world["paired"])
    assert not eng.cfg.mate_rescue and eng.cfg.cand_per_read == 64
    want_eng = jp.PairedAligner(JGenomeIndex.load(world["dir"]),
                                cand_per_read=64, mate_rescue=False)
    for b in world["batches"]:
        got, want = eng.align_batch(*b), want_eng.align_batch(*b)
        _compare(got, want)
        assert int(got["n_rescued0"]) == int(got["n_rescued1"]) == 0


def test_engine_ab_onehot_equals_default(world, port_paired_out,
                                         monkeypatch):
    monkeypatch.setenv(engine_ab.LANES_ENV, "bits")
    eng = engine_ab.config_engine("onehot", world["paired"])
    with engine_ab.lanes_env("onehot"):
        assert os.environ[engine_ab.LANES_ENV] == "onehot"
        for got, want in zip((eng.align_batch(*b)
                              for b in world["batches"]), port_paired_out):
            _compare(got, want)
    assert os.environ[engine_ab.LANES_ENV] == "bits"
    with engine_ab.lanes_env("default"):
        assert engine_ab.LANES_ENV not in os.environ
    assert os.environ[engine_ab.LANES_ENV] == "bits"


def test_phase_profile_phases_equal_engine(world, monkeypatch):
    """phase_profile's phases at cand 64 against the intermediates the
    engine computes on the same batch (its phase functions spied on), and
    the flat phases against flat_align_batch at the per-end config."""
    n = 16
    lines, outs = phase_profile.run(
        world["index"], device="cpu", bases=BASES, batch_pairs=n,
        cand_per_read=64, calls=1, base=world["paired"])
    names = [l["phase"] for l in lines]
    assert names == [*phase_profile.FLAT, *phase_profile.PAIRED,
                     phase_profile.FULL, "sum of pair: phases"]
    batch = measure.pair_batches(world["index"], BASES, n, "cpu", 1)[0]
    pa = measure.paired_on_state(world["paired"], cand_per_read=64)

    seen = {}

    def spy(mod, attr, phase):
        fn = getattr(mod, attr)

        def rec(*a, **kw):
            out = fn(*a, **kw)
            seen.setdefault(phase, []).append(out)
            return out
        monkeypatch.setattr(mod, attr, rec)
    for mod, attr, phase in (
            (sg, "seed_phase", "pair:seed"),
            (sg, "budget_phase", "pair:budget"),
            (sg, "expand_phase", "pair:expand"),
            (sg, "_aggregate_rows", "pair:aggregate_rows"),
            (sg, "rowwise_score_phase", "pair:rowwise_score"),
            (sg, "rowwise_replay_phase", "pair:rowwise_replay"),
            (sg, "dense_topk_rowwise", "pair:dense_topk"),
            (pm, "_mate_rescue_end", "rescue"),
            (pm, "pair_phase", "pair:pair_phase")):
        spy(mod, attr, phase)
    full = pa.align_batch_device(*batch)
    monkeypatch.undo()
    assert len(seen["rescue"]) == 2
    seen["pair:mate_rescue0"], seen["pair:mate_rescue1"] = (
        [x] for x in seen.pop("rescue"))
    for phase in phase_profile.PAIRED:
        assert len(seen[phase]) == 1, phase
        want = seen[phase][0]
        got = outs[phase][1] if phase == "pair:budget" else outs[phase]
        _same(got, want, phase)
    _same(outs[phase_profile.FULL], full, "full")

    single = measure.single_on_state(pa)
    single.cfg = pa.cfg.end_config()
    u, sc, out = sg.flat_align_batch(single, batch[0], batch[1])
    _same(outs["compact"][0], u, "compact")
    _same(outs["score(filtered)"], sc, "score(filtered)")
    _same(outs["compact"][1], out.pop("compact_overflow"), "overflow")
    _same(outs["replay"], out, "replay")


def test_bench_prints_one_line_with_bench_keys(blocked):
    lines = _blocked_lines(blocked, "bench")
    assert len(lines) == 1
    line = lines[0]
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    x = line["extra"]
    assert x["device"] == {"kind": "cpu", "smi": None}
    assert line["value"] == x["paired"]["reads_per_sec"]["median"] > 0
    rps = x["paired"]["reads_per_sec"]
    assert len(rps["windows"]) == 2
    assert rps["min"] <= rps["median"] <= rps["max"]
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / x["baseline_reads_per_sec"])
    assert "not a card figure" in x["baseline_source"]
    for part in (x["paired"], x["single_end"]):
        for k in ("device_busy_ms_per_batch", "device_idle_share",
                  "device_ops_per_batch", "kernel_ms_per_batch"):
            assert part[k] is None, k           # no device on the CPU
        assert part["launches_per_batch"] == {}
    assert x["peak_device_bytes"] is None
    assert x["index_source"] == "load" and x["cand_per_read"] == 64
    assert x["single_end"]["fraction_aligned"] > 0.5
    assert x["end_to_end_reads_per_sec"] > 0
    assert len(x["end_to_end"]["wait"]) == 2


def test_engine_ab_prints_config_lines(blocked):
    lines = _blocked_lines(blocked, "engine_ab")
    assert [l["config"] for l in lines] == ["b2048", "cand128", "se"]
    assert [l["batch"] for l in lines] == [8, 4, 4]
    for l in lines:
        assert l["reads_per_sec"] > 0 and l["device"]["kind"] == "cpu"
        assert l["device_busy_ms_per_batch"] is None


def test_phase_profile_lines_name_phases(blocked):
    lines = _blocked_lines(blocked, "phase_profile")
    assert [l["phase"] for l in lines] == [
        *phase_profile.FLAT, *phase_profile.PAIRED, phase_profile.FULL,
        "sum of pair: phases"]
    for l in lines[:-1]:
        assert l["cand_per_read"] == 64 and l["calls"] == 1
        assert l["wall_ms"] > 0 and l["device_busy_ms"] is None
    s = lines[-1]
    assert s["wall_ms"] == pytest.approx(sum(
        l["wall_ms"] for l in lines if l["view"] == "paired"))


def test_op_profile_cpu_timeline(blocked):
    (line,) = _blocked_lines(blocked, "op_profile")
    assert line["timeline"] == "cpu" and line["device"]["kind"] == "cpu"
    assert line["device_idle_share"] is None and line["gaps"] is None
    assert sum(line["rollup"].values()) == pytest.approx(
        line["self_ms_per_batch"], rel=1e-9)
    ms = [t[1] for t in line["top"]]
    assert len(ms) == 5 and ms == sorted(ms, reverse=True)
    assert all(t[0].startswith("aten::") for t in line["top"])
    assert set(line["rollup"]) <= {
        "sort", "scatter", "gather/index", "reductions",
        "copies and memsets", "elementwise", "other"}
    c = line["counters"]
    assert c["engine.batches"] == 1
    assert c["engine.reads"] == 2 * line["batch_pairs"]


def test_op_profile_categories():
    cat = op_profile.category
    assert cat("void lv_lanes_kernel<1>(int)") == "K1_lv_lanes"
    assert cat("void bitpar_packed_kernel<4, true, true, true>(x)") == \
        "K2_bitpar_rescue"
    assert cat("void at::native::index_elementwise_kernel<128, 4>") == \
        "gather/index"
    assert cat("void cub::DeviceRadixSortOnesweepKernel<x>") == "sort"
    assert cat("Memcpy HtoD (Pageable -> Device)") == "copies and memsets"
    assert cat("void at::native::reduce_kernel<512, 1>") == "reductions"
    assert cat("aten::bitwise_and", "cpu") == "elementwise"
    assert cat("aten::index_put_", "cpu") == "scatter"
    assert cat("aten::empty", "cpu") == "other"


def test_op_profile_idle_gaps():
    """The longest gaps between device operations, each with what the
    host had open across it, on a made-up timeline (name, on the device,
    start us, end us)."""
    frame = "/x/snap_rnaseq_tpu_torch/models/single.py(599): score"
    dev = [("k1", True, 0.0, 10.0), ("k2", True, 30.0, 40.0),
           ("k3", True, 41.0, 50.0), ("k4", True, 50.0, 60.0)]
    cpu = [(frame, False, 0.0, 100.0), ("aten::item", False, 5.0, 35.0),
           ("aten::add", False, 12.0, 13.0), ("torch/x.py(1): f", False,
                                              39.0, 42.0)]
    gaps = op_profile.idle_gaps(dev, cpu, 5)
    assert [g["gap_ms"] for g in gaps] == [0.02, 0.001]
    assert gaps[0] == dict(
        gap_ms=0.02, after="k1", before="k2", host_op="aten::item",
        aten_op="aten::item",
        frame="snap_rnaseq_tpu_torch/models/single.py(599): score")
    assert gaps[1]["host_op"] == "torch/x.py(1): f"
    assert gaps[1]["aten_op"] is None


def test_profiled_window_fills_the_floor():
    """A profiled window holds at least its given units and
    MIN_PROFILE_MS of work at the measured wall a unit."""
    assert measure.MIN_PROFILE_MS == 50.0
    assert measure.profiled_units(4, 25.0) == 4
    assert measure.profiled_units(4, 0.4) == 125
    assert measure.profiled_units(10, 6.0) == 10
    assert measure.profiled_units(1, 0.0) == 50_000


def test_device_profile_on_cpu_measures_nothing():
    ran = []
    prof = measure.device_profile(lambda: ran.append(1), 3,
                                  torch.device("cpu"))
    assert prof == dict(device_busy_ms=None, device_ops=None,
                        kernel_ms=None, kernel_events=None)
    assert ran == []


def test_bench_baseline_is_the_record():
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as f:
        rec = json.load(f)
    assert bench.load_baseline() == rec["paired_reads_per_sec_32t_estimate"]
    assert bench.load_baseline(single=True) == \
        rec["reads_per_sec_32t_estimate"]
    assert "not a card figure" in bench.BASELINE_LABEL


@pytest.mark.parametrize("tool", TOOLS, ids=lambda t: t.__name__.split(".")[-1])
def test_tool_raises_without_card(world, tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--index", world["dir"]])


def test_tools_run_without_jax(blocked):
    out, err = blocked()
    assert "RESULT " in out, err[-3000:]
