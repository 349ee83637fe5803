"""The port's data-parallel processes (`--hosts`) against the JAX package,
on the CPU.

* io/range_split.py: the same record-aligned ranges as the JAX package's
  on tests/test_multihost.py's fixture, single and paired;
* parallel/multihost.py merge_parts: byte-identical to the JAX package's
  on the same part files, unsorted and sorted (ties across parts);
* launch_local with 2 CPU workers (gloo, and the file barrier without a
  coordinator): the merged SAM body equals the port's one-process body,
  with the stats tests/test_multihost.py asserts; `single --hosts 2` through
  the port CLI; one worker in a subprocess where `jax` and
  `snap_rnaseq_tpu` cannot be imported;
* the faults shared with the JAX package, pinned: under --hosts only the
  batch size and -so reach the workers (-M is dropped), and a .bam or
  .sam.gz target gets plain SAM parts (no merged BAM, a plain-text
  .sam.gz);
* a read's alignment depends on the other reads of its batch (the pooled
  spill tier of rowwise_score_phase), in both packages, so hosts whose
  batch cuts differ from one process's may differ in their records;
* two processes opening a fresh index at once both get the cuckoo layout,
  and its disk cache is whole after."""
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_multihost
from snap_rnaseq_tpu.index.genome import genome_from_codes as jgenome
from snap_rnaseq_tpu.index.hash_index import build_index as jbuild_index
from snap_rnaseq_tpu.io import range_split as jrs
from snap_rnaseq_tpu.models.single import SingleAligner as JSingleAligner
from snap_rnaseq_tpu.parallel import multihost as jmh
from snap_rnaseq_tpu_torch.cli import main as port_cli
from snap_rnaseq_tpu_torch.index.genome import genome_from_codes
from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex, build_index
from snap_rnaseq_tpu_torch.io import range_split as rs
from snap_rnaseq_tpu_torch.models.paired_pipeline import (
    PairedEndPipeline, PairedPipelineOptions)
from snap_rnaseq_tpu_torch.models.pipeline import (PipelineOptions,
                                                   SingleEndPipeline)
from snap_rnaseq_tpu_torch.models.single import SingleAligner
from snap_rnaseq_tpu_torch.parallel import multihost as mh
from test_torch_lookup import repeat_codes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAIRS = test_multihost.N_PAIRS
ENGINE = dict(cand_per_read=32, max_seed_slots=16)
MERGED_KEYS = set(mh.STATS_FIELDS) | {"local_wall_s", "host_id", "n_hosts"}

mh_fixture = test_multihost.mh_fixture


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread here and in the workers: the suite runs its
    files in parallel processes, whose thread pools would otherwise crowd
    the cores."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def body(path):
    return [l for l in open(path, "rb") if l[:1] != b"@"]


@pytest.fixture(scope="module")
def one_process(mh_fixture):
    """The port's one-process paired and single runs on the fixture."""
    d = mh_fixture
    index = GenomeIndex.load(str(d / "idx"))
    paired_out, single_out = str(d / "one_p.sam"), str(d / "one_s.sam")
    stats = PairedEndPipeline(
        index, options=PairedPipelineOptions(batch_size=64), device="cpu",
        **ENGINE).run(str(d / "r1.fq"), str(d / "r2.fq"), paired_out,
                      command_line="mh-test")
    SingleEndPipeline(index, options=PipelineOptions(batch_size=64),
                      device="cpu").run(str(d / "r1.fq"), single_out)
    return dict(paired=paired_out, single=single_out, stats=stats)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_fastq_range_split_matches_jax(mh_fixture, n):
    path = str(mh_fixture / "r1.fq")
    ranges = rs.split_fastq_ranges(path, n)
    assert ranges == jrs.split_fastq_ranges(path, n)
    got = [r.rid for s, e in ranges for r in rs.read_fastq_range(path, s, e)]
    assert got == [r.rid for s, e in ranges
                   for r in jrs.read_fastq_range(path, s, e)]
    assert len(got) == N_PAIRS


@pytest.mark.parametrize("n", [2, 3])
def test_paired_range_split_matches_jax(mh_fixture, n):
    p0, p1 = str(mh_fixture / "r1.fq"), str(mh_fixture / "r2.fq")
    ranges = rs.split_paired_fastq_ranges(p0, p1, n)
    assert ranges == jrs.split_paired_fastq_ranges(p0, p1, n)
    pairs = [(a.rid, b.rid) for r0, r1 in ranges
             for a, b in rs.read_paired_fastq_range(p0, p1, r0, r1)]
    assert len(pairs) == N_PAIRS


def _write_parts(out, rng):
    """Three sorted SAM parts over two references, with equal (reference,
    position) keys across parts and unmapped records at the end."""
    header = (b"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrA\tLN:5000\n"
              b"@SQ\tSN:chrB\tLN:3000\n@PG\tID:x\n")
    for k in range(3):
        recs = []
        for j in range(12):
            ref = (b"chrA", b"chrB")[int(rng.integers(0, 2))]
            pos = int(rng.integers(1, 30))          # few values: ties
            recs.append((ref, pos, b"r%d_%d\t0\t%s\t%d\t60\t4M\t*\t0\t0\t"
                         b"ACGT\tIIII\n" % (k, j, ref, pos)))
        recs.sort(key=lambda r: (r[0] == b"chrB", r[1]))
        recs.append((b"*", 0, b"u%d\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n"
                     % k))
        with open(mh.part_path(out, k), "wb") as f:
            f.write(header + b"".join(r[2] for r in recs))


@pytest.mark.parametrize("sorted_output", [False, True])
def test_merge_parts_matches_jax(tmp_path, sorted_output):
    port_out, jax_out = str(tmp_path / "p.sam"), str(tmp_path / "j.sam")
    for out in (port_out, jax_out):
        _write_parts(out, np.random.default_rng(1))
    mh.merge_parts(port_out, 3, sorted_output=sorted_output)
    jmh.merge_parts(jax_out, 3, sorted_output=sorted_output)
    got = open(port_out, "rb").read()
    assert got == open(jax_out, "rb").read()
    assert len(body(port_out)) == 39


@pytest.mark.parametrize("use_distributed", [True, False],
                         ids=["gloo", "file_barrier"])
def test_launch_local_matches_one_process(mh_fixture, one_process,
                                          use_distributed, capfd):
    d = mh_fixture
    out = str(d / f"multi_{use_distributed}.sam")
    merged = mh.launch_local(
        2, str(d / "idx"), (str(d / "r1.fq"), str(d / "r2.fq")), out,
        paired=True, batch_size=64, aligner_args=ENGINE,
        use_distributed=use_distributed, device="cpu", timeout=300)
    assert body(out) == body(one_process["paired"])
    ref = one_process["stats"]
    assert merged["total_reads"] == ref.total_reads == 2 * N_PAIRS
    assert merged["aligned_as_pairs"] == ref.aligned_as_pairs
    assert merged["n_hosts"] == 2
    assert set(merged) == MERGED_KEYS
    # each worker's report line, passed on by the launcher
    lines = [json.loads(l.split(":", 1)[1]) for l in
             capfd.readouterr().err.splitlines()
             if l.startswith("multihost worker:")]
    assert sorted(w["host_id"] for w in lines) == [0, 1]
    assert all(w["device"] == "cpu" and w["peak_device_bytes"] is None
               for w in lines)


def test_cli_single_hosts_drops_aligner_flags(mh_fixture, one_process,
                                              capsys):
    """`single --hosts 2 --device cpu` through the port CLI equals the
    one-process run; -M, like every aligner flag but -bs and -so, does
    not reach the workers (JAX cli.py:271-282, multihost.py:84-98): the
    CIGARs stay =/X."""
    d = mh_fixture
    out = str(d / "cli_hosts.sam")
    assert port_cli(["single", str(d / "idx"), str(d / "r1.fq"), "-o", out,
                     "--hosts", "2", "-bs", "64", "-M", "--device",
                     "cpu"]) == 0
    printed = capsys.readouterr().out
    line = next(l for l in printed.splitlines()
                if l.startswith("multihost:"))
    assert "'n_hosts': 2" in line and f"'total_reads': {N_PAIRS}" in line
    assert body(out) == body(one_process["single"])
    with_m = str(d / "one_s_M.sam")
    assert port_cli(["single", str(d / "idx"), str(d / "r1.fq"), "-o",
                     with_m, "-bs", "64", "-M", "--device", "cpu"]) == 0
    assert body(with_m) != body(out)
    assert any(b"M\t" in l.split(b"\t")[5] + b"\t" for l in body(with_m))


@pytest.mark.parametrize("target", ["x.bam", "x.sam.gz"])
def test_hosts_output_forms_fault(mh_fixture, one_process, target):
    """A part path ends in .partNNNN, so the parts are plain SAM whatever
    the target; merge_parts writes no .bam (multihost.py:166-167) and a
    .sam.gz target receives plain text, as in the JAX package."""
    d = mh_fixture
    out = str(d / target)
    merged = mh.run_host(str(d / "idx"), str(d / "r1.fq"), out, host_id=0,
                         n_hosts=1, paired=False, batch_size=64,
                         device="cpu")
    assert merged["total_reads"] == N_PAIRS
    part = open(mh.part_path(out, 0), "rb").read()
    assert part.startswith(b"@HD")
    if target.endswith(".bam"):
        assert not os.path.exists(out)
    else:
        assert open(out, "rb").read(2) != b"\x1f\x8b"
        assert body(out) == body(one_process["single"])


_BLOCKED_WORKER = r"""
import sys
sys.modules["jax"] = None
sys.modules["snap_rnaseq_tpu"] = None
import torch
torch.set_num_threads(1)
from snap_rnaseq_tpu_torch.parallel.multihost import main
sys.exit(main(sys.argv[1:]))
"""


def test_worker_runs_without_jax(mh_fixture, one_process):
    d = mh_fixture
    out = str(d / "blocked.sam")
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_WORKER, "--index", str(d / "idx"),
         "--r0", str(d / "r1.fq"), "--r1", str(d / "r2.fq"), "--out", out,
         "--host-id", "0", "--n-hosts", "1", "--batch-size", "64",
         "--cand-per-read", "32", "--max-seed-slots", "16", "--device",
         "cpu"], env=dict(os.environ, PYTHONPATH=REPO), cwd=str(d),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    merged = json.loads(r.stdout.strip().splitlines()[-1])
    assert merged["total_reads"] == 2 * N_PAIRS
    assert body(out) == body(one_process["paired"])


def test_entry_points_default_to_cuda(mh_fixture, monkeypatch):
    """Without a card the worker's main, run_host, launch_local and the
    CLI's --hosts raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = mh_fixture
    args = (str(d / "idx"), str(d / "r1.fq"), str(d / "never.sam"))
    for run in (
            lambda: mh.main(["--index", args[0], "--r0", args[1], "--out",
                             args[2], "--host-id", "0", "--n-hosts", "1"]),
            lambda: mh.run_host(*args, host_id=0, n_hosts=1, paired=False),
            lambda: mh.launch_local(2, *args, paired=False),
            lambda: port_cli(["single", args[0], args[1], "-o", args[2],
                              "--hosts", "2"])):
        with pytest.raises(RuntimeError, match="cuda"):
            run()


def _load_layout(directory, start, queue, wait_for_cache):
    """A process opening the index: at once, or (wait_for_cache) as soon
    as the layout's cache file appears, while its writer may still be at
    work."""
    from snap_rnaseq_tpu_torch.index.hash_index import (GenomeIndex,
                                                        cuckoo_layout_for)
    index = GenomeIndex.load(directory)
    start.wait(60)
    cache = os.path.join(directory, "bucket_layout_v2.npz")
    deadline = time.time() + 60
    while wait_for_cache and not os.path.exists(cache) \
            and time.time() < deadline:
        time.sleep(0.0002)
    layout = cuckoo_layout_for(index)
    queue.put({k: v.tobytes() for k, v in layout.items()})


def test_cuckoo_layout_cache_two_processes(tmp_path):
    """Two processes open a fresh index at once: one builds the layout and
    writes its disk cache, the other loads that cache the moment its name
    appears.  The name appears only when the file is whole, so both get
    the in-memory build's layout, and the file loads whole after."""
    from snap_rnaseq_tpu_torch.index.genome import genome_from_codes
    from snap_rnaseq_tpu_torch.index.hash_index import (build_cuckoo_layout,
                                                        build_index,
                                                        cuckoo_layout_for)
    codes = np.random.default_rng(2).integers(0, 4, 400_000, dtype=np.uint8)
    index = build_index(genome_from_codes(codes), seed_len=20)
    index.save(str(tmp_path / "idx"))
    want = build_cuckoo_layout(index.ht_keys, index.ht_val1, index.ht_val2,
                               index.shard_starts)
    ctx = multiprocessing.get_context("spawn")
    start, queue = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=_load_layout,
                         args=(str(tmp_path / "idx"), start, queue, wait))
             for wait in (False, True)]
    for p in procs:
        p.start()
    start.set()
    got = [queue.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(60)
        assert not p.is_alive() and p.exitcode == 0
    for layout in got:
        assert layout == {k: v.tobytes() for k, v in want.items()}
    assert not [f for f in os.listdir(tmp_path / "idx") if ".tmp" in f]
    again = cuckoo_layout_for(GenomeIndex.load(str(tmp_path / "idx")))
    assert {k: v.tobytes() for k, v in again.items()} == got[0]


def test_batch_cuts_change_results_in_both_packages():
    """Four reads with an insertion against a 30-copy repeat family (every
    copy needs LV) ride in a batch of 8 behind four unique reads, then
    behind four more such reads.  rowwise_score_phase pools the LV rows
    past each read's own tier into one spill tier of 8 rows, filled in
    row order, so the second batch leaves more of the four reads' rows
    unscored (score_overflow) and one of them changes location and MAPQ,
    in the JAX package exactly as in the port."""
    codes = repeat_codes()
    L = 100

    def indel_reads(seed):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(4):
            s = 2000 * int(rng.integers(0, 30)) + int(rng.integers(0, 1800))
            seg = list(codes[s:s + L + 4])
            p = int(rng.integers(20, 80))
            seg[p:p] = [int(rng.integers(0, 4))]
            out.append(np.array(seg[:L], np.uint8))
        return np.stack(out)
    target = indel_reads(0)
    batches = (np.concatenate([codes[60000:60400].reshape(4, L), target]),
               np.concatenate([indel_reads(1), target]))
    quals = np.full((8, L), 73, np.uint8)
    port = SingleAligner(build_index(genome_from_codes(codes), seed_len=20),
                         device="cpu")
    jax_al = JSingleAligner(jbuild_index(jgenome(codes), seed_len=20))
    got = [port.align_batch(b, quals) for b in batches]
    for b, g in zip(batches, got):
        want = jax_al.align_batch(b, quals)
        for k in ("result", "loc", "score", "mapq", "score_overflow"):
            np.testing.assert_array_equal(
                np.asarray(g[k]).astype(np.uint32),
                np.asarray(want[k]).astype(np.uint32), err_msg=k)
    assert int(got[1]["score_overflow"]) > int(got[0]["score_overflow"])
    for k in ("loc", "mapq"):
        assert (got[0][k][4:] != got[1][k][4:]).sum() == 1, k
