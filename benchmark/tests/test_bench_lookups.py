"""The harness's parts found by name (benchmark/lookup.py): each cell's
genome, extra inputs, read pools, step results and reference answers
byte for byte as its own file of digests pins them; a configuration
whose entry, extra input, read source and reference are new files, run
whole and held to the harness's tests with no harness file changed; an
unknown name failing before any work, with the path it looked for.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import copy
import filecmp
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchmark.gen.genome as gg
import benchmark.program as program
from benchmark import lookup, run
from benchmark.gen.reads import make_pool

BENCH = run.benchmark_file()
SEEDS = (2 ** 31 + 5, 977)     # every cell's pinned seeds

# each cell's pins, benchmark/tests/digests/<cell>.json: for each of its
# seeds, sha256 of the genome codes and piece offsets; every pool batch's
# reads, qualities and true_loc; the rows of one System.step on pool
# batch 0; the reference's answers for the same reads; the extra inputs'
# arrays (extras_arrays), at tiny_spec's sizes on the CPU
DIGEST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digests")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_spec(name: str) -> dict:
    """The cell at 256 reads a batch on a 1 Mb genome; hglike-3g on two
    chromosomes of 1 Mb in two index slices."""
    spec = copy.deepcopy(run.cell_spec(BENCH, name))
    g = spec["config"]["genome"]
    if spec["config"]["name"] == "hglike-3g":
        g["chromosomes"], g["bases"] = 2, 2_000_000
        spec["config"]["index"]["slices"] = 2
    else:
        g["bases"] = 1_000_000
    spec["config"]["reads_per_batch"] = 256
    spec["traffic"]["pool_batches"] = 2
    return spec


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ------------------------------------------------------------ the cells

def pinned(name: str) -> dict:
    """The cell's digests by seed, from its file, which pins SEEDS."""
    path = os.path.join(DIGEST_DIR, name + ".json")
    if not os.path.isfile(path):
        pytest.fail(f"no digest file {path} for the cell {name!r}")
    pins = {int(s): d for s, d in run.load_json(path)["digests"].items()}
    assert sorted(pins) == sorted(SEEDS), path
    return pins


def extras_arrays(x):
    """The arrays of the extra inputs by kind (kinds, and a dict's keys,
    in sorted order; text as its UTF-8 bytes)."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from extras_arrays(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from extras_arrays(v)
    elif isinstance(x, str):
        yield np.frombuffer(x.encode(), np.uint8)
    else:
        yield np.asarray(x)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cells_inputs_and_answers_did_not_move(name):
    pins = pinned(name)
    spec = tiny_spec(name)
    config, traffic = spec["config"], spec["traffic"]
    genome, extras = run.inputs(config)
    system = program.System(genome, extras, config, traffic, "cpu")
    ref = lookup.reference(config).make(genome, extras, config, traffic,
                                        "cpu")
    for seed, pin in pins.items():
        pool = make_pool(genome, traffic, 256, seed, extras)
        b = pool[0]
        rows = system.step([torch.from_numpy(x) for pair in
                            zip(b.reads, b.quals) for x in pair]).numpy()
        want = ref.align(b.reads, b.quals)
        got = dict(genome=digest([genome.codes, genome.piece_offsets]),
                   pool=digest([x for p in pool for x in p.reads + p.quals
                                + p.true_loc]),
                   rows=digest([rows]),
                   reference=digest([want[k] for k in sorted(want)]),
                   extras=digest(extras_arrays(extras)))
        assert got == pin, seed


# ------------------------------------------------------------ new files

TOY_FILES = {
    "gen/extras/toy_exons.py": '''
"""Exon intervals: `transcripts` transcripts of `exons` exons each, laid
out inside the genome's pieces from the spec's seed."""
import numpy as np


def make(genome, spec):
    rng = np.random.default_rng(int(spec["seed"]))
    out = []
    for _ in range(int(spec["transcripts"])):
        n = int(spec["exons"])
        lens = rng.integers(*spec["exon_len"], n)
        gaps = rng.integers(*spec["intron_len"], n - 1)
        span = int(lens.sum() + gaps.sum())
        c = int(rng.integers(len(genome.piece_offsets)))
        s = genome.piece_offsets[c] + int(rng.integers(genome.piece_len
                                                       - span))
        starts = s + np.concatenate([[0], np.cumsum(lens[:-1] + gaps)])
        out.append(np.stack([starts, starts + lens], 1))
    return out
''',
    "gen/sources/toy_spliced.py": '''
"""FR pairs cut from spliced transcripts (the exons of toy_exons joined);
true_loc is the genome offset of each read's first aligned base."""
import numpy as np

from ..reads import Batch, substitute


def make_batch(genome, extras, traffic, n_frag, rng):
    L = int(traffic["read_len"])
    tx = [np.concatenate([np.arange(a, b) for a, b in t])
          for t in extras["toy_exons"]]
    frags = []
    for _ in range(n_frag):
        t = tx[int(rng.integers(len(tx)))]
        ins = min(int(rng.integers(traffic["insert_lo"],
                                   traffic["insert_hi"])), t.size)
        s = int(rng.integers(t.size - ins + 1))
        frags.append(t[s:s + ins])
    r0 = np.stack([genome.codes[f[:L]] for f in frags])
    r1 = np.stack([3 - genome.codes[f[-L:][::-1]] for f in frags])
    true = [np.array([f[0] for f in frags], np.int64),
            np.array([f[-L] for f in frags], np.int64)]
    reads = [r0.astype(np.uint8), r1.astype(np.uint8)]
    for r in reads:
        substitute(r, float(traffic["sub_rate"]), rng)
    q = np.full((n_frag, L), ord(traffic["quality"]), np.uint8)
    return Batch(reads=reads, quals=[q, q.copy()], true_loc=true)
''',
    "entries/toy_paired.py": '''
"""The paired entry under another name, handed the exons."""
from . import paired


def build(index, genome, extras, config, traffic, device):
    assert len(extras["toy_exons"]) == 64
    return paired.build(index, genome, extras, config, traffic, device)
''',
    "reference/toy_aligner.py": '''
"""The DNA reference under another name, handed the exons."""
from . import aligner


def make(genome, extras, config, traffic, device, control=False):
    assert len(extras["toy_exons"]) == 64
    return aligner.make(genome, extras, config, traffic, device, control)
''',
}

# the toy cell's pins, as its own digest file holds them
PINS = ("genome", "pool", "rows", "reference", "extras")
TOY_DIGESTS = {
    "2147483653": dict(zip(PINS, (
        "a0e66c124f1b0ace035d889ec36e5f44a27637472b4f834f966002199a392390",
        "5f2ccbff7facab8b20ccb2725b4b2e9eb0ae3dc207671cc75f01cce8c76872e3",
        "b5c4366b4e163d78fc70dbc6e9d5b473b274812d55bafeae6de24db318b8109d",
        "6601d07a02bc0b7622e438dac02f5981610c16986840a88d13347ac33d058779",
        "fbdc0018171fc9120b9a3b651db8ad8a55c963695a43c0928ae9510cecd2120a"))),
    "977": dict(zip(PINS, (
        "a0e66c124f1b0ace035d889ec36e5f44a27637472b4f834f966002199a392390",
        "a6e9b385cf46000a6cf4346a3e22ec17ad57a920a6e1c689236e98229da0b6c9",
        "4738e6860c877d76a1582519be44c107fa785778b4fdf53c7d67c47e2956254b",
        "4c83efafa3aeafccfe399f0b9eadd41774f898a9c66626296e4655f30e7f44c7",
        "fbdc0018171fc9120b9a3b651db8ad8a55c963695a43c0928ae9510cecd2120a"))),
}

RUN_IN_COPY = """
import json, os, sys, torch
torch.set_num_threads(2)
import benchmark
from benchmark import run
assert benchmark.__file__.startswith(os.getcwd()), benchmark.__file__
print(json.dumps(run.run(sys.argv[1], int(sys.argv[2]), 0.3, False,
                         device="cpu")))
"""


def _files(base):
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", ".cache")]
        for f in files:
            yield os.path.relpath(os.path.join(d, f), base)


def test_a_configuration_is_added_as_files_only(tmp_path):
    copied = tmp_path / "benchmark"
    shutil.copytree(run.HERE, copied, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    config = run.load_json(os.path.join(run.HERE, "configs",
                                        "hglike-64m.json"))
    config.update(name="toy", entry={"paired": "toy_paired"},
                  reference="toy_aligner", reads_per_batch=256,
                  extras=[dict(kind="toy_exons", seed=7, transcripts=64,
                               exons=4, exon_len=[150, 600],
                               intron_len=[200, 3000])])
    config["genome"].update(bases=400_000, chromosomes=2)
    traffic = dict(run.load_json(os.path.join(run.HERE, "traffic",
                                              "pe100-bulk.json")),
                   name="toy-spliced", source="toy_spliced", pool_batches=2)
    added = dict(TOY_FILES)
    added["configs/toy.json"] = json.dumps(config)
    added["traffic/toy-spliced.json"] = json.dumps(traffic)
    added["cells/toy.toy-spliced.json"] = json.dumps(
        {"check_reads": 256, "limits": {"mismatch_share": 0.0016}})
    added["tests/digests/toy.toy-spliced.json"] = json.dumps(
        {"digests": TOY_DIGESTS})
    for rel, text in added.items():
        assert not (copied / rel).exists(), rel
        (copied / rel).write_text(text)
    bench = copy.deepcopy(BENCH)
    bench["configs"].append(dict(
        name="toy", source="a test", file="benchmark/configs/toy.json",
        reduced=[], why="new entry, extra, source and reference"))
    bench["workloads"].append(dict(name="toy.toy-spliced", config="toy",
                                   traffic="toy-spliced", chips=1,
                                   why="spliced pairs"))
    next(m for m in bench["per_layer"] if m["name"] == "index.build_s")[
        "workloads"].append("toy.toy-spliced")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), run.ROOT]))
    proc = subprocess.run(
        [sys.executable, "-c", RUN_IN_COPY, "toy.toy-spliced",
         str(2 ** 31 + 21)], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], (line["compared"], proc.stderr[-4000:])
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert "toy_exons in" in proc.stderr
    assert line["metrics"]["placed_share"]["value"] > 0.5

    # the harness's tests and every cell's digests, the new one's too
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "benchmark/tests/test_bench_harness.py",
         "benchmark/tests/test_bench_lookups.py::"
         "test_cells_inputs_and_answers_did_not_move"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-6000:]
    assert "did_not_move[toy.toy-spliced] PASSED" in proc.stdout

    # no file of the harness differs from the repo's but the added ones
    repo = set(_files(run.HERE))
    assert set(_files(copied)) == repo | set(added)
    for rel in repo:
        assert filecmp.cmp(os.path.join(run.HERE, rel), copied / rel,
                           shallow=False), rel


# ------------------------------------------------------------ unknown names

def _named(spec: dict, part: str, name: str) -> str:
    """`spec` naming `name` for `part`; the file the harness looks for."""
    config, traffic = spec["config"], spec["traffic"]
    if part == "entry":
        config["entry"][traffic["mode"]] = name
        sub = "entries"
    elif part == "genome":
        config["genome"]["kind"] = name
        sub = "gen/genomes"
    elif part == "extra":
        config["extras"] = [dict(kind=name, seed=1)]
        sub = "gen/extras"
    elif part == "source":
        traffic["source"] = name
        sub = "gen/sources"
    else:
        config["reference"] = name
        sub = "reference"
    return os.path.join(run.HERE, *sub.split("/"), name + ".py")


def _no_work(*_a, **_k):
    raise AssertionError("set-up went on past an unknown name")


@pytest.mark.parametrize("part,name", [
    ("entry", "no_such_entry"), ("genome", "no_such_genome"),
    ("extra", "no_such_extra"), ("source", "no_such_source"),
    ("reference", "no_such_reference"), ("reference", "compare"),
    ("entry", "../run")])
def test_an_unknown_name_fails_before_any_work(part, name, monkeypatch):
    spec = tiny_spec("hglike-64m.pe100-bulk")
    path = _named(spec, part, name)
    monkeypatch.setattr(gg, "make_genome", _no_work)
    monkeypatch.setattr(program, "System", _no_work)
    with pytest.raises(LookupError) as e:
        run.run("hglike-64m.pe100-bulk", 1, 0.1, False, spec=spec,
                bench=BENCH, device="cpu")
    assert path in str(e.value)


@pytest.mark.parametrize("reference,names", [
    ("aligner", ["mismatch_share"]),
    ("rna", ["mismatch_share", "genome_mismatch_share"])])
def test_a_reference_brings_its_comparison(reference, names):
    """The numbers that decide `correct` are the reference's own where
    its file defines them, compare.py's otherwise."""
    cmp = lookup.comparison(dict(reference=reference))
    keys = ["loc0", "loc1", "dir0", "dir1", "score0", "score1", "mapq0",
            "mapq1", "pair_found", "pair_score"]
    out = {p + k: np.arange(4) for k in keys for p in ("", "g_")}
    assert list(cmp.numbers(out, out, True)) == names
    assert set(cmp.numbers(out, out, True).values()) == {0.0}
