"""The harness's parts found by name (benchmark/lookup.py): the three
cells' genome, read pools, step results and reference answers byte for
byte as the harness made them before the lookups; a configuration whose
entry, extra input, read source and reference are new files, run whole
with no harness file changed; an unknown name failing before any work,
with the path it looked for.

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
SEEDS = (2 ** 31 + 5, 977)

# sha256 of (genome codes and piece offsets; every pool batch's reads,
# qualities and true_loc; the rows of one System.step on pool batch 0;
# the reference's answers for the same reads), at tiny_spec's sizes on
# the CPU, as the harness computed them before its parts were looked up
DIGESTS = {
    ("hglike-64m.pe100-bulk", SEEDS[0]): (
        "75ebc6ff76e7c2176577e1318783d9c56cb9a1a975c1d96077ad60250025e36b",
        "416e8d6a7a3a33ba24bc006d8c362a12a0bbf1b9fe27f00cbe33d74369ce621f",
        "451c59969d04e3b42c4eec134dfbd0bd89d42d73fd310e7b990b85d41713a7d6",
        "9acf1f7576cfcc5b20582e5c8e5c768697a4cd3ffcdf0af993d22f46f109b7d3"),
    ("hglike-64m.pe100-bulk", SEEDS[1]): (
        "75ebc6ff76e7c2176577e1318783d9c56cb9a1a975c1d96077ad60250025e36b",
        "b7c8340cc6a538f538e18f9d84322a7e4166d190669bd0936686cbcd92b1b11e",
        "0923a39c0389ba1a47bf4756d648bf006a56e9af2a8063c14d66ecbaabbe69e4",
        "72868af4df84c77514e5ce501b37aae0a9ba602000f9b135df2a5d39bf7a1b22"),
    ("hglike-3g.pe100-bulk", SEEDS[0]): (
        "07b2854c4ba84d7f86112764868e738f6b47ab73aa9dbe99eb252c46506a4c6b",
        "05c54452e91f190bec880e1a9c07d4e151f8755857699e6c240493ae5789df87",
        "2cff51a50fc43b70d369c23eeeb505bbce5aa09034b5291b7d87eaa5aac664b2",
        "136bd03049e5d1f6b0ba939420ecb871551fc32f6e56fdb21574a76e058a1173"),
    ("hglike-3g.pe100-bulk", SEEDS[1]): (
        "07b2854c4ba84d7f86112764868e738f6b47ab73aa9dbe99eb252c46506a4c6b",
        "d4d274563581f3c5c52fae829a72952c0e3a9229b1f09a8da9d33e188361ab0c",
        "264ee405cd40cb095ae1f018880a25c89e4259ad5b0705d5ee823e38c4e47224",
        "03e7ea3c6b65ce8f6984c6988c01f71e59bef70cf0dea1af436f9fde8e1b3b90"),
    ("hglike-64m.se100-bulk", SEEDS[0]): (
        "75ebc6ff76e7c2176577e1318783d9c56cb9a1a975c1d96077ad60250025e36b",
        "43fc2fae37e30c02511fc8b0cfec97664ee676d1b7f474c635eb76f9ba7dd14d",
        "7a9875c77e8002c4cdd29030cfd1b0fa293e5a8a1fdfb64f81ee1de650281d44",
        "f6aea34d9e7426c2d9df429550b65435e16b2cc8c6a032fc61b21afb98297431"),
    ("hglike-64m.se100-bulk", SEEDS[1]): (
        "75ebc6ff76e7c2176577e1318783d9c56cb9a1a975c1d96077ad60250025e36b",
        "c8f10d043ab3de452e927a3ac043068d95f0c430ca3c8277a4bccc9cbee2f60f",
        "0c88a185aa20449d2bab8bf5b8ca9f106971daee8943195404e83f7e1f99ca71",
        "056c44b7e6817e845d6a37ea63511de0055e6e5a87f3e8ca20de9a4785fe1fcd"),
}


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

@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cells_inputs_and_answers_did_not_move(name):
    spec = tiny_spec(name)
    config, traffic = spec["config"], spec["traffic"]
    genome, extras = run.inputs(config)
    assert extras == {}
    system = program.System(genome, extras, config, traffic, "cpu")
    ref = lookup.reference(config).make(genome, extras, config, traffic,
                                        "cpu")
    for seed in SEEDS:
        pool = make_pool(genome, traffic, 256, seed, extras)
        b = pool[0]
        rows = system.step([torch.from_numpy(x) for pair in
                            zip(b.reads, b.quals) for x in pair]).numpy()
        want = ref.align(b.reads, b.quals)
        got = (digest([genome.codes, genome.piece_offsets]),
               digest([x for p in pool for x in p.reads + p.quals
                       + p.true_loc]),
               digest([rows]),
               digest([want[k] for k in sorted(want)]))
        assert got == DIGESTS[(name, seed)], seed


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
