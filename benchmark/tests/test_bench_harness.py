"""The benchmark harness on the CPU: discovery by name, the generators'
determinism, the roofline's counts, the imports it may not make, and a
whole run at a tiny size through the port's plain PyTorch versions.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import ast
import copy
import os

import numpy as np
import pytest
import torch

from benchmark import roofline, run, trace
from benchmark.gen.genome import make_genome
from benchmark.gen.genomes.hg_like import hg_like
from benchmark.gen.reads import make_pool

ROOT = run.ROOT
BENCH = run.benchmark_file()


def tiny_spec(name: str, bases: int = 1_000_000, reads: int = 256) -> dict:
    spec = copy.deepcopy(run.cell_spec(BENCH, name))
    spec["config"]["genome"]["bases"] = bases
    spec["config"]["reads_per_batch"] = reads
    spec["traffic"]["pool_batches"] = 2
    spec["cell"]["check_reads"] = reads // 2
    return spec


# ------------------------------------------------------------ discovery

@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    spec = run.cell_spec(BENCH, w["name"])
    assert spec["config"]["name"] == w["config"]
    assert spec["traffic"]["name"] == w["traffic"]
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert set(spec["cell"]["limits"]) == {"mismatch_share"}
    assert spec["config"]["entry"][spec["traffic"]["mode"]]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    assert os.path.exists(os.path.join(run.HERE, "metrics",
                                       m["name"] + ".py"))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    # a reader finds nothing to read in an untraced context
    assert run.read_metric(m["name"], dict(parts={}, n_slices=1)) is None


def test_every_cell_reports_the_required_metrics():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in run.metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_for(BENCH, w["name"], True)
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


# ------------------------------------------------------------ generators

def test_genome_is_the_seed_s():
    a, b = hg_like(200_000, 0), hg_like(200_000, 0)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, hg_like(200_000, 1))
    g = make_genome(dict(kind="hg_like", bases=300_000, chromosomes=3,
                         seed=100, padding=500), workers=1)
    assert g.size == 3 * (500 + 100_000) + 500
    assert np.array_equal(g.codes[g.piece_offsets[1]:][:100_000],
                          hg_like(100_000, 101))
    assert (g.codes[:500] == 5).all()


@pytest.mark.parametrize("traffic", ["pe100-bulk", "se100-bulk"])
def test_traffic_is_the_seed_s(traffic):
    spec = tiny_spec(f"hglike-64m.{traffic}")
    g = make_genome(spec["config"]["genome"], workers=1)
    t = spec["traffic"]
    big = 2 ** 31 + 977
    p1, p2 = make_pool(g, t, 512, big), make_pool(g, t, 512, big)
    p3 = make_pool(g, t, 512, big + 1)
    for a, b in zip(p1, p2):
        for x, y in zip(a.reads + a.true_loc, b.reads + b.true_loc):
            assert np.array_equal(x, y)
    assert not np.array_equal(p1[0].reads[0], p3[0].reads[0])
    assert all(b.n_reads == 512 for b in p1 + p3)
    L = t["read_len"]
    for b in p1:
        for r, loc in zip(b.reads, b.true_loc):
            assert r.shape == (512 // t["ends"], L) and (r < 4).all()
            # never across padding
            assert (g.codes[loc[:, None] + np.arange(L)] < 4).all()


# ------------------------------------------------------------ roofline

def test_roofline_counts():
    # one 100-base pattern word count: 4 words; 10 a word and column + 4
    assert roofline.bitpar_ops(2, 10, 100) == 2 * 10 * (4 * 10 + 4) + \
        2 * 100 * 4
    assert roofline.bitpar_packed_bytes(3, 100, 16) == 3 * (100 + 64 + 4) \
        + 12
    # an LV row at level 2 of a 100-base pattern: 12 (4 + 4) + 5 * 25 * 6
    assert roofline.lv_ops(np.array([2]), 100) == 12 * 8 + 5 * 25 * 6
    lev = roofline.lv_levels(np.array([3, -1]), np.array([3, 9]),
                             np.array([17, 0]), 17)
    assert lev.tolist() == [3, 1]
    assert roofline.lv_bytes(1, 100, 117, 4, True) == 100 + 117 + 400 + \
        16 + 20
    ops = roofline.int32_ops_per_s(132, 1.98e9)
    assert ops == 132 * 64 * 1.98e9
    assert roofline.bound_s(3.35e12, 0, ops) == 1.0


def test_device_union_and_categories():
    busy, merged = trace.union_us([(0, 10), (5, 12), (20, 30)])
    assert busy == 22 and merged == [[0, 12], [20, 30]]
    assert trace.category("void lv_lanes_kernel<17>(...)") == "K1_lv_lanes"
    assert trace.category("bitpar_packed_kernel<5, true>") == \
        "K2_bitpar_rescue"
    assert trace.category("at::native::vectorized_elementwise_kernel") == \
        "elementwise"


# ------------------------------------------------------------ imports

def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules(sub=""):
    base = os.path.join(run.HERE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_and_a_plain_reference():
    for path in _modules():
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax",
                                      "snap_rnaseq_tpu"}
        assert not bad, (path, bad)
    for path in _modules("reference"):
        assert "snap_rnaseq_tpu_torch" not in set(_imports(path)), path


# ------------------------------------------------------------ whole runs

@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["hglike-64m.pe100-bulk",
                                  "hglike-64m.se100-bulk"])
def test_run_is_correct_on_the_cpu(name):
    line = run.run(name, 2 ** 31 + 5, 0.5, False, spec=tiny_spec(name),
                   bench=BENCH, device="cpu")
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "compared"
    for v in line["compared"].values():
        assert v["value"] == 0.0
    m = line["metrics"]
    assert m["placed_share"]["value"] > 0.9
    assert m["reads_per_s"]["value"] > 0
