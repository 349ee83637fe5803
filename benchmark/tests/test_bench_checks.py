"""The check that decides `correct`, shown to fail: a whole run on the CPU
at a tiny size with the timed path replaced by the control (the plain
reference computing its probabilities in bfloat16 where the
configurations state float32) or broken underneath (an answer altered
where it is produced; half of each batch left out; on the mesh, the
exchange between index slices left out) must come out not correct.  The
same run unbroken is correct (test_bench_harness.py).

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.entries.paired import PAIR_KEYS
from benchmark.entries.single import SINGLE_KEYS
from benchmark.reference.aligner import Reference, ref_params

BENCH = run.benchmark_file()
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def spec_for(name: str, bases=1_000_000, reads=256, config=None,
             slices=None) -> dict:
    spec = copy.deepcopy(run.cell_spec(BENCH, name))
    if config:
        spec["config"] = run.load_json(f"{run.HERE}/configs/{config}.json")
        spec["config"]["genome"]["chromosomes"] = 2
    g = spec["config"]["genome"]
    g["bases"] = bases
    if slices:
        spec["config"]["index"]["slices"] = slices
    spec["config"]["reads_per_batch"] = reads
    spec["traffic"]["pool_batches"] = 2
    spec["cell"]["check_reads"] = reads
    return spec


def broken_run(name, spec, wrap):
    def hook(system):
        system.step = wrap(system, system.step)
    return run.run(name, SEED, 0.2, False, spec=spec, bench=BENCH,
                   device="cpu", hook=hook)


def assert_not_correct(line):
    assert not line["correct"]
    assert any(v["value"] > v["limit"] for v in line["compared"].values())


CELLS = ["hglike-64m.pe100-bulk", "hglike-64m.se100-bulk"]


def duplicated(n_bases: int, seed: int = 0, **_fracs) -> np.ndarray:
    """A random half and a copy of it at 1.5% substitutions: every read
    has a second placement a few edits away, so its MAPQ rests on the
    probability mass of both."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 4, n_bases // 2, dtype=np.uint8)
    copy_ = half.copy()
    hit = rng.random(half.size) < 0.015
    copy_[hit] = (copy_[hit] + rng.integers(1, 4, int(hit.sum()),
                                            dtype=np.uint8)) % 4
    return np.concatenate([half, copy_, half[:n_bases % 2]])


@pytest.mark.parametrize("name", CELLS)
def test_control_in_bfloat16_is_not_correct(name, monkeypatch):
    """The control on a genome whose reads all have a near placement."""
    import benchmark.gen.genomes.hg_like as gg
    monkeypatch.setattr(gg, "hg_like", duplicated)
    spec = spec_for(name)
    paired = spec["traffic"]["mode"] == "paired"

    def wrap(system, step):
        from benchmark.gen.genome import make_genome
        genome = make_genome(spec["config"]["genome"], workers=1)
        ref = Reference(genome.codes, genome.piece_offsets,
                        ref_params(spec["config"], spec["traffic"]),
                        "cpu", prob_dtype="bfloat16")

        def control(batch):
            x = [t.numpy() for t in batch]
            out = ref.align(x[0::2], x[1::2])
            keys = PAIR_KEYS if paired else SINGLE_KEYS
            return torch.from_numpy(np.stack([
                out["dir" if k == "direction" else k] for k in keys
            ]).astype(np.int64).astype(np.int32))
        return control
    assert_not_correct(broken_run(name, spec, wrap))


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name):
    spec = spec_for(name)
    paired = spec["traffic"]["mode"] == "paired"

    def wrap(system, step):
        def altered(batch):
            rows = step(batch).clone()
            keys = PAIR_KEYS if paired else SINGLE_KEYS
            i = keys.index("loc0" if paired else "loc")
            rows[i] += 1
            return rows
        return altered
    assert_not_correct(broken_run(name, spec, wrap))


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_not_correct(name):
    spec = spec_for(name)
    paired = spec["traffic"]["mode"] == "paired"

    def wrap(system, step):
        def half(batch):
            n = batch[0].shape[0] // 2
            rows = step([t[:n] for t in batch])
            rest = torch.zeros((rows.shape[0], batch[0].shape[0] - n),
                               dtype=rows.dtype)
            keys = PAIR_KEYS if paired else SINGLE_KEYS
            for i, k in enumerate(keys):
                if k.startswith(("loc", "score", "pair_score")):
                    rest[i] = -1
            return torch.cat([rows, rest], dim=1)
        return half
    assert_not_correct(broken_run(name, spec, wrap))


def test_mesh_without_the_exchange_is_not_correct():
    """The mesh over two index slices with each slice's candidates and
    seed counts kept to itself."""
    name = "hglike-64m.pe100-bulk"
    spec = spec_for(name, bases=2_000_000, reads=256, config="hglike-3g",
                    slices=2)
    import snap_rnaseq_tpu_torch.parallel.sharded as sh
    gather, psum = sh._all_gather_rows, sh._psum

    def wrap(system, step):
        assert system.n_slices == 2
        sh._all_gather_rows = lambda xs, dev: gather([xs[0]] * len(xs), dev)
        sh._psum = lambda xs, dev: xs[0].to(dev)
        return step
    try:
        assert_not_correct(broken_run(name, spec, wrap))
    finally:
        sh._all_gather_rows, sh._psum = gather, psum


def test_mesh_is_correct():
    name = "hglike-64m.pe100-bulk"
    spec = spec_for(name, bases=2_000_000, reads=256, config="hglike-3g",
                    slices=2)
    line = run.run(name, SEED, 0.2, False, spec=spec, bench=BENCH,
                   device="cpu")
    assert line["correct"], line["compared"]
