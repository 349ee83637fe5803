"""The PyTorch port end to end, on the CPU.

* SingleAligner.align_batch against the JAX SingleAligner on the golden
  dataset of tests/test_golden.py and on a repeat-rich genome with indel
  reads (integers bit-identical, log-probabilities within 1e-5);
* the port's `index` + `single` CLI reproduces tests/golden/single_100bp.sam
  byte for byte (without @PG), in-process and in a subprocess where `jax`
  and `snap_rnaseq_tpu` cannot be imported;
* asking for CUDA where there is none raises instead of falling back."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_golden
from snap_rnaseq_tpu.index.genome import genome_from_codes
from snap_rnaseq_tpu.index.hash_index import GenomeIndex as JGenomeIndex
from snap_rnaseq_tpu.index.hash_index import build_index
from snap_rnaseq_tpu.models.single import SingleAligner as JSingleAligner
from snap_rnaseq_tpu.utils.synth_genome import hg_like_genome
from snap_rnaseq_tpu_torch.cli import main as port_cli
from snap_rnaseq_tpu_torch.index.hash_index import GenomeIndex
from snap_rnaseq_tpu_torch.io.reads import make_batch
from snap_rnaseq_tpu_torch.io.readers import open_read_supplier
from snap_rnaseq_tpu_torch.models.single import SingleAligner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_KEYS = ("log_pbest", "log_pall")


def _sam_body(path):
    lines = [l for l in open(path).read().splitlines()
             if not l.startswith("@PG")]
    return "\n".join(lines) + "\n"


def _compare(got, want):
    assert set(want) <= set(got), set(want) - set(got)
    for k, w in want.items():
        w = np.asarray(w)
        g = np.asarray(got[k])
        if w.dtype == np.uint32:
            g = g.astype(np.int32).view(np.uint32)
        if k in FLOAT_KEYS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("golden"))
    fa, fq = test_golden._build_dataset(tmp)
    idx = os.path.join(tmp, "idx")
    assert port_cli(["index", fa, idx]) == 0
    return dict(tmp=tmp, fa=fa, fq=fq, idx=idx)


def test_align_batch_matches_jax_on_golden_reads(golden):
    reads = list(open_read_supplier(golden["fq"]))
    batch = make_batch(reads, 100, 64)
    want = JSingleAligner(JGenomeIndex.load(golden["idx"])).align_batch(
        batch.codes, batch.quals)
    got = SingleAligner(GenomeIndex.load(golden["idx"]),
                        device="cpu").align_batch(batch.codes, batch.quals)
    _compare(got, want)
    assert (np.asarray(want["result"]) > 0).all()


def test_align_batch_matches_jax_on_repeats():
    from test_torch_phases import simulate_reads
    codes = hg_like_genome(150_000, seed=8)
    index = build_index(genome_from_codes(codes), seed_len=20)
    reads, quals = simulate_reads(codes, np.random.default_rng(4), 48)
    kw = dict(max_hits=24, overflow_tier=True, cand_per_read=16)
    want = JSingleAligner(index, **kw).align_batch(reads, quals)
    got = SingleAligner(index, device="cpu", **kw).align_batch(reads, quals)
    _compare(got, want)
    assert np.asarray(want["truncated"]).max() > 0          # wide tier ran
    assert int(want["n_scored"]) > 0


def test_cli_reproduces_golden_sam(golden):
    out = os.path.join(golden["tmp"], "port.sam")
    assert port_cli(["single", golden["idx"], golden["fq"], "-o", out,
                     "--device", "cpu"]) == 0
    assert _sam_body(out) == open(test_golden.GOLDEN).read()


_BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["snap_rnaseq_tpu"] = None
import torch
torch.set_num_threads(1)   # beside the other test processes' threads
from snap_rnaseq_tpu_torch.cli import main
fa, fq, idx, out = sys.argv[1:5]
assert main(["index", fa, idx]) == 0
assert main(["single", idx, fq, "-o", out, "--device", "cpu"]) == 0
assert main(["single", idx, fq, "-so", "-o", out + ".bam", "--device",
             "cpu"]) == 0
assert main(["trace", idx, "ACGT" * 25, "--device", "cpu"]) == 0
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "snap_rnaseq_tpu")
            and sys.modules[m] is not None]
"""


def test_port_runs_without_jax(golden):
    idx = os.path.join(golden["tmp"], "idx_blocked")
    out = os.path.join(golden["tmp"], "blocked.sam")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, golden["fa"],
                        golden["fq"], idx, out], env=env, cwd=golden["tmp"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _sam_body(out) == open(test_golden.GOLDEN).read()
    assert os.path.exists(out + ".bam.bai")
    assert "result: " in r.stdout


def test_cuda_without_card_raises(golden, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = GenomeIndex.load(golden["idx"])
    with pytest.raises(RuntimeError, match="cuda"):
        SingleAligner(index)                     # the default is CUDA
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli(["single", golden["idx"], golden["fq"], "-o",
                  os.path.join(golden["tmp"], "never.sam")])
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli(["trace", golden["idx"], "ACGT" * 25])


def test_not_ported_forms_raise(golden):
    for argv in (["single", golden["idx"], golden["fq"], "-o", "x.sam",
                  "--hosts", "2"],
                 ["single", golden["idx"], golden["fq"], "-so", "-o",
                  "x.bam", "--hosts", "4"]):
        with pytest.raises(SystemExit, match="not yet ported"):
            port_cli(argv)
