"""The port's side tools on the CPU.

* the SASS loop reader (tools/sass_loops.py) on cuobjdump-style text:
  cuobjdump itself runs only where the CUDA toolkit is installed;
* ops/probability_distance.py on tests/test_probability_distance.py's
  cases, tools/compute_roc.py on a SAM of wgsim-named reads and
  tools/distance_hist.py on the golden single-end SAM, each against the
  JAX package's (the same numbers, the same printed table)."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import test_golden
import test_probability_distance as jpd_test
from snap_rnaseq_tpu.ops.probability_distance import \
    ProbabilityDistance as JProbabilityDistance
from snap_rnaseq_tpu.tools import compute_roc as jroc
from snap_rnaseq_tpu.tools import distance_hist as jdh
from snap_rnaseq_tpu_torch.index.genome import read_fasta_genome
from snap_rnaseq_tpu_torch.ops.probability_distance import ProbabilityDistance
from snap_rnaseq_tpu_torch.tools import compute_roc, distance_hist, sass_loops
from snap_rnaseq_tpu_torch.utils.wgsim import wgsim_id

_LABELS = """
	code for sm_90a
		Function : _Zk1
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
.L_x_1:
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
.L_x_2:
        /*0020*/                   LOP3.LUT R3, R2, R4, R5, 0x96, !PT ;
        /*0030*/              @!P0 BRA `(.L_x_2) ;
        /*0040*/               @P1 BRA `(.L_x_1) ;
        /*0050*/                   BRA `(.L_x_3) ;
.L_x_3:
        /*0060*/                   EXIT ;
		Function : _Zk2
        /*0000*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;
        /*0010*/                   SHF.L.W.U32.HI R5, R4, 0x1, R3 ;
        /*0020*/                   LOP3.LUT R6, R5, R4, RZ, 0xc0, !PT ;
        /*0030*/               @P0 BRA 0x10 ;
        /*0040*/                   EXIT ;
"""


def test_sass_innermost_loops():
    """Labels and raw addresses as branch targets; an outer loop that holds
    another is not innermost; a forward branch is no loop."""
    funcs, labels = sass_loops.parse(_LABELS)
    assert set(funcs) == {"_Zk1", "_Zk2"}
    assert [b - a + 1 for a, b in sass_loops.innermost_loops(
        funcs["_Zk1"], labels["_Zk1"])] == [2]
    loops = sass_loops.innermost_loops(funcs["_Zk2"], labels["_Zk2"])
    assert [b - a + 1 for a, b in loops] == [3]
    assert [op for op, _ in funcs["_Zk2"][loops[0][0]:loops[0][1] + 1]] == [
        "SHF.L.W.U32.HI", "LOP3.LUT", "BRA"]


def test_sass_report_needs_cuobjdump(monkeypatch):
    monkeypatch.setattr(sass_loops, "cuobjdump", lambda: None)
    with pytest.raises(RuntimeError, match="cuobjdump"):
        sass_loops.report("lib.so")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs its files in parallel
    processes, whose thread pools would otherwise crowd the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


Q10 = chr(43)
PD_CASES = [  # tests/test_probability_distance.py's compute() calls
    ("A", "A", "I", 0, 0), ("A", "C", "I", 0, 0), ("A", "C", Q10, 0, 0),
    ("A", "A", "I", 1, 2), ("A", "C", "I", 1, 2), ("A", "C", Q10, 1, 2),
    ("AAAAA", "AAAAA", "IIIII", 1, 2), ("AAAAA", "AACAA", "IIIII", 1, 2),
    ("ACGTA", "ACGGTA", "IIIIII", 1, 2), ("ACGTA", "ACTA", "IIII", 1, 2),
    ("ACGTACGT", "ACGTTACGT", "I" * 9, 1, 2),
    ("ACGTACGT", "ACGACGT", "I" * 7, 1, 2),
    ("ACGTACGT", "ACTACGT", "I" * 7, 0, 2),
    ("ACGTACGT", "ACTACGT", "I" * 7, 1, 2),
    ("ACGTACGT", "ACGTTTACGT", "I" * 10, 1, 2),
    ("ACGTTTACGT", "ACGTACGT", "I" * 8, 1, 2)]


def test_probability_distance_matches_jax():
    got = ProbabilityDistance(0.1, 0.01, 0.2)
    want = JProbabilityDistance(0.1, 0.01, 0.2)
    for case in PD_CASES:
        g = jpd_test.compute(got, *case)
        assert g == jpd_test.compute(want, *case), case
        assert 0.0 < g <= 1.0


@pytest.fixture(scope="module")
def golden_genome(tmp_path_factory):
    """tests/test_golden.py's two-chromosome genome, saved as an index
    directory holds it (both tools read only the genome)."""
    tmp = str(tmp_path_factory.mktemp("tools"))
    fa, _ = test_golden._build_dataset(tmp)
    genome = read_fasta_genome(fa)
    genome.save(os.path.join(tmp, "idx"))
    return tmp, genome


def test_compute_roc_matches_jax(golden_genome):
    """wgsim-named records: placed at their origin, within and past the
    misalignment threshold, unmapped, and one whose id is not wgsim's."""
    tmp, genome = golden_genome
    rng = np.random.default_rng(3)
    lines = [b"@HD\tVN:1.6\n"]
    for i in range(120):
        piece = int(rng.integers(0, 2))
        name = genome.piece_names[piece]
        off = int(rng.integers(0, 4000))
        qname = wgsim_id(name, off, 100, first_half=bool(i % 2))
        shift = int(rng.choice([0, 0, 0, 7, 15, 16, 400]))
        flag = 4 if i % 17 == 0 else 0
        mapq = int(rng.integers(0, 71))
        lines.append(b"%s\t%d\t%s\t%d\t%d\t100M\t*\t0\t0\t*\t*\n"
                     % (qname, flag, name.encode(), off + 1 + shift, mapq))
    lines.append(b"notwgsim\t0\tchr1\t10\t60\t100M\t*\t0\t0\t*\t*\n")
    sam = os.path.join(tmp, "wgsim.sam")
    open(sam, "wb").writelines(lines)
    idx = os.path.join(tmp, "idx")
    got = compute_roc.compute_roc(idx, sam)
    want = jroc.compute_roc(idx, sam)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() > 100 and 0 < got[1].sum() < got[0].sum()
    assert _printed(compute_roc.main, [idx, sam]) == \
        _printed(jroc.main, [idx, sam])


def test_distance_hist_matches_jax(golden_genome):
    """The golden single-end SAM's 64 records through K1's plain version
    at e_max 31, without qualities, in one padded batch of mixed lengths
    (one record cut to 60 bases)."""
    tmp, _ = golden_genome
    idx = os.path.join(tmp, "idx")
    sam = os.path.join(tmp, "golden.sam")
    with open(test_golden.GOLDEN, "rb") as f, open(sam, "wb") as out:
        for i, line in enumerate(f):
            if i == 8:                              # a record, not @
                fl = line.split(b"\t")
                fl[9], fl[10] = fl[9][:60], fl[10][:60]
                line = b"\t".join(fl)
            out.write(line)
    got = distance_hist.distance_hist(idx, sam, device="cpu")
    want = jdh.distance_hist(idx, sam)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 64 and got[:4].sum() > 0
    assert _printed(distance_hist.main, [idx, sam, "--device", "cpu"]) == \
        _printed(jdh.main, [idx, sam])


def test_distance_hist_defaults_to_cuda(golden_genome, monkeypatch):
    """Without a card distance_hist and its main raise instead of running
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmp, _ = golden_genome
    idx = os.path.join(tmp, "idx")
    for run in (lambda: distance_hist.distance_hist(idx, test_golden.GOLDEN),
                lambda: distance_hist.main([idx, test_golden.GOLDEN])):
        with pytest.raises(RuntimeError, match="cuda"):
            run()
