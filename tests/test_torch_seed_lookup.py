"""The seed phase's routing and K7's wrapper checks, on the CPU.

* tools/cuckoo_cases.py's layouts answer as they were placed: the plain
  chain (models/single.py seed_phase_plain) finds every placed key, in
  its h1 bucket, its h2 bucket or the stash (the u32 max of each half
  where the stash holds a key more than once), and no absent one; these
  are the layouts the card tests hold K7 to;
* seed_phase sends only a cuckoo layout on a card to K7: CPU tensors and
  the probe-chain table stay on the plain chain, with no K7 launch;
* ops/lookup.py seed_lookup_cuda raises on what K7 does not take: CPU
  tensors, wrong dtypes or shapes (the positions' and the stash's
  included), seed lengths outside 16-25, N > S; K7's stash is the
  layout's CUCKOO_STASH rows.

K7 itself runs only on a card: tests/test_torch_kernels_cuda.py."""
import os
import re
import types

import numpy as np
import pytest
import torch

from snap_rnaseq_tpu_torch.index.genome import genome_from_codes
from snap_rnaseq_tpu_torch.index.hash_index import CUCKOO_STASH, build_index
from snap_rnaseq_tpu_torch.models import single as sg
from snap_rnaseq_tpu_torch.ops import kernels
from snap_rnaseq_tpu_torch.ops import lookup as lk
from snap_rnaseq_tpu_torch.ops import u32
from snap_rnaseq_tpu_torch.tools import cuckoo_cases as cc
from snap_rnaseq_tpu_torch.utils.synth_genome import hg_like_genome

LAYOUT = ("ck_buckets", "ck_buckets2", "ck_stash")
UNUSED = 0xFFFFFFFE


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case_tensors(case):
    tables = {k: u32.from_numpy(case[k]) for k in LAYOUT}
    return (torch.from_numpy(case["reads"]),
            tuple(int(p) for p in case["positions"]), tables,
            torch.from_numpy(case["overflow"]))


def layout_entries(case):
    """{(key, shard): (v1, v2)} of every entry in the case's layout, the
    stash's repeated keys at the max of each half."""
    ent = {}
    for name in ("ck_buckets", "ck_buckets2"):
        t = case[name]
        for r, e in zip(*np.nonzero(t[:, 8:16] != 0xFFFFFFFF)):
            ent[(int(t[r, e]), int(t[r, 8 + e]))] = (int(t[r, 16 + e]),
                                                     int(t[r, 24 + e]))
    st = {}
    for k, s, v1, v2 in case["ck_stash"].tolist():
        if s != 0xFFFFFFFF:
            a, b = st.get((k, s), (0, 0))
            st[(k, s)] = (max(a, v1), max(b, v2))
    assert not set(ent) & set(st)             # one place a key
    return {**ent, **st}


@pytest.mark.parametrize("seed_len", [16, 20, 25])
def test_case_layout_answers_as_placed(seed_len):
    rng = np.random.default_rng(seed_len)
    case = cc.seed_case(rng, 400, 100, seed_len, 48, past_end=True,
                        wild=True)
    placed = case["placed"]
    assert min(placed.values()) > 0, placed
    reads, pos, tables, ovf = case_tensors(case)
    out = sg.seed_phase_plain(reads, pos, seed_len, ovf,
                              case["genome_size"], tables)
    f, rc, valid = cc.pack(case["reads"], case["positions"], seed_len)
    ent = layout_entries(case)
    found = np.zeros(f.shape, bool)
    want_vals = np.full(f.shape + (2,), UNUSED, np.int64)
    for b, s in zip(*np.nonzero(valid)):
        fw, rv = int(f[b, s]), int(rc[b, s])
        k = min(fw, rv)
        hit = ent.get((k & 0xFFFFFFFF, k >> 32))
        if hit is None:
            continue
        found[b, s] = True
        v_f, v_r = hit if fw <= rv else hit[::-1]
        want_vals[b, s] = (v_f, v_f if fw == rv else v_r)
    np.testing.assert_array_equal(out["valid"].numpy(), valid)
    np.testing.assert_array_equal(out["found"].numpy(), found)
    np.testing.assert_array_equal(u32.to_numpy(out["vals"]), want_vals)
    assert found.any() and (valid & ~found).any()


@pytest.fixture(scope="module")
def small_index():
    return build_index(genome_from_codes(hg_like_genome(200_000, seed=5)),
                       seed_len=20)


@pytest.mark.parametrize("cuda", [False, True])
@pytest.mark.parametrize("layout", ["cuckoo", "probe"])
def test_seed_kernel_route(cuda, layout):
    """K7 takes a cuckoo layout on a card and nothing else."""
    reads = types.SimpleNamespace(is_cuda=cuda)
    keys = LAYOUT if layout == "cuckoo" else ("ht_entries", "shard_start",
                                               "shard_size")
    tables = dict.fromkeys(keys + ("overflow", "genome_p4"))
    assert sg.seed_kernel_route(reads, tables) == (cuda and
                                                  layout == "cuckoo")


@pytest.mark.parametrize("layout", ["cuckoo", "probe"])
@pytest.mark.parametrize("n_first", [0, 8])
def test_cpu_seed_phase_keeps_the_plain_chain(small_index, layout, n_first,
                                              monkeypatch):
    """On the CPU, seed_phase over either layout is the plain chain: K7's
    wrapper is not called and does not launch."""
    def refuse(*a, **k):
        raise AssertionError("K7's wrapper called on the CPU")
    monkeypatch.setattr(lk, "seed_lookup_cuda", refuse)
    monkeypatch.setenv("SNAP_TPU_LOOKUP", layout)
    state = sg.index_state(small_index, "cpu")
    assert ("ck_buckets" in state) == (layout == "cuckoo")
    rng = np.random.default_rng(3)
    codes = np.asarray(small_index.genome.codes)
    start = rng.integers(0, codes.size - 100, 64)
    reads = torch.from_numpy(codes[start[:, None] + np.arange(100)].copy())
    pos = tuple(range(0, 81, 3))
    before = kernels.LAUNCHES["K7_seed_lookup"]
    args = (reads, pos, 20, state["overflow"], state["genome_size"], state,
            n_first)
    got = sg.seed_phase(*args)
    assert kernels.LAUNCHES["K7_seed_lookup"] == before
    want = sg.seed_phase_plain(*args)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["found"].any()


def _wrapper_args(case):
    reads, pos, tables, ovf = case_tensors(case)
    return dict(reads=reads, positions=torch.tensor(pos, dtype=torch.int32),
                seed_len=20, tables=tables,
                overflow=ovf, genome_size=case["genome_size"],
                select_first_valid=0)


REFUSALS = {
    "cpu": ({}, RuntimeError),
    "reads_int32": (dict(reads=lambda a: a["reads"].to(torch.int32)),
                    TypeError),
    "buckets_int64": (dict(tables=lambda a: {
        **a["tables"], "ck_buckets": a["tables"]["ck_buckets"].long()}),
        TypeError),
    "overflow_int64": (dict(overflow=lambda a: a["overflow"].long()),
                       TypeError),
    "seed_len_15": (dict(seed_len=lambda a: 15), ValueError),
    "seed_len_26": (dict(seed_len=lambda a: 26), ValueError),
    "n_above_s": (dict(select_first_valid=lambda a: len(a["positions"]) + 1),
                  ValueError),
    "n_negative": (dict(select_first_valid=lambda a: -1), ValueError),
    "positions_int64": (dict(positions=lambda a: a["positions"].long()),
                        TypeError),
    "positions_2d": (dict(positions=lambda a: a["positions"][None]),
                     ValueError),
    "stash_of_64": (dict(tables=lambda a: {
        **a["tables"], "ck_stash": a["tables"]["ck_stash"][:64]}),
        ValueError),
    "rows_of_16": (dict(tables=lambda a: {
        **a["tables"], "ck_buckets": a["tables"]["ck_buckets"][:, :16]
        .contiguous()}), ValueError),
    "reads_1d": (dict(reads=lambda a: a["reads"][0]), ValueError),
}


@pytest.fixture(scope="module")
def small_case():
    return cc.seed_case(np.random.default_rng(9), 32, 100, 20, 32)


@pytest.mark.parametrize("what", list(REFUSALS))
def test_seed_lookup_cuda_refuses(small_case, what):
    """The wrapper raises before any launch on what K7 does not take; with
    CPU tensors that are otherwise right, on the device."""
    change, exc = REFUSALS[what]
    a = _wrapper_args(small_case)
    a.update({k: f(a) for k, f in change.items()})
    before = kernels.LAUNCHES["K7_seed_lookup"]
    with pytest.raises(exc):
        lk.seed_lookup_cuda(**a)
    assert kernels.LAUNCHES["K7_seed_lookup"] == before


def test_k7_stash_is_the_layouts():
    """K7 keeps the stash in a shared array of kStash rows and refuses
    any other count: kStash is the layout's CUCKOO_STASH."""
    src = open(os.path.join(os.path.dirname(kernels.__file__), os.pardir,
                            "csrc", "seed_lookup.cu")).read()
    rows = re.findall(r"constexpr int kStash = (\d+);", src)
    assert [int(r) for r in rows] == [CUCKOO_STASH]
