"""Index-sharded alignment over a ('data', 'index') grid of devices.

Port of snap_rnaseq_tpu/parallel/sharded.py.  The reference scales by
threads over shared memory; its only index partitioning is the
4^(seedLen-16) hash tables selected by a seed's high bases
(GenomeIndex.cpp:312-316), and that key is the sharding seam here too:

  mesh = ('data', 'index')
  reads   : split over 'data' (each data shard aligns B / n_data reads)
  hash    : the logical tables split into contiguous ranges over 'index',
            each coordinate holding its slot slice and the matching
            overflow slice (partition_index)
  genome  : replicated, one copy per distinct device

Per data shard, for one end:
  1. each index coordinate packs the shard's seeds and looks them up in
     ITS table slice; seeds of other slices come back not-found;
  2. the per-seed hit counts are summed over 'index' (psum), so the
     budget, popularity and lowest-possible-score tables are the global
     ones;
  3. each coordinate expands ITS hits into candidate slots; the candidates
     are gathered over 'index' (all_gather), each read's shard blocks side
     by side;
  4. the scoring work (K2's prefilter, K1's LV) is re-split over 'index'
     by lane slices of the gathered candidates, then gathered back;
  5. the replay and selection run once.

JAX's shard_map runs every coordinate from one process; so does this
module.  A DeviceMesh is a grid of torch devices, and the collectives are
small explicit functions over the coordinates' tensors: on one card every
coordinate is the same device and the moves are no-ops; on the CPU the
tests run the very same code.  Values JAX keeps replicated over 'index'
(the budget, the aggregated candidates, the mate rescue, the pair join)
are computed once per data shard, on its lead device (coordinate (d, 0)),
since every replica is equal.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..constants import INVALID_GENOME_LOCATION, UNUSED_HASH_VALUE
from ..index.hash_index import (DeviceIndex, GenomeIndex,
                                build_cuckoo_layout, slice_cuts,
                                slice_layout)
from ..models import single as sg
from ..ops.genome_gather import genome_words
from ..ops.lv import phred_log_prob_device
from ..utils import stats
from ..utils.seed_sequencer import seed_position_schedule

I32 = torch.int32
# the candidate fields _aggregate_rows reads (JAX gathers `read` and
# `round` as well; neither is read)
_CAND_KEYS = ("dir", "loc", "order", "offset", "lp", "live")
_TABLE_KEYS = {True: ("ck_buckets", "ck_buckets2", "ck_stash"),
               False: ("ht_entries", "shard_start", "shard_size")}


def _use_cuckoo_lookup() -> bool:
    """SNAP_TPU_LOOKUP, read when an aligner is built: the cuckoo layout
    (the default) or the probe-chain table."""
    return os.environ.get("SNAP_TPU_LOOKUP", "cuckoo") == "cuckoo"


def partition_index(index: GenomeIndex, n_idx: int,
                    use_cuckoo: bool | None = None) -> dict:
    """Split the index into n_idx device slices (stacked leading axis).

    Each slice keeps the FULL logical-shard metadata vectors (n_shards
    entries) with size 0 for unowned tables, so the unmodified lookup
    misses on unowned seeds.  The arrays equal the JAX package's.  (An
    index built on the device, hash_index.py DeviceIndex, comes in this
    layout already.)"""
    if use_cuckoo is None:
        use_cuckoo = _use_cuckoo_lookup()
    starts = index.shard_starts
    ovf_starts = index.shard_ovf_starts
    gsize = index.genome_size
    cuts = slice_cuts(starts, n_idx)
    max_slots, max_ovf, sh_start, sh_size = slice_layout(starts, ovf_starts,
                                                         cuts)

    entries = np.zeros((n_idx, max_slots, 3), np.uint32)
    entries[:, :, 1] = INVALID_GENOME_LOCATION
    ovf = np.zeros((n_idx, max_ovf), np.uint32)

    for d in range(n_idx):
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        s0, s1 = int(starts[lo]), int(starts[hi])
        o0, o1 = int(ovf_starts[lo]), int(ovf_starts[hi])
        entries[d, :s1 - s0, 0] = index.ht_keys[s0:s1]
        v1 = index.ht_val1[s0:s1].astype(np.uint64)
        v2 = index.ht_val2[s0:s1].astype(np.uint64)
        # rebase overflow pointers (value >= genome size) to the local slice
        for v in (v1, v2):
            is_ovf = (v >= gsize) & (v != INVALID_GENOME_LOCATION) & \
                (v != UNUSED_HASH_VALUE)
            v[is_ovf] -= np.uint64(o0)
        entries[d, :s1 - s0, 1] = v1.astype(np.uint32)
        entries[d, :s1 - s0, 2] = v2.astype(np.uint32)
        ovf[d, :o1 - o0] = index.overflow[o0:o1]

    # per-device bucket (cuckoo) layouts at ONE common shape (hashing uses
    # GLOBAL shard ids via shard_base).  With SNAP_TPU_LOOKUP=probe no
    # layout is built, and placeholder arrays keep the shapes uniform.
    if not use_cuckoo:
        return dict(ht_entries=entries, overflow=ovf,
                    shard_start=sh_start, shard_size=sh_size, cuts=cuts,
                    ck_buckets=np.zeros((n_idx, 1, 32), np.uint32),
                    ck_buckets2=np.zeros((n_idx, 1, 32), np.uint32),
                    ck_stash=np.zeros((n_idx, 1, 4), np.uint32))
    max_n = 0
    for d in range(n_idx):
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        s0, s1 = int(starts[lo]), int(starts[hi])
        max_n = max(max_n, int((index.ht_val1[s0:s1] !=
                                np.uint32(INVALID_GENOME_LOCATION)).sum()))
    nb1 = max(16, int(np.ceil(max_n / (8 * 0.8))))

    def build(d, nb2_min):
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        s0, s1 = int(starts[lo]), int(starts[hi])
        return build_cuckoo_layout(
            index.ht_keys[s0:s1], entries[d, :s1 - s0, 1],
            entries[d, :s1 - s0, 2], starts[lo:hi + 1] - s0,
            shard_base=lo, nb1=nb1, nb2_min=nb2_min)

    # the slices build side by side (numpy's sorts release the GIL); a
    # slice already built with nb2 == nb2_min would rebuild to the same
    # layout (its L2 loop would stop at once), so only the others rebuild
    layouts = [None] * n_idx
    nb2_min = 16
    with ThreadPoolExecutor(max_workers=min(n_idx, os.cpu_count() or 1)) \
            as pool:
        while True:
            todo = [d for d, l in enumerate(layouts)
                    if l is None or l["ck_buckets2"].shape[0] != nb2_min]
            for d, l in zip(todo, pool.map(build, todo,
                                           [nb2_min] * len(todo))):
                layouts[d] = l
            nb2_max = max(l["ck_buckets2"].shape[0] for l in layouts)
            if all(l["ck_buckets2"].shape[0] == nb2_max for l in layouts):
                break
            nb2_min = nb2_max    # rebuild so every slice shares one shape
    cuckoo = {k: np.stack([l[k] for l in layouts]) for k in
              ("ck_buckets", "ck_buckets2", "ck_stash")}

    return dict(ht_entries=entries, overflow=ovf,
                shard_start=sh_start, shard_size=sh_size, cuts=cuts,
                **cuckoo)


def seed_position_schedule_cached(read_len, seed_len, max_slots):
    """The first max_slots positions of the seed schedule, and their
    wrap counts."""
    positions, wraps = seed_position_schedule(read_len, seed_len)
    S = min(max_slots, len(positions))
    return positions[:S], wraps[:S]


# ----------------------------------------------------------------------
# the mesh and its collectives
# ----------------------------------------------------------------------

class DeviceMesh:
    """An (n_data, n_index) grid of torch devices.  One process drives
    every coordinate; coordinates may share a device."""

    def __init__(self, devices):
        grid = np.empty((len(devices), len(devices[0])), object)
        for d, row in enumerate(devices):
            if len(row) != grid.shape[1]:
                raise ValueError("every data row needs n_index devices")
            for i, dev in enumerate(row):
                grid[d, i] = torch.device(dev)
        self.devices = grid
        self.shape = {"data": grid.shape[0], "index": grid.shape[1]}


def make_mesh(n_data: int, n_index: int, device="cuda") -> DeviceMesh:
    """Every coordinate of an n_data x n_index mesh on `device` (one card,
    or the CPU).  Asking for CUDA where there is none raises."""
    dev = sg.resolve_device(device)
    return DeviceMesh([[dev] * n_index for _ in range(n_data)])


def _on(d: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in d.items()}


def _psum(xs, dev):
    """jax.lax.psum over 'index': the coordinates' tensors summed in index
    order on `dev`."""
    total = xs[0].to(dev)
    for x in xs[1:]:
        total = total + x.to(dev)
    return total


def _all_gather_rows(xs, dev):
    """jax.lax.all_gather over 'index', then swapaxes(0, 1) and reshape to
    (B, -1): each row's blocks side by side, in index order (the order
    _aggregate_rows' sort ties follow)."""
    return torch.cat([x.to(dev) for x in xs], dim=1)


# ----------------------------------------------------------------------
# one data shard, one end
# ----------------------------------------------------------------------

def _end_pipeline(reads, quals, shards, sched, schedule, wraps, cfg,
                  seed_len, read_len, genome_size):
    """One end's sharded candidate and score pipeline over one data
    shard's index coordinates.

    reads, quals: the data shard's (B, L) rows on its lead device;
    shards: the n_idx index-slice states (models/single.py
    index_state_from_numpy), coordinate i on its own device; sched: the
    schedule as a tuple, schedule and wraps as tensors on the lead device.
    Returns (dense, single_out, truncated) on the lead device, with
    `truncated` summed over 'index' and single_out carrying score_overflow
    and n_found summed over 'index' (the JAX function also returns the
    budget, which no caller reads)."""
    lead = reads.device
    n_idx = len(shards)
    big = sg.big_locations(genome_size)
    seeds = []
    scheds = [schedule.to(st["overflow"].device) for st in shards]
    for i, st in enumerate(shards):
        with stats.span(f"seed[{i}]"):
            seeds.append(sg.seed_phase(reads.to(st["overflow"].device),
                                       sched, seed_len, st["overflow"],
                                       genome_size, st,
                                       schedule_t=scheds[i]))
    with stats.span("psum"):
        counts_global = _psum([torch.where(s["found"][:, :, None],
                                           s["counts"], 0) for s in seeds],
                              lead)
    with stats.span("budget"):
        budget = sg.budget_phase(seeds[0]["valid"].to(lead), counts_global,
                                 wraps, cfg)
    cands = []
    for i, (st, s) in enumerate(zip(shards, seeds)):
        dev = st["overflow"].device
        with stats.span(f"expand[{i}]"):
            cands.append(sg.expand_phase(
                s, _on(budget, dev), scheds[i], st["overflow"], cfg,
                seed_len, read_len, cfg.cand_per_read, big=big))
    with stats.span("gather"):
        gathered = {k: _all_gather_rows([c[k] for c in cands], lead)
                    for k in _CAND_KEYS}
    with stats.span("aggregate_rows"):
        u2 = sg._aggregate_rows(gathered, big=big)
    # the scoring work re-split over 'index' by lane slices (the gathered
    # width n_idx * cand_per_read divides by construction)
    W_slice = u2["dir"].shape[1] // n_idx
    slices = []
    for i, st in enumerate(shards):
        dev = st["overflow"].device
        with stats.span(f"score[{i}]"):
            u_slice = {k: v.narrow(1, i * W_slice, W_slice).to(dev)
                       for k, v in u2.items()}
            slices.append(sg.rowwise_score_phase(
                u_slice, reads.to(dev), quals.to(dev), st["genome_p4"],
                st["piece_starts"], cfg, seed_len, read_len, genome_size))
    with stats.span("gather"):
        sc2 = {k: _all_gather_rows([s[k] for s in slices], lead)
               for k in ("score", "logp", "loc_adj", "scored_ok")}
    with stats.span("replay"):
        single_out = sg.rowwise_replay_phase(u2, sc2, budget, reads,
                                             len(sched), cfg)
    single_out["score_overflow"] = _psum(
        [s["score_overflow"] for s in slices], lead)
    single_out["n_found"] = _psum([s["found"].sum(dtype=I32) for s in seeds],
                                  lead)
    with stats.span("dense_topk"):
        dense = sg.dense_topk_rowwise(u2, sc2, cfg.cand_per_read)
    truncated = _psum([c["truncated"] for c in cands], lead)
    return dense, single_out, truncated


# ----------------------------------------------------------------------
# the aligners
# ----------------------------------------------------------------------

class _ShardedBase:
    """The index slices on the mesh, and the batch split over 'data'."""

    def __init__(self, index: GenomeIndex | DeviceIndex, mesh: DeviceMesh):
        self.index = index
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.n_idx = mesh.shape["index"]
        self.device = mesh.devices[0, 0]
        self.genome_size = index.genome_size
        self._use_cuckoo = _use_cuckoo_lookup()
        if isinstance(index, DeviceIndex):
            # built on the device in slices (hash_index.py
            # build_index_device): its own partition, which has no cuckoo
            # layout
            if self._use_cuckoo:
                raise ValueError("a DeviceIndex serves the probe-chain "
                                 "lookup only (SNAP_TPU_LOOKUP=probe)")
            parts = index.parts
            if len(parts["ht_entries"]) != self.n_idx:
                raise ValueError(
                    f"a device index in {len(parts['ht_entries'])} slices "
                    f"on a mesh of {self.n_idx} index coordinates")
        else:
            parts = partition_index(index, self.n_idx, self._use_cuckoo)
        tables = _TABLE_KEYS[self._use_cuckoo]
        p4 = genome_words(index.genome)
        pieces = index.genome.piece_offsets.astype(np.int32)
        # the replicated tensors once per distinct device, each index slice
        # once per distinct device that holds one of its coordinates
        shared = {dev: (sg.tensor_on(p4, dev),
                        torch.from_numpy(pieces).to(dev))
                  for dev in set(mesh.devices.ravel())}
        placed = {}
        for i in range(self.n_idx):
            for dev in set(mesh.devices[:, i]):
                arrays = dict(overflow=parts["overflow"][i],
                              genome_p4=shared[dev][0],
                              piece_starts=shared[dev][1],
                              genome_size=self.genome_size)
                arrays.update({k: parts[k][i] for k in tables})
                placed[i, dev] = sg.index_state_from_numpy(
                    arrays, arrays if self._use_cuckoo else None, dev)
        # _shards[d][i]: the state of coordinate (d, i)
        self._shards = [[placed[i, mesh.devices[d, i]]
                         for i in range(self.n_idx)]
                        for d in range(self.n_data)]

    def _split(self, *arrays):
        """(B, L) tensors -> per data shard, each on its lead device."""
        B, L = arrays[0].shape
        if B % self.n_data:
            raise ValueError("batch must divide the data axis")
        Bl = B // self.n_data
        return [[a[d * Bl:(d + 1) * Bl].to(self.mesh.devices[d, 0])
                 for a in arrays] for d in range(self.n_data)], L

    def _schedule(self, L, max_slots):
        positions, wraps = seed_position_schedule_cached(
            L, self.index.seed_len, max_slots)
        return tuple(int(p) for p in positions), np.asarray(wraps, np.int32)

    def _join(self, outs: list) -> dict:
        """Per data shard outputs concatenated on coordinate (0, 0)'s
        device."""
        return {k: torch.cat([o[k].to(self.device) for o in outs])
                for k in outs[0]}

    def align_batch(self, *arrays) -> dict:
        """numpy (B, L) uint8 codes and ASCII qualities in, a dict of numpy
        arrays out (models/single.py fetch)."""
        return sg.fetch(self.align_batch_device(
            *(torch.from_numpy(np.asarray(a)) for a in arrays)))


class ShardedSingleAligner(_ShardedBase):
    """Single-end aligner over a ('data', 'index') mesh, with
    SingleAligner's surface: align_batch_device (tensors in, tensors on
    self.device out) and align_batch (numpy)."""

    def __init__(self, index: GenomeIndex, mesh: DeviceMesh,
                 config: sg.SingleAlignerConfig | None = None, **overrides):
        cfg = config or sg.SingleAlignerConfig(seed_len=index.seed_len)
        if overrides:
            cfg = sg.SingleAlignerConfig(**{**cfg.__dict__, **overrides})
        self.cfg = cfg
        super().__init__(index, mesh)

    def align_batch_device(self, reads: torch.Tensor,
                           quals: torch.Tensor) -> dict:
        parts, L = self._split(reads, quals)
        sched, wraps = self._schedule(L, self.cfg.max_seed_slots)
        cfg = self.cfg.resolve_for_read_len(L)
        outs = []
        for (reads_l, quals_l), shards in zip(parts, self._shards):
            lead = reads_l.device
            B = reads_l.shape[0]
            _dense, out, trunc = _end_pipeline(
                reads_l, quals_l, shards, sched,
                sg.schedule_on(sched, lead), sg.schedule_on(wraps, lead), cfg,
                self.index.seed_len, L, self.genome_size)
            out["truncated"] = trunc
            sg.count_batch(B, [trunc], batches=None)
            # scalar stats as per-read vectors, as the JAX mesh's
            # P('data') outputs carry them
            out["n_lookups"] = out.pop("n_found").expand(B).contiguous()
            out["score_overflow_vec"] = out.pop(
                "score_overflow").expand(B).contiguous()
            outs.append(out)
        stats.count("mesh.batches")
        return self._join(outs)


class ShardedPairedAligner(_ShardedBase):
    """Paired-end aligner over the same mesh.  Both ends run the sharded
    single-end pipeline; the mate rescue and the dense pair join
    (models/paired.py) run once per data shard."""

    def __init__(self, index: GenomeIndex, mesh: DeviceMesh, config=None,
                 **overrides):
        from ..models.paired import PairedAlignerConfig
        cfg = config or PairedAlignerConfig(seed_len=index.seed_len)
        if overrides:
            cfg = PairedAlignerConfig(**{**cfg.__dict__, **overrides})
        self.cfg = cfg
        super().__init__(index, mesh)

    @stats.timed("mesh.paired", batch=True)
    def align_batch_device(self, reads0, quals0, reads1, quals1) -> dict:
        parts, L = self._split(reads0, quals0, reads1, quals1)
        sched, wraps = self._schedule(L, self.cfg.max_seed_slots)
        outs = [self._data_shard(p, shards, sched, wraps, L)
                for p, shards in zip(parts, self._shards)]
        stats.count("mesh.batches")
        return self._join(outs)

    def _data_shard(self, part, shards, sched, wraps, L):
        from ..models.paired import (MAPQ_LIMIT_FOR_SINGLE_HIT,
                                     MULTIPLE_HITS, NOT_FOUND, SINGLE_HIT,
                                     _append_dense, _mate_rescue_end,
                                     pair_phase)
        cfg = self.cfg
        ecfg = cfg.end_config()
        reads0, quals0, reads1, quals1 = part
        lead = reads0.device
        B = reads0.shape[0]
        schedule = sg.schedule_on(sched, lead)
        wraps_t = sg.schedule_on(wraps, lead)
        ends = []
        for reads_l, quals_l in ((reads0, quals0), (reads1, quals1)):
            dense, single_out, trunc = _end_pipeline(
                reads_l, quals_l, shards, sched, schedule, wraps_t, ecfg,
                self.index.seed_len, L, self.genome_size)
            ends.append(dict(dense=dense, single=single_out,
                             popular=single_out["popular"], truncated=trunc))

        if cfg.mate_rescue and cfg.rescue_mates > 0:
            # on the lead coordinate's replicated genome; both rescues read
            # the pre-append mate dense sets.  The qualities go in as log
            # probabilities, as the single-card engine passes them (the
            # JAX mesh passes the raw bytes; LV converts them to the same
            # values)
            lead_st = shards[0]
            rrs = []
            for e, (reads_l, quals_l) in enumerate(((reads0, quals0),
                                                    (reads1, quals1))):
                with stats.span("mate_rescue"):
                    rrs.append(_mate_rescue_end(
                        ends[e]["dense"], ends[1 - e]["dense"], reads_l,
                        quals_l, lead_st["genome_p4"],
                        lead_st["piece_starts"], ecfg, cfg, L,
                        self.genome_size, B, qlp_e=phred_log_prob_device(
                            torch.stack([quals_l, quals_l.flip(1)], dim=1))))
            for e in (0, 1):
                ends[e]["dense"] = _append_dense(ends[e]["dense"], rrs[e])

        with stats.span("pair_join"):
            pr = pair_phase(ends[0]["dense"], ends[1]["dense"], cfg,
                            ends[0]["popular"], ends[1]["popular"])
        out = dict(pair_found=pr["pair_found"], pair_score=pr["score"],
                   pair_mapq=pr["mapq"], pair_log_pall=pr["log_pall"])
        rows = torch.arange(B, device=lead)
        pf = pr["pair_found"]
        for e in (0, 1):
            d = ends[e]["dense"]
            s = ends[e]["single"]
            wsel = pr["w0"] if e == 0 else pr["w1"]
            e_mapq = pr[f"mapq{e}"]
            mapq = torch.where(pf, e_mapq, s["mapq"])
            out[f"result{e}"] = torch.where(
                pf,
                torch.where(e_mapq >= MAPQ_LIMIT_FOR_SINGLE_HIT,
                            SINGLE_HIT, MULTIPLE_HITS).to(I32),
                s["result"])
            out[f"loc{e}"] = torch.where(pf, d["loc"][rows, wsel], s["loc"])
            out[f"dir{e}"] = torch.where(pf, d["dir"][rows, wsel],
                                         s["direction"])
            out[f"score{e}"] = torch.where(pf, d["score"][rows, wsel],
                                           s["score"])
            out[f"mapq{e}"] = torch.where(pf | (s["result"] != NOT_FOUND),
                                          mapq, 0).to(I32)
            out[f"truncated{e}"] = ends[e]["truncated"]
        sg.count_batch(2 * B, [end["truncated"] for end in ends],
                       batches=None)
        return out
