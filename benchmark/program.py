"""The system under test: snap_rnaseq_tpu_torch's index build and aligners,
set up as a configuration states and driven at its entry point.  The only
module of the benchmark that imports the program (besides the metric
readers' kernel hooks in trace.py).

entry                  what the window calls
"paired"               PairedAligner.align_batch_device on the index's
                       host tables (cuckoo lookup)
"single"               SingleAligner.align_batch_device on the paired
                       aligner's device copy of the index
"sharded_paired"       ShardedPairedAligner.align_batch_device on a
                       (1, n_slices) mesh whose coordinates are all one
                       card, over the device index's own slices (probe-
                       chain lookup)
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

# per-read result rows the window copies to the host, as the pipeline
# fetches them before it writes
PAIR_KEYS = ("pair_found", "pair_score", "result0", "loc0", "dir0",
             "score0", "mapq0", "result1", "loc1", "dir1", "score1", "mapq1")
SINGLE_KEYS = ("result", "loc", "direction", "score", "mapq")
SINGLE_OPTIONS = ("max_dist", "num_seeds", "max_hits",
                  "extra_search_depth", "cand_per_read", "max_seed_slots")
PAIRED_OPTIONS = SINGLE_OPTIONS + ("min_spacing", "max_spacing")


def port_genome(genome):
    from snap_rnaseq_tpu_torch.index.genome import Genome
    return Genome(codes=genome.codes, piece_names=genome.names,
                  piece_offsets=genome.piece_offsets,
                  padding=genome.padding)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class System:
    """Builds the index on `device` and the aligner the configuration
    names; times each part (self.parts, seconds)."""

    def __init__(self, genome, config: dict, traffic: dict, device):
        from snap_rnaseq_tpu_torch.index.hash_index import build_index_device
        self.device = torch.device(device)
        self.config, self.traffic = config, traffic
        self.parts = {}
        idx = config["index"]
        g = port_genome(genome)
        t0 = time.perf_counter()
        sync(self.device)
        di = build_index_device(g, int(idx["seed_len"]),
                                float(idx["load_factor"]), self.device,
                                n_index=idx.get("slices"))
        sync(self.device)
        self.parts["index_build_s"] = time.perf_counter() - t0
        self.n_slices = len(di.parts["ht_entries"])
        entry = config["entry"][traffic["mode"]]
        t0 = time.perf_counter()
        self.aligner = self._aligner(entry, di, g)
        sync(self.device)
        self.parts["aligner_s"] = time.perf_counter() - t0
        self.paired = traffic["mode"] == "paired"

    def _aligner(self, entry, di, g):
        """The entry's aligner, built with the configuration's seed lookup
        (the port reads SNAP_TPU_LOOKUP when an aligner is built)."""
        opts = dict(self.traffic["aligner"],
                    cand_per_read=int(self.config["cand_per_read"]))
        saved = os.environ.get("SNAP_TPU_LOOKUP")
        os.environ["SNAP_TPU_LOOKUP"] = self.config["index"]["lookup"]
        try:
            return self._build(entry, di, g, opts)
        finally:
            if saved is None:
                del os.environ["SNAP_TPU_LOOKUP"]
            else:
                os.environ["SNAP_TPU_LOOKUP"] = saved

    def _build(self, entry, di, g, opts):
        if entry == "sharded_paired":
            from snap_rnaseq_tpu_torch.ops.genome_gather import \
                pack_genome_4bit_torch
            from snap_rnaseq_tpu_torch.parallel.sharded import (
                ShardedPairedAligner, make_mesh)
            mesh = make_mesh(1, self.n_slices, device=self.device)
            di.genome.packed_4bit = pack_genome_4bit_torch(
                torch.from_numpy(g.codes).to(self.device))
            return ShardedPairedAligner(di, mesh,
                                        **_options(opts, PAIRED_OPTIONS))
        from snap_rnaseq_tpu_torch.models.paired import PairedAligner
        base = PairedAligner(di.genome_index(), device=self.device,
                             **_options(opts, PAIRED_OPTIONS))
        if entry == "paired":
            return base
        if entry == "single":
            from snap_rnaseq_tpu_torch.models.single import (
                SingleAligner, SingleAlignerConfig)
            s = object.__new__(SingleAligner)
            s.index, s.device = base.index, base.device
            s.state, s.genome_size = base.state, base.genome_size
            s.cfg = SingleAlignerConfig(seed_len=base.index.seed_len,
                                        **_options(opts, SINGLE_OPTIONS))
            return s
        raise ValueError(f"unknown entry {entry!r}")

    def step(self, batch):
        """One batch (device tensors: reads and qualities per end) through
        the entry; returns the result rows as one int32 device tensor
        (keys, n)."""
        if self.paired:
            r0, q0, r1, q1 = batch
            out = self.aligner.align_batch_device(r0, q0, r1, q1)
            keys = PAIR_KEYS
        else:
            r0, q0 = batch
            out = self.aligner.align_batch_device(r0, q0)
            keys = SINGLE_KEYS
        return torch.stack([out[k].to(torch.int32) for k in keys])

    def free(self) -> None:
        self.aligner = None


def _options(o: dict, keys: tuple) -> dict:
    """The aligner config's fields among a mix's options (max_dist is
    the config's max_k)."""
    out = {k: v for k, v in o.items() if k in keys}
    out["max_k"] = out.pop("max_dist")
    return out


def rows_to_dict(rows: np.ndarray, paired: bool) -> dict:
    """The host copy of a batch's result rows -> per-field arrays, with
    locations as uint32 values in int64 (0xFFFFFFFF unaligned)."""
    keys = PAIR_KEYS if paired else SINGLE_KEYS
    out = {}
    for k, v in zip(keys, rows):
        v = v.astype(np.int64)
        if k.startswith("loc"):
            v = v & 0xFFFFFFFF
        out["dir" if k == "direction" else k] = v
    return out
