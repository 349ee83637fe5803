"""The system under test: snap_rnaseq_tpu_torch's index build and the
entry a configuration names for the traffic's mode
(benchmark/entries/<entry>.py), set up as the configuration states and
driven at its entry point.  With the entries, the only modules of the
benchmark that import the program (besides the metric readers' kernel
hooks in trace.py).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import lookup


def port_genome(genome):
    from snap_rnaseq_tpu_torch.index.genome import Genome
    return Genome(codes=genome.codes, piece_names=genome.names,
                  piece_offsets=genome.piece_offsets,
                  padding=genome.padding)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class System:
    """Builds the index on `device` and the aligner of the configuration's
    entry; times each part (self.parts, seconds)."""

    def __init__(self, genome, extras: dict, config: dict, traffic: dict,
                 device):
        from snap_rnaseq_tpu_torch.index.hash_index import build_index_device
        self.device = torch.device(device)
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
        entry = lookup.entry(config, traffic)
        t0 = time.perf_counter()
        self.aligner, self.keys, self.n_slices = entry.build(
            di, g, extras, config, traffic, self.device)
        sync(self.device)
        self.parts["aligner_s"] = time.perf_counter() - t0

    def step(self, batch):
        """One batch (device tensors: reads and qualities per end) through
        the entry; returns the result rows as one int32 device tensor
        (keys, n)."""
        out = self.aligner.align_batch_device(*batch)
        return torch.stack([out[k].to(torch.int32) for k in self.keys])

    def free(self) -> None:
        self.aligner = None


def rows_to_dict(rows: np.ndarray, keys: tuple) -> dict:
    """The host copy of a batch's result rows -> per-field arrays, with
    locations as uint32 values in int64 (0xFFFFFFFF unaligned)."""
    out = {}
    for k, v in zip(keys, rows):
        v = v.astype(np.int64)
        if k.startswith("loc"):
            v = v & 0xFFFFFFFF
        out["dir" if k == "direction" else k] = v
    return out
