"""Entry "sharded_paired": ShardedPairedAligner.align_batch_device on a
(1, n_slices) mesh whose coordinates are all one card, over the device
index's own slices (probe-chain lookup)."""
from __future__ import annotations

import torch

from .paired import PAIR_KEYS, PAIRED_OPTIONS, options, seed_lookup


def build(index, genome, extras, config, traffic, device):
    from snap_rnaseq_tpu_torch.ops.genome_gather import \
        pack_genome_4bit_torch
    from snap_rnaseq_tpu_torch.parallel.sharded import (
        ShardedPairedAligner, make_mesh)
    n_slices = len(index.parts["ht_entries"])
    with seed_lookup(config):
        mesh = make_mesh(1, n_slices, device=device)
        index.genome.packed_4bit = pack_genome_4bit_torch(
            torch.from_numpy(genome.codes).to(device))
        aligner = ShardedPairedAligner(index, mesh,
                                       **options(config, traffic,
                                                 PAIRED_OPTIONS))
    return aligner, PAIR_KEYS, n_slices
