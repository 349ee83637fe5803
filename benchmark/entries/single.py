"""Entry "single": SingleAligner.align_batch_device on the paired
aligner's device copy of the index."""
from __future__ import annotations

from .paired import SINGLE_OPTIONS, options, paired_aligner, seed_lookup

SINGLE_KEYS = ("result", "loc", "direction", "score", "mapq")


def build(index, genome, extras, config, traffic, device):
    from snap_rnaseq_tpu_torch.models.single import (SingleAligner,
                                                     SingleAlignerConfig)
    with seed_lookup(config):
        base = paired_aligner(index, config, traffic, device)
        s = object.__new__(SingleAligner)
        s.index, s.device = base.index, base.device
        s.state, s.genome_size = base.state, base.genome_size
        s.cfg = SingleAlignerConfig(seed_len=base.index.seed_len,
                                    **options(config, traffic,
                                              SINGLE_OPTIONS))
    return s, SINGLE_KEYS, len(index.parts["ht_entries"])
