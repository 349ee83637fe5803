"""Entries: what the window calls, one file for each name a
configuration's `entry` gives a traffic mode.

    build(index, genome, extras, config, traffic, device)
        -> (aligner, keys, n_slices)

`index` is the configuration's genome index as built on the card
(`build_index_device`), `genome` the port's Genome it was built from,
`extras` the configuration's extra inputs by kind.  The window calls
`aligner.align_batch_device(*batch)` on a batch's device tensors (reads
and qualities, end by end) and stacks the returned rows named by `keys`
into one int32 tensor; `n_slices` is the number of index slices.
"""
