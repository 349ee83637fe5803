"""Read sources, one file for each `source` a traffic mix names
("genome" when it names none).

    make_batch(genome, extras, traffic, n_frag, rng)
        -> benchmark.gen.reads.Batch

n_frag fragments (pairs, or single reads) drawn from `rng` alone, so that
one seed gives one pool; `true_loc` is the genome offset of each read's
first aligned base.
"""
