"""Plain references, one file for each name a configuration's
`reference` gives ("aligner" when it names none), beside the
comparison (compare.py) and the references' own parts.

    make(genome, extras, config, traffic, device, control=False) -> ref

`ref.align(reads, quals)` (one (n, read_len) array per end) returns the
per-field arrays the comparison judges, over the entry's result keys
("direction" as "dir"); `control` is the same reference in the nearest
precision below the one the configuration states.  A reference imports
nothing of the program.

    numbers(got, want, paired) -> {name: value}
    fields(got, want, paired) -> {output: reads that differ}

A reference whose file defines these judges its own outputs by them;
compare.py's judge the others.  Each number is held to the cell's limit
of that name.
"""
