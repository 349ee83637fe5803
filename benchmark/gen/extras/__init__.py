"""Extra inputs of a configuration beyond its genome (an annotation, a
second index's sequences), one file for each `kind` in the
configuration's `extras` list.

    make(genome, spec) -> object

made from the seed the spec states.  The harness hands the results, by
kind, to the entry, the read source and the reference; the set-up log
times each as `<kind>_s`.
"""
