"""assemble_s: seconds of the system's constructor (the recipe's assembly on the
card), ended by a synchronisation: the benchmark's own span in set-up."""


def read(run):
    return run.spans.get("assemble_s")
