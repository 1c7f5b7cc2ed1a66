"""The card's idle inside the traced window's calls while ``dispatch`` was
the innermost stage span of the program open on the calling thread (a
chunk's kernels, and the copy of its answers, enqueued), over the calls,
in ms (``stages.py``). Nothing when the trace holds no entry span of the
program."""

from knnbench import stages

stages.install()


def read(r):
    return stages.per_call_ms(r, "dispatch")
