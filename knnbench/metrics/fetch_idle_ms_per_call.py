"""The card's idle inside the traced window's calls while ``fetch`` was
the innermost stage span of the program open on the calling thread (the
answers waited for, copied out of pinned memory and joined), over the
calls, in ms (``stages.py``). Nothing when the trace holds no entry span
of the program."""

from knnbench import stages

stages.install()


def read(r):
    return stages.per_call_ms(r, "fetch")
