"""The card's idle inside the traced window's calls while an entry span of
the program (``kneighbors``, ``predict``, ``distance``) was open on the
calling thread and none of its stages (``prepare``, ``dispatch``,
``fetch``): validation, routing and the glue between the stages, over the
calls, in ms (``stages.py``). Nothing when the trace holds no entry span."""

from knnbench import stages

stages.install()


def read(r):
    return stages.per_call_ms(r, stages.ENTRY)
