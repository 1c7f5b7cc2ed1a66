"""Process start to the first timed call (host clock): the inputs made from
the seed, the program fitted, its one shape warmed; in a checkout's first
run also the build of the program's CUDA sources."""


def read(r):
    return r.setup_s
