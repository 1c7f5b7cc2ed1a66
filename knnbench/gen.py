"""Inputs from the seed: the train rows, their labels and the query pool.

One ``torch.Generator`` on the run's device, seeded with ``--seed``, draws
in a fixed order, in a few large calls: the train features, the train
labels, then the pool. The same seed on the same kind of device gives the
same arrays. The program takes host ``Dataset``s, so the arrays are handed
over as numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _features(g, rows: int, config: dict, device) -> torch.Tensor:
    """float32 rows of integers drawn in ``[value_min, value_max]``, each
    divided by ``value_scale``."""
    v = torch.randint(config["value_min"], config["value_max"] + 1,
                      (rows, config["dim"]), generator=g, device=device,
                      dtype=torch.float32)
    return v.div_(config["value_scale"])


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """``train_x [N, d]`` float32, ``train_y [N]`` int32 and ``pool [P, d]``
    float32 queries, as numpy arrays."""
    device = torch.device(device)
    g = generator(seed, device)
    train_x = _features(g, config["train_rows"], config, device)
    train_y = torch.randint(0, config["classes"], (config["train_rows"],),
                            generator=g, device=device, dtype=torch.int32)
    pool = _features(g, pool_rows(traffic), config, device)
    out = {"train_x": train_x.cpu().numpy(), "train_y": train_y.cpu().numpy(),
           "pool": pool.cpu().numpy()}
    # The program's fit starts on an empty card: the draw's blocks go back
    # from the caching allocator.
    del train_x, train_y, pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def pool_rows(traffic: dict) -> int:
    """The pool's rows: whole calls only."""
    q = traffic["queries_per_call"]
    return max(1, traffic["pool_queries"] // q) * q


def call_rows(traffic: dict, call: int) -> slice:
    """The pool rows of the ``call``-th call: the pool's calls in turn, so
    no call repeats the one before it while the pool holds two or more."""
    q = traffic["queries_per_call"]
    s = (call % (pool_rows(traffic) // q)) * q
    return slice(s, s + q)


def check_sample(seed: int, answered: int, size: int) -> np.ndarray:
    """Which of the ``answered`` queries of a window (numbered in the
    order they were sent) the comparison reads: ``size`` of them, drawn
    from the seed without replacement, sorted."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    size = min(size, answered)
    return np.sort(rng.choice(answered, size=size, replace=False))
