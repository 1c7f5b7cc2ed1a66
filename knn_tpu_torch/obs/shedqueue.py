"""The bounded shed-on-overload sample queue + background consumer — the
never-block-the-producer primitive the answer-quality and workload layers
ride (the port's copy of ``knn_tpu/obs/shedqueue.py``):
:mod:`knn_tpu_torch.obs.quality` shadow samples,
:mod:`knn_tpu_torch.obs.drift` query rows and
:mod:`knn_tpu_torch.obs.workload` capture records. One implementation so
the contract lives — and is tested — in one place.

Contract:

- :meth:`offer` runs on the SERVING worker thread and is O(1): one
  seeded RNG draw plus one append under a lock whose every critical
  section is O(1). A full queue **sheds** the sample (``on_shed`` counts
  it) and returns immediately — the producer never blocks, whatever the
  consumer is doing.
- the consumer daemon thread calls ``consume(sample)`` per queued item
  and absorbs every exception (``on_error`` counts those): a scoring bug
  must never kill serving or wedge the queue.
- ``autostart=False`` holds the consumer off so tests can pin the
  shed/queue mechanics deterministically; :meth:`start` arms it later.

- ``defer`` — an optional zero-arg gate the control plane's brownout
  installs (:mod:`knn_tpu_torch.control.brownout`): while it returns
  True an offer that wins its draw is counted shed and never queued, so
  background scoring schedules into measured headroom. None (the
  default, and always without the control plane) costs one predicate.

Nothing here touches the card: the consumers are host work beside the
serving worker, and launch no kernel.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Optional


class ShedQueue:
    """See the module docstring. ``rate`` is the per-offer sampling
    probability (the OWNING layer decides whether rate 0 is legal —
    here it simply never enqueues); ``make()`` passed to :meth:`offer`
    builds the sample lazily, only after the draw and the cap admit it.
    """

    def __init__(self, *, rate: float, queue_cap: int,
                 consume: Callable, thread_name: str, seed: int = 0,
                 on_shed: Optional[Callable] = None,
                 on_error: Optional[Callable] = None,
                 autostart: bool = True):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        if queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        self.rate = float(rate)
        self.queue_cap = int(queue_cap)
        self.thread_name = thread_name
        self._consume = consume
        self._on_shed = on_shed
        self._on_error = on_error
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._wake = threading.Event()
        self._closed = False
        self._in_flight = False
        self.shed = 0
        self.defer: Optional[Callable[[], bool]] = None
        self._worker: Optional[threading.Thread] = None
        if autostart:
            self.start()

    def start(self) -> None:
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run, name=self.thread_name, daemon=True)
            self._worker.start()

    # -- producer side (the serving worker thread) -------------------------

    def offer(self, make: Callable) -> bool:
        """Sample one item; O(1), never blocks. Returns whether it was
        queued."""
        with self._lock:
            if self._closed or self._rng.random() >= self.rate:
                return False
            if self.defer is not None and self.defer():
                # Headroom-negative deferral: the draw was consumed like an
                # admitted one (the RNG stream stays JAX's), the sample is
                # counted shed.
                self.shed += 1
                if self._on_shed is not None:
                    self._on_shed()
                return False
            if len(self._queue) >= self.queue_cap:
                self.shed += 1
                if self._on_shed is not None:
                    self._on_shed()
                return False
            self._queue.append(make())
        self._wake.set()
        return True

    # -- consumer side -----------------------------------------------------

    def _run(self) -> None:
        while True:
            self._wake.wait(0.2)
            while True:
                with self._lock:
                    if not self._queue:
                        self._wake.clear()
                        if self._closed:
                            return
                        break
                    sample = self._queue.popleft()
                    self._in_flight = True
                try:
                    self._consume(sample)
                except Exception:  # noqa: BLE001 — must never kill the queue
                    if self._on_error is not None:
                        try:
                            self._on_error()
                        except Exception:  # noqa: BLE001
                            pass
                finally:
                    with self._lock:
                        self._in_flight = False

    # -- lifecycle / read side ---------------------------------------------

    def depth(self) -> int:
        """Samples queued OR currently being consumed — a poller that
        waits for depth 0 is guaranteed the consumer's stats include every
        earlier offer."""
        with self._lock:
            return len(self._queue) + (1 if self._in_flight else 0)

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued sample has been fully CONSUMED —
        empty queue and no sample in flight, so stats read after a
        successful drain are complete (tests, ``chip_smoke.py``); the
        serving path never calls this."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue and not self._in_flight:
                    return True
            time.sleep(0.005)
        return False

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._wake.set()
        if self._worker is not None:
            self._worker.join(timeout=5)
