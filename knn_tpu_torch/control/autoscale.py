"""Fleet autoscaling policy: grow before any replica has to degrade (the
port's copy of ``knn_tpu/control/autoscale.py``; its caller, the fleet
router, is not ported yet).

Scale is the FIRST rung of the degradation order (docs/RESILIENCE.md):
booting a replica costs money; shedding a request costs a user. The
router already measures both sides of the decision — its own forwarded
request rate (offered load on the fleet) and, from each replica's
``/healthz`` capacity block, the per-replica modeled ``sustainable_qps``
(:mod:`knn_tpu_torch.obs.capacity`, summed here into fleet capacity).

This module is the POLICY only — a pure, clock-injectable decision
function the router polls (:class:`AutoscalePolicy.decide`) plus the
scale-command runner. The MECHANISM is the operator's ``--scale-cmd``
script (invoked ``<cmd> up <url>`` / ``<cmd> down <url>``), which
starts or stops the serve process behind an already-registered replica
slot; the router's replica registry is the scale bound (``--scale-min``
/ ``--scale-max`` clamp how many slots the policy keeps populated), and
the snapshot-bootstrap path does the data plane — a replica the
scale command boots blank is seeded from the primary's current
generation by the router's auto-bootstrap, under live traffic.

Hysteresis: scale UP when offered load exceeds ``up_fraction`` of fleet
sustainable QPS (default 0.8 — grow BEFORE the knee, while there is
still headroom to serve the boot); scale DOWN when offered load would
still fit under ``down_fraction`` (default 0.4) of the fleet MINUS the
candidate replica; a shared cooldown separates any two actions, so a
boot's warmup transient cannot trigger the next decision.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional

from knn_tpu_torch.control.admission import _env_float

#: Seconds between any two scale actions (--scale-cooldown-s) — long
#: enough for a booted replica's bootstrap + warmup to register in the
#: fleet capacity sum.
DEFAULT_COOLDOWN_S = 60.0

#: Hysteresis band defaults, env-overridable (read at construction, the
#: control-plane knob idiom).
_UP_ENV = "KNN_TPU_SCALE_UP_FRACTION"
_DOWN_ENV = "KNN_TPU_SCALE_DOWN_FRACTION"


class AutoscalePolicy:
    """Pure scale-up/down decision over (offered, sustainable, usable).

    ``scale_min``/``scale_max`` — bounds on populated replica slots;
    ``clock`` — injectable monotonic-seconds callable for tests.
    """

    def __init__(self, scale_min: int, scale_max: int, *,
                 up_fraction: Optional[float] = None,
                 down_fraction: Optional[float] = None,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 clock: Optional[Callable[[], float]] = None):
        if up_fraction is None:
            up_fraction = _env_float(_UP_ENV, 0.8)
        if down_fraction is None:
            down_fraction = _env_float(_DOWN_ENV, 0.4)
        if scale_min < 1:
            raise ValueError(f"scale_min must be >= 1, got {scale_min}")
        if scale_max < scale_min:
            raise ValueError(
                f"scale_max ({scale_max}) must be >= scale_min "
                f"({scale_min})")
        if not 0.0 < down_fraction < up_fraction <= 1.0:
            raise ValueError(
                f"need 0 < down_fraction ({down_fraction}) < up_fraction "
                f"({up_fraction}) <= 1 or the policy would thrash")
        self.scale_min = int(scale_min)
        self.scale_max = int(scale_max)
        self.up_fraction = float(up_fraction)
        self.down_fraction = float(down_fraction)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock if clock is not None else time.monotonic
        self._last_action_s = float("-inf")
        self.decisions = {"up": 0, "down": 0}

    def decide(self, offered_qps: float, sustainable_qps: Optional[float],
               usable: int) -> Optional[str]:
        """``"up"`` / ``"down"`` / None. ``offered_qps`` — the router's
        measured forwarded rate; ``sustainable_qps`` — the fleet sum of
        usable replicas' modeled capacity (None until any replica has a
        dispatch model — no model, no action); ``usable`` — replicas
        currently serving."""
        now = self.clock()
        if (now - self._last_action_s) < self.cooldown_s:
            return None
        if sustainable_qps is None or sustainable_qps <= 0 or usable < 1:
            return None
        if (usable < self.scale_max
                and offered_qps > self.up_fraction * sustainable_qps):
            self._last_action_s = now
            self.decisions["up"] += 1
            return "up"
        per_replica = sustainable_qps / usable
        remaining = sustainable_qps - per_replica
        if (usable > self.scale_min and remaining > 0
                and offered_qps < self.down_fraction * remaining):
            self._last_action_s = now
            self.decisions["down"] += 1
            return "down"
        return None

    def export(self) -> dict:
        return {
            "scale_min": self.scale_min,
            "scale_max": self.scale_max,
            "up_fraction": self.up_fraction,
            "down_fraction": self.down_fraction,
            "cooldown_s": self.cooldown_s,
            "decisions": dict(self.decisions),
        }


def run_scale_cmd(scale_cmd: str, direction: str, url: str,
                  timeout_s: float = 300.0) -> None:
    """Invoke the operator's scale command: ``<cmd> up|down <url>``.

    The command is a shell line (like CI's hook scripts) so operators can
    point at anything from a local launcher script to a cloud API call;
    the target slot URL rides argv, not interpolation. Non-zero exit or
    timeout raises — the router audits the failure and retries after its
    cooldown."""
    subprocess.run(
        [*scale_cmd.split(), direction, url],
        check=True, timeout=timeout_s,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
