"""Capacity probe: find a live replica's load knee and hold the headroom
model to it. The counterpart of the JAX package's
``scripts/capacity_probe.py``; its steps, constants and band are JAX's.

The capacity layer (``obs/capacity.py``) reports a sustainable-QPS
estimate from its fitted dispatch-cost model; this gate measures the real
knee:

1. **Boot** ``python -m knn_tpu_torch.cli serve --cost-accounting on`` over
   ``--index`` (default, saved by this run: the large fixture on the CPU,
   as in JAX; on the card the xl index, the large fixture's train rows
   tiled 33 times, where a 128-row dispatch costs enough for the knee to
   sit at a rate the client can offer).
2. **Low load** — a trickle of tagged 128-row requests: every 200's
   flight-recorder timeline carries a ``cost`` block with its class and
   device-ms, and ``GET /debug/capacity`` reports a positive
   ``sustainable_qps`` (the estimate under test, read before the ramp
   teaches the model anything about saturation).
3. **Ramp** — open-loop arrivals (fired on a clock, never waiting for
   answers) at rates ×1.5 from 0.15× the estimate, until the knee
   (:func:`knee_reason`): shedding above 5 %, missed fires above 25 %, or
   p99 above max(4× the base p99, the base p99 + 500 ms). The knee is the
   geometric mean of the last clean and the first saturated rate
   (:func:`knee_record`).
   **The knee must be the server's.** A step whose fires collapsed while
   its p50 stayed within 2× the base p50 (:func:`client_limited`) was
   limited by this client's own CPU, not the server: the generator is
   spread over twice the processes and the step is run again (up to
   :data:`MAX_PROCS`); such a step is never taken as the knee.
4. **Verdict** (:func:`verdict`) — the knee within ``[0.2, 3.0]`` × the
   estimate; attribution conserved over the whole run (the per-class
   ``knn_cost_device_ms_total`` sum equals
   ``knn_cost_dispatch_wall_ms_total`` to 1e-6, from ``/debug/capacity``
   and from the Prometheus text); a clean drain on SIGINT.
5. **Single-row requests** (unless ``--no-single-row``) — the traffic
   that admission sheds first. An open-loop single-row trickle at low load
   for the capacity window + 2 s, so the window holds single-row
   dispatches alone; ``/debug/capacity``'s ``sustainable_qps`` then prices
   a single-row mix (the port's headroom model counts each request's front
   end, ``obs/capacity.py``). The same ramp and knee rule from that
   estimate, and the same band.

Exit 0 when every invariant holds; 1 with a diagnosis. The client is
stdlib only; the server runs on the card unless ``--device cpu``.

Usage: ``python -m knn_tpu_torch.gates.capacity_probe [--short] [--index
DIR] [--no-single-row] [--device cuda|cpu] [--json-out FILE]``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import multiprocessing
import os
import queue
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Optional

from knn_tpu_torch.gates import procgroup

REPO = Path(__file__).resolve().parents[2]
READY_RE = re.compile(r"ready on (http://[\d.]+:\d+)")
BOOT_TIMEOUT_S = 180

#: Rows per request == max_batch: each request is one full dispatch, so
#: the knee in requests/s is ~1/w(max_batch).
REQUEST_ROWS = 128
MAX_BATCH = 128

SHED_FRAC_KNEE = 0.05
MISSED_FRAC_KNEE = 0.25
P99_BLOWUP_FACTOR = 4.0
P99_BLOWUP_FLOOR_MS = 500.0
#: A collapsed schedule with a p50 within this factor of the base p50 is
#: the client's limit, not the server's.
CLIENT_LIMIT_P50_FACTOR = 2.0
#: Most generator processes when the client, not the server, limits a
#: step.
MAX_PROCS = 8
#: The single-row trickle's offered rate (requests/s).
TRICKLE_QPS = 50.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="capacity_probe",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--short", action="store_true",
                   help="CI preset: 1.2 s ramp steps")
    p.add_argument("--step-s", type=float, default=None,
                   help="seconds per ramp step (default 1.2 short / 3.0)")
    p.add_argument("--band-lo", type=float, default=0.2,
                   help="lower bound on measured_knee/estimate")
    p.add_argument("--band-hi", type=float, default=3.0,
                   help="upper bound on measured_knee/estimate")
    p.add_argument("--seed", type=int, default=7,
                   help="row-selection seed (deterministic payloads)")
    p.add_argument("--workers", type=int, default=16,
                   help="client worker threads per generator process")
    p.add_argument("--index", default=None, metavar="DIR",
                   help="a saved index to serve (default, saved by this "
                   "run: the large fixture on the CPU, the xl index on the "
                   "card)")
    p.add_argument("--no-single-row", action="store_true",
                   help="stop after the 128-row verdict (no single-row "
                   "trickle and ramp)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--json-out", default=None, metavar="FILE")
    args = p.parse_args(argv)
    if args.step_s is None:
        args.step_s = 1.2 if args.short else 3.0
    return args


def fail(msg: str, proc=None) -> int:
    print(f"capacity-probe: FAIL: {msg}", file=sys.stderr)
    if proc is not None and proc.poll() is None:
        proc.kill()
    return 1


def http(base: str, path: str, payload_bytes=None, headers=None,
         timeout=60):
    req = urllib.request.Request(
        base + path, data=payload_bytes,
        headers={"Content-Type": "application/json", **(headers or {})}
        if payload_bytes is not None else (headers or {}),
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def boot(index: str, env: dict, extra_flags):
    proc = procgroup.popen_group(
        [sys.executable, "-m", "knn_tpu_torch.cli", "serve", index,
         "--port", "0", *extra_flags],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO,
    )
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True,
    ).start()
    deadline = time.monotonic() + BOOT_TIMEOUT_S
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=min(1.0, max(
                0.01, deadline - time.monotonic())))
        except queue.Empty:
            if proc.poll() is not None:
                return proc, None
            continue
        m = READY_RE.search(line)
        if m:
            print(f"capacity-probe: server: {line.rstrip()}")
            return proc, m.group(1)
    return proc, None


# -- the open-loop client -----------------------------------------------------


class OpenLoopClient:
    """Fire requests on a clock, never waiting for answers: a scheduler
    thread enqueues at the target rate, a bounded worker pool executes.
    When the workers fall behind, scheduled fires are counted as
    ``missed`` — saturation evidence, not silently dropped load."""

    def __init__(self, base: str, payloads, workers: int,
                 cls: str = "ramp"):
        self.base = base
        self.payloads = payloads
        self.cls = cls
        self._jobs: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._results: list = []
        self._workers = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(workers)
        ]
        for w in self._workers:
            w.start()
        self.max_backlog = 2 * workers

    def _work(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            t0 = time.monotonic()
            try:
                st, _ = http(self.base, "/predict",
                             self.payloads[job % len(self.payloads)],
                             headers={"x-knn-class": self.cls}, timeout=60)
            except Exception:  # noqa: BLE001 — transport error = saturation
                st = -1
            ms = (time.monotonic() - t0) * 1e3
            with self._lock:
                self._results.append((st, ms))

    def run_raw(self, rate_qps: float, step_s: float):
        """One open-loop step at ``rate_qps`` for ``step_s`` seconds;
        blocks until every fired request completed (so the latencies
        include the queue the step itself built). ``(fired, missed,
        [(status, ms), ...])``."""
        with self._lock:
            self._results.clear()
        fired = missed = 0
        interval = 1.0 / rate_qps
        t_next, t_end = time.monotonic(), time.monotonic() + step_s
        i = 0
        while time.monotonic() < t_end:
            now = time.monotonic()
            if now < t_next:
                time.sleep(min(interval, t_next - now))
                continue
            t_next += interval
            if self._jobs.qsize() > self.max_backlog:
                missed += 1  # the pool is drowning: saturation, counted
            else:
                self._jobs.put(i)
                fired += 1
            i += 1
        drain_deadline = time.monotonic() + 90
        while time.monotonic() < drain_deadline:
            with self._lock:
                done = len(self._results)
            if done >= fired:
                break
            time.sleep(0.05)
        with self._lock:
            return fired, missed, list(self._results)

    def close(self):
        for _ in self._workers:
            self._jobs.put(None)


def summarize(rate_qps: float, fired: int, missed: int, results) -> dict:
    """JAX's step record from one step's raw outcome."""
    lats_ok = sorted(ms for st, ms in results if st == 200)
    n429 = sum(1 for st, _ in results if st == 429)
    nbad = sum(1 for st, _ in results if st not in (200, 429))
    total = max(1, fired + missed)

    def pct(vals, p):
        if not vals:
            return None
        return round(vals[min(len(vals) - 1, int(len(vals) * p / 100))], 1)

    return {
        "rate_qps": round(rate_qps, 2),
        "fired": fired,
        "missed": missed,
        "ok": len(lats_ok),
        "shed_429": n429,
        "other": nbad,
        "shed_frac": round(n429 / max(1, len(results)), 4),
        "missed_frac": round(missed / total, 4),
        "p50_ms": pct(lats_ok, 50),
        "p99_ms": pct(lats_ok, 99),
    }


def _proc_step(base, payloads, workers, rate_qps, step_s):
    """One generator process's share of a step (run in a worker process)."""
    client = OpenLoopClient(base, payloads, workers)
    try:
        return client.run_raw(rate_qps, step_s)
    finally:
        client.close()


def _ready() -> int:
    return os.getpid()


class SpreadClient:
    """The open-loop generator over ``procs`` processes, each offering
    ``rate / procs`` with its own ``workers`` threads: what the probe
    switches to when one process's CPU, not the server, limits a step."""

    def __init__(self, base: str, payloads, workers: int, procs: int):
        self.base, self.payloads, self.workers = base, payloads, workers
        self.procs = procs
        self._pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=procs,
            mp_context=multiprocessing.get_context("spawn"))
        # Start every process before the first timed step.
        pids = {f.result() for f in [self._pool.submit(_ready)
                                     for _ in range(4 * procs)]}
        self.pids = sorted(pids)

    def run_raw(self, rate_qps: float, step_s: float):
        futs = [self._pool.submit(_proc_step, self.base, self.payloads,
                                  self.workers, rate_qps / self.procs,
                                  step_s) for _ in range(self.procs)]
        fired = missed = 0
        results: list = []
        for f in futs:
            fi, mi, ri = f.result()
            fired, missed = fired + fi, missed + mi
            results.extend(ri)
        return fired, missed, results

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)


# -- the knee rule and the verdict (JAX's, factored) --------------------------


def knee_reason(step: dict, base_p99: Optional[float]) -> Optional[str]:
    """Why ``step`` is saturated (``shed``, ``client_schedule_collapse``,
    ``p99_blowup``), or None when it is clean."""
    blowup = (
        base_p99 is not None and step["p99_ms"] is not None
        and step["p99_ms"] > max(P99_BLOWUP_FACTOR * base_p99,
                                 base_p99 + P99_BLOWUP_FLOOR_MS)
    )
    return ("shed" if step["shed_frac"] > SHED_FRAC_KNEE
            else "client_schedule_collapse"
            if step["missed_frac"] > MISSED_FRAC_KNEE
            else "p99_blowup" if blowup else None)


def client_limited(step: dict, reason: Optional[str],
                   base_p50: Optional[float]) -> bool:
    """A collapsed schedule whose p50 stayed within 2× the base p50: the
    client's CPU set the limit, not the server's latency."""
    return (reason == "client_schedule_collapse" and base_p50 is not None
            and step["p50_ms"] is not None
            and step["p50_ms"] <= CLIENT_LIMIT_P50_FACTOR * base_p50)


def knee_record(steps, rate: float, reason: str) -> dict:
    """The knee from the ramp's steps, the last one saturated at ``rate``:
    the geometric mean of the last clean and the first saturated rate."""
    prev = steps[-2]["rate_qps"] if len(steps) > 1 else rate
    return {
        "measured_qps": round(math.sqrt(prev * rate), 2),
        "reason": reason,
        "last_clean_qps": prev,
        "first_saturated_qps": steps[-1]["rate_qps"],
    }


def verdict(knee_qps: float, estimate: float, band_lo: float,
            band_hi: float):
    """``(ratio, within)``: the knee over the estimate, and whether it lies
    in ``[band_lo, band_hi]``."""
    ratio = knee_qps / estimate
    return ratio, band_lo <= ratio <= band_hi


def prom_cost_sums(metrics_text: str):
    """``(sum of knn_cost_device_ms_total samples, the
    knn_cost_dispatch_wall_ms_total sample)`` from the Prometheus text."""
    dev = wall = 0.0
    for line in metrics_text.splitlines():
        if line.startswith("knn_cost_device_ms_total{"):
            dev += float(line.rsplit(" ", 1)[1])
        elif line.startswith("knn_cost_dispatch_wall_ms_total"):
            wall = float(line.rsplit(" ", 1)[1])
    return dev, wall


# -- the probe ----------------------------------------------------------------


def _capacity(base: str) -> dict:
    st, body = http(base, "/debug/capacity")
    if st != 200:
        raise RuntimeError(f"/debug/capacity -> {st}: {body[:200]}")
    return json.loads(body)


def _ramp(base, payloads, args, estimate):
    """The open-loop ramp. ``(steps, knee or None, generator processes,
    the client-limited steps)``."""
    client = OpenLoopClient(base, payloads, args.workers)
    procs = 1
    steps: list = []
    limited_steps: list = []
    base_p50 = base_p99 = None
    rate = max(1.0, estimate * 0.15)
    max_rate = estimate * args.band_hi * 1.5
    try:
        while rate <= max_rate:
            step = summarize(rate, *client.run_raw(rate, args.step_s))
            step["procs"] = procs
            if base_p99 is None and step["p99_ms"] is not None:
                base_p50, base_p99 = step["p50_ms"], step["p99_ms"]
            reason = knee_reason(step, base_p99)
            limited = client_limited(step, reason, base_p50)
            print(f"capacity-probe: step {step['rate_qps']:>7.2f} q/s "
                  f"({procs} proc): ok {step['ok']}, shed "
                  f"{step['shed_429']}, missed {step['missed']}, p50 "
                  f"{step['p50_ms']} ms, p99 {step['p99_ms']} ms"
                  + (" -> CLIENT-LIMITED" if limited else
                     f" -> KNEE ({reason})" if reason else ""))
            if limited:
                limited_steps.append(step)
                if procs * 2 > MAX_PROCS:
                    return steps, None, procs, limited_steps
                client.close()
                procs *= 2
                client = SpreadClient(base, payloads, args.workers, procs)
                print(f"capacity-probe: the client limited the step; "
                      f"generator spread over {procs} processes "
                      f"{client.pids}; step re-run")
                continue  # the same rate again; the step is not the knee
            steps.append(step)
            if reason:
                return (steps, knee_record(steps, rate, reason), procs,
                        limited_steps)
            rate *= 1.5
    finally:
        client.close()
    return steps, None, procs, limited_steps


def _trickle(base, payloads, step_s: float) -> "tuple[dict, dict]":
    """An open-loop single-row trickle at TRICKLE_QPS for ``step_s``
    seconds, then ``/debug/capacity``'s capacity block: ``(the trickle's
    step record, the block)``."""
    client = OpenLoopClient(base, payloads, 4, cls="trickle")
    try:
        step = summarize(TRICKLE_QPS, *client.run_raw(TRICKLE_QPS, step_s))
    finally:
        client.close()
    return step, _capacity(base)["capacity"]


def _no_knee(estimate: float, procs: int, limited, band_hi: float) -> str:
    """The diagnosis of a ramp that ended without a knee."""
    if limited and limited[-1]["procs"] == procs:
        return (f"the client, not the server, limited the ramp at "
                f"{limited[-1]['rate_qps']} q/s with {procs} generator "
                f"processes (MAX_PROCS {MAX_PROCS})")
    return (f"no knee found up to {estimate * band_hi * 1.5:.1f} q/s "
            f"({band_hi}x the {estimate:.1f} q/s estimate +50% — the "
            f"headroom model underestimates beyond the band)")


def _conservation(base) -> "tuple[Optional[str], dict]":
    """Attribution conserved over the run so far, at rest: ``(None, the
    sums)``, or ``(the diagnosis, {})``."""
    # Quiesce first: requests the saturated step abandoned client-side
    # can still be dispatching server-side, and the per-class device-ms
    # adds are not atomic with the wall-counter add — the invariant
    # holds only for a server at rest. Poll the cost totals until two
    # consecutive reads agree.
    totals, prev_wall = None, -1.0
    quiesce_deadline = time.monotonic() + 60
    while time.monotonic() < quiesce_deadline:
        st, body = http(base, "/debug/capacity")
        if st != 200:
            return f"/debug/capacity -> {st} post-ramp", {}
        totals = json.loads(body)["cost"]["totals"]
        if totals["dispatch_wall_ms"] == prev_wall:
            break
        prev_wall = totals["dispatch_wall_ms"]
        time.sleep(0.5)
    else:
        return ("server never quiesced after the ramp (cost totals still "
                "moving after 60 s)"), {}
    attributed, wall = totals["attributed_ms"], totals["dispatch_wall_ms"]
    if wall <= 0 or not math.isclose(attributed, wall, rel_tol=1e-6):
        return (f"attribution conservation broke: attributed {attributed} "
                f"ms vs measured walls {wall} ms"), {}
    st, metrics_text = http(base, "/metrics")
    dev_sum, wall_metric = prom_cost_sums(metrics_text)
    if wall_metric <= 0 or not math.isclose(dev_sum, wall_metric,
                                            rel_tol=1e-6):
        return (f"metric-level conservation broke: "
                f"sum(knn_cost_device_ms_total)={dev_sum} vs "
                f"knn_cost_dispatch_wall_ms_total={wall_metric}"), {}
    st, body = http(base, "/debug/requests?n=50")
    sampled = json.loads(body)["requests"]
    bad = [tl["request_id"] for tl in sampled
           if tl.get("outcome") == "ok" and not tl.get("cost")]
    if bad:
        return (f"{len(bad)} 200 timeline(s) without a cost block "
                f"post-ramp: {bad[:5]}"), {}
    classes = sorted(_capacity(base)["cost"]["classes"])
    print(f"capacity-probe: conservation ok ({attributed:.3f} of "
          f"{wall:.3f} ms attributed; metrics agree to 1e-6), "
          f"{len(sampled)} sampled timelines all costed, classes {classes}")
    return None, {"attributed_ms": attributed, "dispatch_wall_ms": wall,
                  "metric_device_ms_sum": round(dev_sum, 6),
                  "sampled": len(sampled), "classes": classes}


def _save_xl_index(train_arff, path: str) -> None:
    """The xl index the card serves: the large fixture's train rows tiled
    33 times with noise (1,016,499 x 11), k = 10."""
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.models.knn import KNNClassifier
    from knn_tpu_torch.probes.data import tiled_large
    from knn_tpu_torch.serve.artifact import save_index

    train = load_arff(str(train_arff))
    x, y = tiled_large(train.features, train.labels, reps=33)
    save_index(KNNClassifier(k=10).fit(Dataset(x, y)), path)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: run on the card "
                    "or pass --device cpu")
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.probes.data import fixture_paths

    train_arff, test_arff = fixture_paths("large")
    test = load_arff(str(test_arff))
    rng_lo = (args.seed * 131) % max(1, test.num_instances - REQUEST_ROWS)
    # Four precomputed payloads (rotated per fire): the client's JSON
    # serialization cost must not be part of the measured knee.
    payloads = []
    for v in range(4):
        lo = (rng_lo + v * 17) % max(1, test.num_instances - REQUEST_ROWS)
        rows = test.features[lo:lo + REQUEST_ROWS].tolist()
        payloads.append(json.dumps(
            {"instances": rows}, separators=(",", ":"),
        ).encode())

    env = dict(os.environ)
    window_s = 30
    serve_flags = [
        "--cost-accounting", "on",
        "--max-batch", str(MAX_BATCH),
        "--max-wait-ms", "2",
        "--max-queue-rows", str(8 * MAX_BATCH),
        "--capacity-window-s", str(window_s),
        "--flight-recorder-size", "512",
        "--device", args.device,
    ]
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu (plain versions)")
    print(f"capacity-probe: device {where}")

    with tempfile.TemporaryDirectory() as tmp:
        index = args.index
        if index is None and args.device == "cuda":
            index = os.path.join(tmp, "index")
            _save_xl_index(train_arff, index)
            print(f"capacity-probe: saved the xl index to {index}")
        elif index is None:
            index = os.path.join(tmp, "index")
            build = subprocess.run(
                [sys.executable, "-m", "knn_tpu_torch.cli", "save-index",
                 str(train_arff), index, "--k", "5"],
                env=env, capture_output=True, text=True, cwd=REPO,
            )
            if build.returncode != 0:
                return fail(f"save-index rc={build.returncode}: "
                            f"{build.stderr}")
            print(f"capacity-probe: {build.stdout.strip()}")

        t_boot = time.monotonic()
        proc, base = boot(index, env, serve_flags)
        if base is None:
            return fail(f"no ready banner (rc={proc.poll()})", proc)
        boot_s = time.monotonic() - t_boot

        # -- phase 1: low load — cost blocks + the headroom estimate ------
        cost_ids = []
        for i in range(6):
            rid = f"probe-cost-{i}"
            st, body = http(
                base, "/predict", payloads[i % len(payloads)],
                headers={"x-request-id": rid, "x-knn-class": "probe"},
            )
            if st != 200:
                return fail(f"low-load request {rid} -> {st}: "
                            f"{body[:200]}", proc)
            cost_ids.append(rid)
            time.sleep(0.3)
        missing = []
        for rid in cost_ids:
            st, body = http(base, f"/debug/requests?id={rid}")
            if st != 200:
                return fail(f"/debug/requests?id={rid} -> {st}", proc)
            tl = json.loads(body)["requests"][0]
            cost = tl.get("cost")
            if (not cost or cost.get("device_ms", 0) <= 0
                    or cost.get("class") != "probe"):
                missing.append((rid, cost))
        if missing:
            return fail(f"200 timelines WITHOUT a usable cost block: "
                        f"{missing}", proc)
        print(f"capacity-probe: {len(cost_ids)}/{len(cost_ids)} low-load "
              f"200s carry attributed cost blocks (class 'probe')")

        cap_low = _capacity(base).get("capacity") or {}
        estimate = cap_low.get("sustainable_qps")
        model = cap_low.get("dispatch_model")
        if not estimate or estimate <= 0:
            return fail(f"no positive sustainable_qps estimate at low "
                        f"load: {cap_low}", proc)
        print(f"capacity-probe: low-load headroom estimate "
              f"{estimate} req/s of {REQUEST_ROWS}-row requests "
              f"({cap_low.get('sustainable_rows_per_s')} rows/s; dispatch "
              f"model {model}, front end "
              f"{cap_low.get('frontend_ms_per_request')} ms a request by "
              f"the {cap_low.get('frontend_clock')} clock)")

        # -- phase 2: the open-loop ramp -----------------------------------
        steps, knee, procs, limited = _ramp(base, payloads, args, estimate)
        if knee is None:
            return fail(_no_knee(estimate, procs, limited, args.band_hi),
                        proc)

        # -- phase 3: conservation over the whole run ----------------------
        err, conservation = _conservation(base)
        if err:
            return fail(err, proc)

        # -- verdict -------------------------------------------------------
        ratio, within = verdict(knee["measured_qps"], estimate,
                                args.band_lo, args.band_hi)
        print(f"capacity-probe: knee {knee['measured_qps']} q/s "
              f"({knee['reason']}) = {knee['measured_qps'] * REQUEST_ROWS} "
              f"rows/s, {ratio}x the estimate {estimate} q/s")

        # -- single-row requests: the estimate, then its knee --------------
        single = None
        if not args.no_single_row:
            single_payloads = [
                json.dumps({"instances": [r]}, separators=(",", ":"))
                .encode() for r in test.features[:64].tolist()]
            trickle, cap1 = _trickle(base, single_payloads, window_s + 2.0)
            est1 = cap1.get("sustainable_qps")
            if not est1 or est1 <= 0:
                return fail(f"no positive sustainable_qps after the "
                            f"single-row trickle: {cap1}", proc)
            print(f"capacity-probe: single-row estimate {est1} req/s "
                  f"({cap1.get('sustainable_rows_per_s')} rows/s; "
                  f"rows_per_request {cap1.get('rows_per_request')}, "
                  f"dispatch model {cap1.get('dispatch_model')}, front end "
                  f"{cap1.get('frontend_ms_per_request')} ms a request by "
                  f"the {cap1.get('frontend_clock')} clock)")
            steps1, knee1, procs1, limited1 = _ramp(
                base, single_payloads, args, est1)
            if knee1 is None:
                return fail(_no_knee(est1, procs1, limited1, args.band_hi),
                            proc)
            err, conservation = _conservation(base)
            if err:
                return fail(err, proc)
            ratio1, within1 = verdict(knee1["measured_qps"], est1,
                                      args.band_lo, args.band_hi)
            print(f"capacity-probe: single-row knee {knee1['measured_qps']} "
                  f"q/s ({knee1['reason']}), {ratio1}x the estimate {est1} "
                  f"q/s; 128-row: estimate "
                  f"{cap_low.get('sustainable_rows_per_s')} rows/s, knee "
                  f"{knee['measured_qps'] * REQUEST_ROWS} rows/s")
            single = {
                "trickle": trickle,
                "estimate": {key: cap1.get(key) for key in (
                    "sustainable_qps", "sustainable_rows_per_s",
                    "rows_per_request", "dispatch_model",
                    "frontend_ms_per_request", "frontend_clock",
                    "occupancy_mean")},
                "knee": {**knee1, "ratio": round(ratio1, 3),
                         "within_band": within1},
                "procs": procs1,
                "ramp": steps1,
                "client_limited_steps": limited1,
            }

        report = {
            "capacity_probe": {
                "request_rows": REQUEST_ROWS,
                "max_batch": MAX_BATCH,
                "step_s": args.step_s,
                "workers": args.workers,
                "procs": procs,
                "seed": args.seed,
                "index": str(args.index or ("xl" if args.device == "cuda"
                                            else "large fixture")),
                "device": where,
                "boot_s": round(boot_s, 3),
            },
            "estimate": {
                "sustainable_qps": estimate,
                "sustainable_rows_per_s":
                    cap_low.get("sustainable_rows_per_s"),
                "dispatch_model": model,
                "frontend_ms_per_request":
                    cap_low.get("frontend_ms_per_request"),
                "frontend_clock": cap_low.get("frontend_clock"),
            },
            "knee": {**knee, "ratio": round(ratio, 3),
                     "rows_per_s": round(knee["measured_qps"]
                                         * REQUEST_ROWS, 1),
                     "band": [args.band_lo, args.band_hi],
                     "within_band": within},
            "ramp": steps,
            "client_limited_steps": limited,
            "conservation": {**conservation, "ok": True},
            "cost_blocks": {"checked": len(cost_ids)
                            + conservation["sampled"], "ok": True},
            "single_row": single,
        }

        # -- shutdown ------------------------------------------------------
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            return fail("server did not exit after SIGINT", proc)
        if rc != 0:
            return fail(f"server exited rc={rc} after SIGINT")

        out = json.dumps(report, indent=2)
        print(out)
        if args.json_out:
            Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json_out).write_text(out + "\n")
        held = [(f"{REQUEST_ROWS}-row", knee, estimate, ratio, within)]
        if single is not None:
            held.append(("single-row", knee1, est1, ratio1, within1))
        outside = [h for h in held if not h[4]]
        if outside:
            return fail("; ".join(
                f"{name}: measured knee {k['measured_qps']} q/s is "
                f"{r:.2f}x the {e:.1f} q/s headroom estimate — outside the "
                f"documented [{args.band_lo}, {args.band_hi}] band"
                for name, k, e, r, _ in outside))
        print("capacity-probe: PASS (" + "; ".join(
            f"{name}: knee {k['measured_qps']} q/s = {r:.2f}x the model's "
            f"{e:.1f} q/s" for name, k, e, r, _ in held)
            + f", inside [{args.band_lo}, {args.band_hi}])")
        return 0


if __name__ == "__main__":
    sys.exit(main())
