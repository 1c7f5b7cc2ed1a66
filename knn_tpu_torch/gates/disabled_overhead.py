"""The disabled-path overhead gate on the port: the counterpart of the JAX
package's ``scripts/check_disabled_overhead.py`` (part of its ``make
verify``; ``make verify-torch`` runs this one).

Every observability and serving layer carries one contract: **zero cost
while it is off** (one predicate per call site). The gate pins it:

1. **functional** — with ``KNN_TPU_OBS`` unset, a medium predict and a
   ``MicroBatcher`` call record 0 spans and 0 instruments.
   **1a** — a ``ServeApp`` at its defaults builds no quality or drift tap,
   no accountant or capacity tracker, no ivf machinery or rung (primary
   rung ``fast``), no mutable engine or compactor, no result cache, no
   workload recorder, no control plane, no history or alerts, no shard or
   fleet role, and no bucket ladder outside its batcher; the lazy modules
   stay out of ``sys.modules``, no ``knn-*`` layer thread is alive and no
   ``knn_*`` layer instrument is recorded. **1b** — the device-side layer
   (``obs/devprof.py``) records nothing. **1c** — a router without flags
   builds no event log, no access log and no hedge-pool thread before its
   first forward, and no bootstrap, autoscale, history or alert machinery.
2. **timing** — the best of 5 medium predicts, with a
   ``ServeApp(cost_accounting=True, capture_dir=...)`` alive, stays under
   ``KNN_TPU_OVERHEAD_BUDGET_MS`` (default 60, as in JAX); the measured
   value is printed. The on-state halves come with it: the capture records
   at least one event and the accounting attributes at least one dispatch.

The name lists below are JAX's with ``knn_tpu`` renamed ``knn_tpu_torch``
(``tests/test_torch_gates.py`` holds them to the JAX script's text).
Three checks of JAX's name a role the port renamed; :data:`RENAMED` maps
each to its port counterpart.

Exit 0 when every check holds; 1 with a diagnosis otherwise.

Usage: ``python -m knn_tpu_torch.gates.disabled_overhead [--device
cuda|cpu]`` (the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import threading
import time

BEST_OF = 5

#: JAX's checks whose subject the port renamed: the JAX name -> the port's
#: counterpart, which the gate checks in its place.
RENAMED = {
    # §1b: JAX forces its compile listener in and jits a fresh shape. The
    # port compiles no executable at dispatch; its compile events are the
    # builds of its own sources, each reported through record_build.
    "knn_tpu.obs.devprof.install_compile_listeners":
        "knn_tpu_torch.obs.devprof.record_build",
    # §1a: JAX keeps a process-wide query bucket ladder in its model
    # module; the port passes the ladder to each MicroBatcher, so the
    # check is that the model module holds no ladder and that its pad
    # rule is the same before and after a bucketed batcher ran.
    "knn_tpu.models.knn.query_buckets":
        "knn_tpu_torch.models.knn.query_padded_rows",
    # The medium preset: bench.py's loader, in the port the fixture
    # ladder's copy.
    "bench._load_medium": "knn_tpu_torch.probes.data.load_pair",
}

#: Lazy modules that exact-only, mutable-off, flagless serving must not
#: import (the device-IVF/delta-tail, shard, fleet, control and
#: history/alerting machinery).
DEVICE_TAIL_MODULES = ("knn_tpu_torch.ops.segment_score",
                       "knn_tpu_torch.mutable.device_tail")
SHARD_MODULES = ("knn_tpu_torch.shard", "knn_tpu_torch.shard.plan",
                 "knn_tpu_torch.shard.model", "knn_tpu_torch.shard.dispatch")
FLEET_MODULES = ("knn_tpu_torch.fleet", "knn_tpu_torch.fleet.replica",
                 "knn_tpu_torch.fleet.router", "knn_tpu_torch.fleet.health",
                 "knn_tpu_torch.fleet.wire", "knn_tpu_torch.fleet.bootstrap",
                 "knn_tpu_torch.fleet.events")
CONTROL_MODULES = ("knn_tpu_torch.control",
                   "knn_tpu_torch.control.admission",
                   "knn_tpu_torch.control.brownout",
                   "knn_tpu_torch.control.autotune",
                   "knn_tpu_torch.control.autoscale")
HISTORY_MODULES = ("knn_tpu_torch.obs.history", "knn_tpu_torch.obs.alerts")

#: Worker-thread name prefixes of the serving layers.
LAYER_THREAD_PREFIXES = ("knn-quality", "knn-drift", "knn-compactor",
                         "knn-workload", "knn-fleet", "knn-control",
                         "knn-history", "knn-alerts")
#: Instrument name prefixes of the serving layers.
LAYER_INSTRUMENT_PREFIXES = ("knn_quality_", "knn_drift_", "knn_cost_",
                             "knn_capacity_", "knn_ivf_", "knn_mutable_",
                             "knn_workload_", "knn_cache_", "knn_fleet_",
                             "knn_shard_", "knn_control_", "knn_history_",
                             "knn_alerts_")
#: The flagless router's: bootstrap, autoscale, history/alert threads.
ROUTER_BOOTSTRAP_THREAD = "knn-fleet-bootstrap"
ROUTER_AUTOSCALE_THREAD = "knn-control-autoscale"
ROUTER_HISTORY_THREADS = ("knn-history", "knn-alerts")
ROUTER_INSTRUMENT_PREFIX = "knn_fleet_"


def fail(msg: str) -> int:
    print(f"disabled-overhead: FAIL: {msg}", file=sys.stderr)
    return 1


def _imported(modules) -> "str | None":
    return next((m for m in modules if m in sys.modules), None)


def _threads(prefixes) -> "list[str]":
    return [t.name for t in threading.enumerate()
            if t.name.startswith(prefixes)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="disabled_overhead",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if os.environ.get("KNN_TPU_OBS", "") not in ("", "0"):
        return fail("KNN_TPU_OBS is set; this gate measures the DISABLED "
                    "path — unset it")

    import torch

    from knn_tpu_torch import obs

    if obs.enabled():
        return fail("knn_tpu_torch.obs is enabled at import with no "
                    "KNN_TPU_OBS set — the disabled-by-default contract is "
                    "broken")
    if args.device == "cuda" and not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: run on the card "
                    "or pass --device cpu")

    from knn_tpu_torch.models import knn as knn_mod
    from knn_tpu_torch.models.knn import KNNClassifier
    from knn_tpu_torch.probes.data import load_pair
    from knn_tpu_torch.serve.batcher import MicroBatcher

    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu (plain versions)")
    print(f"disabled-overhead: device {where}")
    train, test = load_pair("medium")
    model = KNNClassifier(k=5, device=args.device).fit(train)
    model.predict(test)  # warm: the kernels' build and first launch excluded

    # -- 1. functional: the disabled path records nothing ------------------
    obs.reset()
    model.predict(test)
    with MicroBatcher(model, max_batch=8, max_wait_ms=0.0) as b:
        b.predict(test.features[0], timeout=60)
    spans = obs.tracer().spans()
    instruments = obs.registry().instruments()
    if spans:
        return fail(f"{len(spans)} span(s) recorded while disabled "
                    f"(first: {spans[0].name!r})")
    if instruments:
        return fail(f"{len(instruments)} metric instrument(s) created "
                    f"while disabled (first: {instruments[0].name!r})")
    print("disabled-overhead: functional ok (0 spans, 0 instruments, "
          "no request traces)")

    # -- 1a. the serving layers' off-state ---------------------------------
    from knn_tpu_torch.serve.server import ServeApp

    pad_before = knn_mod.query_padded_rows(3)
    app = ServeApp(model, max_batch=8, max_wait_ms=0.0)
    try:
        if app.quality is not None or app.drift is not None:
            return fail("ServeApp built a shadow scorer / drift monitor "
                        "at rate 0 — the quality layer must not exist "
                        "while disabled")
        if app.batcher.quality is not None or app.batcher.drift is not None:
            return fail("the batcher holds a quality/drift tap at rate 0")
        if app.accounting is not None or app.capacity is not None:
            return fail("ServeApp built a cost accountant / capacity "
                        "tracker with cost_accounting off — the layer "
                        "must not exist while disabled")
        if (app.batcher.accounting is not None
                or app.batcher.capacity is not None):
            return fail("the batcher holds an accounting/capacity tap "
                        "while disabled")
        if app.ivf is not None or app.batcher.ivf is not None:
            return fail("ServeApp built IVF serving machinery for an "
                        "exact-only model — the ivf layer must not exist "
                        "while disabled")
        if any(name == "ivf" for name, _fn
               in app.batcher._rungs(app.batcher._model)):
            return fail("the serving ladder grew an ivf rung for an "
                        "exact-only model")
        if app.primary_rung != "fast":
            return fail(f"primary rung {app.primary_rung!r} on an "
                        f"exact-only serve; the fast_rung SLI would "
                        f"misattribute")
        if app.mutable is not None or app.compactor is not None:
            return fail("ServeApp built a mutable engine / compactor with "
                        "mutable off — the layer must not exist while "
                        "disabled")
        if app.batcher.mutable is not None:
            return fail("the batcher holds a mutable engine while disabled")
        mod = _imported(DEVICE_TAIL_MODULES)
        if mod:
            return fail(f"{mod} imported during exact-only, mutable-off "
                        f"serving — the device-IVF/delta-tail machinery "
                        f"must not construct while disabled")
        if app.shards is not None:
            return fail("ServeApp resolved a shard count with --shards "
                        "unset")
        if hasattr(app.model, "shard_plan_"):
            return fail("ServeApp wrapped the model in a sharded twin "
                        "with --shards unset")
        mod = _imported(SHARD_MODULES)
        if mod:
            return fail(f"{mod} imported during unsharded serving — shard "
                        f"machinery must not construct while disabled")
        if app.fleet is not None:
            return fail("ServeApp built a fleet role with no "
                        "--follower-of/--replicate-to — the layer must "
                        "not exist while disabled")
        mod = _imported(FLEET_MODULES)
        if mod:
            return fail(f"{mod} imported during plain single-process "
                        f"serving — fleet machinery must not construct "
                        f"while disabled")
        if app.workload is not None or app.batcher.workload is not None:
            return fail("ServeApp built a workload capture layer with no "
                        "capture_dir — the layer must not exist while "
                        "disabled")
        if (app.admission is not None or app.brownout is not None
                or app.autotune is not None):
            return fail("ServeApp built overload-control machinery with "
                        "no --priority/--brownout/--autotune-interval-s "
                        "— the control plane must not exist while "
                        "disabled")
        if app.batcher.admission is not None:
            return fail("the batcher holds an admission tap while "
                        "disabled")
        mod = _imported(CONTROL_MODULES)
        if mod:
            return fail(f"{mod} imported during flagless serving — "
                        f"control-plane machinery must not construct "
                        f"while disabled")
        if any("_merged_rung" in fn.__qualname__
               for _name, fn in app.batcher._rungs(app.batcher._model)):
            return fail("the serving ladder wrapped a rung with the "
                        "mutable merge while disabled")
        if app.history is not None or app.alerts is not None:
            return fail("ServeApp built history/alerting machinery with "
                        "no --history-dir/--alert-rules — the layer must "
                        "not exist while disabled")
        mod = _imported(HISTORY_MODULES)
        if mod:
            return fail(f"{mod} imported during flagless serving — "
                        f"history/alerting machinery must not construct "
                        f"while disabled")
        if app.batcher.buckets is not None or app.batcher._stager is not None:
            return fail("the batcher built a bucket ladder / upload "
                        "stager with no --batch-buckets configured")
        if app.batcher.cache is not None:
            return fail("the batcher built a result cache with "
                        "result_cache_rows 0 — the layer must not exist "
                        "while disabled")
        held = [n for n in ("query_buckets", "query_bucket_ladder")
                if hasattr(knn_mod, n)]
        if held:
            return fail(f"the model module holds a process-wide bucket "
                        f"ladder ({held}) — the port scopes the ladder to "
                        f"its MicroBatcher")
        app.batcher.predict(test.features[0], timeout=60)
    finally:
        app.close()
    # A single-bucket ladder with the cache off constructs nothing new
    # either: no ResultCache, zero knn_cache_* instruments, and the model
    # module's pad rule untouched once the batcher is gone.
    app_1b = ServeApp(model, max_batch=8, max_wait_ms=0.0,
                      batch_buckets=(8,), result_cache_rows=0)
    try:
        if app_1b.batcher.cache is not None:
            return fail("a single-bucket ladder with "
                        "--result-cache-rows 0 built a result cache")
        app_1b.batcher.predict(test.features[0], timeout=60)
    finally:
        app_1b.close()
    if knn_mod.query_padded_rows(3) != pad_before:
        return fail("a bucketed batcher changed the model module's pad "
                    "rule — the legacy pad quantum must be untouched")
    if any(i.name.startswith("knn_cache_")
           for i in obs.registry().instruments()):
        return fail("knn_cache_* instrument(s) recorded with the result "
                    "cache disabled")
    bad_threads = _threads(LAYER_THREAD_PREFIXES)
    if bad_threads:
        return fail(f"quality/drift/compactor/workload worker thread(s) "
                    f"alive while disabled: {bad_threads}")
    leaked = [i.name for i in obs.registry().instruments()
              if i.name.startswith(LAYER_INSTRUMENT_PREFIXES)]
    if leaked:
        return fail(f"quality/drift/cost/capacity/ivf/mutable/workload "
                    f"instrument(s) recorded while disabled: {leaked}")
    print("disabled-overhead: quality/drift/cost/capacity/ivf/mutable/"
          "workload off-state ok (no scorer, no monitor, no accountant, "
          "no tracker, no probe policy, no delta engine, no compactor, "
          "no capture recorder, no worker threads, zero instruments, "
          "zero queue activity)")

    # -- 1b. the device-side layer (obs/devprof.py) off-state --------------
    # A build of the port's own sources (the kernels on the card, the
    # native runtime on the host), its compile event forced through
    # record_build, a device-memory sample and an executable lookup: a
    # disabled process records nothing from any of them.
    from knn_tpu_torch.obs import devprof

    t0 = time.monotonic()
    if args.device == "cuda":
        from knn_tpu_torch.ops import _build

        _build.build_all()
        built = "the kernels"
    else:
        from knn_tpu_torch import native

        try:
            native.build("knn_runtime")
            built = "the native runtime"
        except OSError:  # no C++ compiler on this host
            built = "nothing (no C++ compiler)"
    devprof.record_build("gate", "probe", (time.monotonic() - t0) * 1e3)
    devprof.record_device_memory()
    if devprof.record_executable_lookup("gate", ("probe",)) != "off":
        return fail("devprof.record_executable_lookup tracked a signature "
                    "while disabled")
    instruments = obs.registry().instruments()
    if instruments:
        return fail(f"devprof recorded {len(instruments)} instrument(s) "
                    f"while disabled (first: {instruments[0].name!r}) — "
                    f"the build events / memory gauges must gate on "
                    f"obs.enabled()")
    print(f"disabled-overhead: devprof off-state ok (build of {built}, "
          f"forced build event, memory sample, cache tracker all recorded "
          f"nothing)")

    # -- 1c. the fleet router without flags --------------------------------
    # Runs AFTER the plain-serve fleet sys.modules checks above: importing
    # the router here is the opted-in path.
    from knn_tpu_torch.fleet.router import RouterApp

    router = RouterApp(["http://127.0.0.1:9"],  # port 9: never listening
                       health_interval_s=3600.0, poll_timeout_s=0.2)
    try:
        if router.events is not None:
            return fail("RouterApp built a fleet event log with no "
                        "--event-log — the audit layer must not exist "
                        "while disabled")
        if router.access_log is not None:
            return fail("RouterApp built an access log with no "
                        "--access-log")
        if router.recorder is None:
            return fail("RouterApp dropped its default flight recorder "
                        "(the serve parity contract: tracing is on, "
                        "bounded, --flight-recorder-size 0 disables)")
        if router._pool._threads:
            return fail(f"{len(router._pool._threads)} hedge-pool "
                        f"thread(s) started before any forward — the "
                        f"pool must stay lazy")
        if router.set.events is not None:
            return fail("the health poller holds an event log while "
                        "disabled")
        if router._bootstrap_inflight or router._bootstrap_last:
            return fail("RouterApp tracked bootstrap work with "
                        "auto-failover off")
        if router.reseeds != 0:
            return fail("RouterApp counted a reseed with auto-failover "
                        "off")
        router._maybe_bootstrap()  # must be a no-op without the flag
        boot_threads = _threads(ROUTER_BOOTSTRAP_THREAD)
        if boot_threads:
            return fail(f"bootstrap driver thread(s) alive on a "
                        f"flagless router: {boot_threads}")
        if router.autoscale is not None or router._offered is not None:
            return fail("RouterApp built autoscale machinery with no "
                        "--scale-cmd — the layer must not exist while "
                        "disabled")
        if "knn_tpu_torch.control.autoscale" in sys.modules:
            return fail("knn_tpu_torch.control.autoscale imported on a "
                        "flagless router")
        router._maybe_autoscale()  # must be a no-op without the flag
        scale_threads = _threads(ROUTER_AUTOSCALE_THREAD)
        if scale_threads:
            return fail(f"autoscale driver thread(s) alive on a "
                        f"flagless router: {scale_threads}")
        if router.history is not None or router.alerts is not None:
            return fail("RouterApp built history/alerting machinery "
                        "with no --history-dir/--alert-rules — the "
                        "layer must not exist while disabled")
        mod = _imported(HISTORY_MODULES)
        if mod:
            return fail(f"{mod} imported on a flagless router — "
                        f"history/alerting machinery must not construct "
                        f"while disabled")
        hist_threads = _threads(ROUTER_HISTORY_THREADS)
        if hist_threads:
            return fail(f"history/alert thread(s) alive on a flagless "
                        f"router: {hist_threads}")
    finally:
        router.close()
    leaked = [i.name for i in obs.registry().instruments()
              if i.name.startswith(ROUTER_INSTRUMENT_PREFIX)]
    if leaked:
        return fail(f"router off-state recorded fleet instrument(s) "
                    f"with obs disabled: {leaked}")
    print("disabled-overhead: router off-state ok (no event log, no "
          "access log, lazy hedge pool, zero instruments)")

    # -- 2. timing: best-of mins under the budget --------------------------
    # Measured with a cost-accounting ServeApp alive and a capture window
    # armed: both layers live on the serving dispatch path, so their
    # existence must not move the classify-path predict; each must also
    # construct and record when asked (the on-state half).
    budget_ms = float(os.environ.get("KNN_TPU_OVERHEAD_BUDGET_MS", "60"))
    capture_tmp = tempfile.mkdtemp(prefix="knn-overhead-capture-")
    app_on = ServeApp(model, max_batch=8, max_wait_ms=0.0,
                      cost_accounting=True, capture_dir=capture_tmp)
    try:
        if app_on.accounting is None or app_on.capacity is None:
            return fail("ServeApp(cost_accounting=True) did not build the "
                        "accounting/capacity layers")
        if app_on.workload is None or app_on.batcher.workload is None:
            return fail("ServeApp(capture_dir=...) did not build the "
                        "workload capture layer")
        app_on.workload.start(reason="overhead-gate")
        app_on.batcher.predict(test.features[0], timeout=60)
        if not app_on.workload.drain(10):
            return fail("workload capture queue did not drain")
        cap_stat = app_on.workload.export()
        if cap_stat["captured_events"] < 1:
            return fail("workload capture ON recorded nothing for a "
                        "served request")
        print(f"disabled-overhead: workload-capture on-state ok "
              f"({cap_stat['captured_events']} event(s) captured, "
              f"{cap_stat['shed']} shed)")
        totals = app_on.accounting.export()["totals"]
        if totals["dispatches"] < 1 or totals["dispatch_wall_ms"] <= 0:
            return fail("cost accounting ON attributed nothing for a "
                        "served request")
        print("disabled-overhead: cost-accounting on-state ok "
              f"({totals['dispatches']} dispatch(es) attributed, "
              f"{totals['attributed_ms']:.2f} ms conserved)")
        walls = []
        for _ in range(BEST_OF):
            t0 = time.monotonic()
            model.predict(test)
            walls.append((time.monotonic() - t0) * 1e3)
    finally:
        app_on.close()
        shutil.rmtree(capture_tmp, ignore_errors=True)
    best = min(walls)
    print(f"disabled-overhead: medium-preset predict best-of-{BEST_OF} min "
          f"{best} ms on {where} with cost accounting on (budget "
          f"{budget_ms:.0f} ms; all: {walls})")
    if best > budget_ms:
        return fail(f"best-of min {best:.2f} ms exceeds the "
                    f"{budget_ms:.0f} ms budget — the disabled path "
                    f"regressed (KNN_TPU_OVERHEAD_BUDGET_MS overrides)")
    print("disabled-overhead: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
