"""CLI driver: the ``classify`` job of the JAX package's CLI, on the port.

``python -m knn_tpu_torch TRAIN TEST k [threads]`` (bare positional argv
implies the ``classify`` subcommand) loads both ARFF files, classifies every
test row against the train rows, and prints the reference's result line
(main.cpp:146), timing the classify region only, parsing excluded. The
region ends after the predictions are back on the host, so it includes the
device work.

Personas keep the reference's invocations: ``--persona main`` (backend
``native``, ``./main train test k``), ``--persona multi-thread``
(``native-mt``, ``./multi-thread train test k numThreads``: the ``threads``
positional), ``--persona mpi`` (backend ``cuda-sharded``, ``./mpi train
test k``: the queries scattered over the mesh, the twin of the JAX CLI's
``tpu-sharded``) and ``--persona cuda`` (the default, backend ``cuda``,
the twin of the JAX CLI's ``tpu``). ``--backend`` overrides the persona's
backend: ``cuda`` (the stripe route's kernels or the XLA scans),
``cuda-tile`` (the wide-feature rung, the twin of ``tpu-pallas``), the
sharded rungs ``cuda-sharded``, ``cuda-train-sharded`` and ``cuda-ring``
(``parallel/``), ``native``, ``native-mt`` (the C++ kernel, built with
``g++`` at first use) or ``oracle`` (numpy). ``--devices N`` is the mesh
of the sharded rungs: N cards (raising past the visible ones, as JAX
does), or N logical shards of the host with ``--device cpu``.

The other flags have the JAX CLI's names and defaults: ``--precision
{exact,fast,bf16,auto}`` (``auto`` passes nothing, so the backend's own
default applies), ``--metric``, ``--engine {auto,stripe,xla,full,tiled}``
(``full``/``tiled`` are the ring's per-step scorers; other rungs refuse
them),
``--query-tile``, ``--train-tile``, ``--query-batch``, ``--approx`` and
``--recall-target`` (B6: exact selection on the card, recall 1.0, so
JAX's sampled-recall guard has nothing to catch; ``--recall-target``
without ``--approx`` exits 2),
``--no-fallback``, ``--warmup``, ``--json`` (a structured line after the
result line, with the classify region's ``phases`` when obs is on),
``--metrics-out FILE`` (the metrics document, or Prometheus text for a
``.prom``/``.txt`` path) and ``--trace-out FILE`` (Chrome/Perfetto trace
JSON), both checked before any parse and written after the result line,
``--sweep-k K1,K2,...`` and ``--dump-predictions FILE.npy``. The port adds
``--device {cuda,cpu}`` (default ``cuda``; ``cpu`` runs the kernels' plain
PyTorch versions). JAX's ``--platform`` is not accepted: ``--device`` is
the port's one switch for where the work runs. ``KNN_TPU_FAULTS`` arms
the fault injection harness (``resilience/faults.py``) for a run.

The degradation ladder (``resilience/degrade.py``) stops at the card: a
host rung that fails moves down ``native-mt → native → oracle`` with a
``falling back`` warning, a sharded rung that fails moves to ``cuda`` (the
same kernels on one card), an unavailable native backend is replaced by
``oracle`` up front (exit 2 under ``--no-fallback``), but on ``cuda`` and
``cuda-tile`` only transient retries and ``query_batch`` halving after an
OOM remain: a persistent failure there exits 1, never answered from
another route or the host.

``--profile-out FILE`` writes one ``torch.profiler`` trace (CPU and CUDA
activities) of the classify region, the host spans inside it as
``record_function`` ranges; ``--trace-dir DIR`` writes the profiler's own
trace file into ``DIR``.

``save-index TRAIN OUT`` (``--k``, ``--family``, ``--backend``,
``--metric``, ``--weights``, ``--engine``; ``--ivf-cells N``,
``--ivf-seed``, ``--ivf-iters`` also build an IVF partition, its k-means
assignment steps on ``--device``) writes the JAX package's index artifact
(format 3, readable by either package). ``serve INDEX`` loads one, warms
every batch shape on the card and answers ``/predict``, ``/kneighbors``,
``/healthz``, ``/metrics``, ``/debug/*``, ``/admin/reload`` and
``/admin/capture`` (``serve/server.py``), with the default path's flags,
``--ivf-probes P`` and ``--ivf-recall-floor`` (the ``ivf`` rung over the
artifact's partition), the answer-quality and capture flags
(``--shadow-rate``, ``--drift-rate``, ``--quality-queue``,
``--quality-seed``, ``--capture-dir``, ``--capture-rate``,
``--capture-max-requests``, ``--capture-queue``,
``--capture-burn-threshold``, ``--capture-burn-objective``,
``--capture-burn-window-s``), the mutable tier's (``--mutable on``,
``--delta-cap``, ``--compact-threshold``, ``--compact-interval-s``: the
server boots from the generation ``CURRENT.json`` names and replays the
epoch log), ``--shards N|auto`` (the index partitioned over N logical
shards on the card, ``auto`` one per visible card; ``shard/``) and
the control plane's (``--priority``, ``--brownout``,
``--autotune-interval-s``; ``control/``), the durable history's and the
alerts' (``--history-dir``, ``--history-interval-s``,
``--history-retention-s``, ``--alert-rules``) and ``--device {cuda,cpu}``;
the replication flags of the fleet layer, still to port, are not in the
parser, so argparse refuses them (exit 2).
``history DIR`` and ``report --history DIR`` read a history directory (of
either package) after the process that wrote it is gone.
``replay WORKLOAD (--url BASE | --index DIR)`` re-drives a captured
workload (``obs/replay.py``) against a live server or an in-process
micro-batcher on ``--device`` (``--mutable on``: with a mutable engine
over the index, the captured mutations re-applied in ``mutation_seq``
order) and prints the verdict.

Exit codes, as the JAX package's (knn_tpu/cli.py:45-54): 0 success; 2 the
input was rejected before classification (bad flags, bad k, missing or
malformed files, mismatched feature counts, an unknown or unavailable
backend, unwritable artifact paths); 1 the computation failed. Errors are
one ``error:`` line on stderr (``error: Type: message`` for a typed
failure).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Optional, Sequence

from knn_tpu_torch import obs
from knn_tpu_torch.data.arff import load_arff
from knn_tpu_torch.resilience import degrade, faults
from knn_tpu_torch.resilience.errors import ResilienceError
from knn_tpu_torch.utils.cli_format import result_json, result_line
from knn_tpu_torch.utils.evaluate import accuracy, confusion_matrix
from knn_tpu_torch.utils.timing import RegionTimer, maybe_profile

EXIT_USAGE = 2
EXIT_RUNTIME = 1

_SUBCOMMANDS = ("classify", "serve", "save-index", "replay", "history",
                "report")

# persona -> its default backend
_PERSONAS = {"main": "native", "multi-thread": "native-mt",
             "mpi": "cuda-sharded", "cuda": "cuda"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch",
        description="KNN classify on a CUDA card (PyTorch port of knn_tpu)",
    )
    sub = p.add_subparsers(
        dest="command",
        metavar="{classify,serve,save-index,replay,history,report}")
    _add_serve_args(sub.add_parser(
        "serve",
        help="long-lived micro-batching HTTP server over a prebuilt index",
        description="Serve /predict, /kneighbors, /healthz, /metrics from "
                    "an index artifact built by `save-index`, on the card. "
                    "The process warms every batch shape (kernel build, "
                    "train upload) before reporting ready.",
    ))
    _add_save_index_args(sub.add_parser(
        "save-index",
        help="build a versioned index artifact from a train ARFF file",
        description="Parse TRAIN once and write an index artifact "
                    "(arrays.npz + manifest.json) that `serve` boots from "
                    "without re-parsing ARFF; the JAX package's format, "
                    "readable by either package.",
    ))
    _add_replay_args(sub.add_parser(
        "replay",
        help="re-drive a captured workload against a live server or an "
             "in-process batcher and verify the answers",
        description="Replay a workload artifact (serve --capture-dir / "
                    "POST /admin/capture, of either package) open-loop "
                    "with its original inter-arrival timing, verify "
                    "answers bit-identical wherever index_version and "
                    "mutation_seq match the capture, and emit a verdict "
                    "JSON (p50/p99/QPS, divergence counts, captured vs "
                    "replayed).",
    ))
    _add_history_cmd_args(sub.add_parser(
        "history",
        help="query a durable metrics-history directory post-mortem",
        description="Decode the segment ring a serve process wrote under "
                    "--history-dir (of either package; the process may be "
                    "long dead); a torn final segment is repaired, "
                    "corruption anywhere else refused typed; print the "
                    "selected series.",
    ))
    _add_report_args(sub.add_parser(
        "report",
        help="stitch history, alerts, captures and logs into one incident "
             "report",
        description="Build a deterministic markdown+JSON incident report "
                    "from a --history-dir: metrics history, alert "
                    "fire/resolve pairs and action outcomes, alert-armed "
                    "workload captures, frozen slowest-K forensics and "
                    "access-log errors on ONE merged timeline.",
    ))
    c = sub.add_parser(
        "classify",
        help="one-shot classify (bare positional argv implies it)",
        description="Reference-parity KNN classifier",
    )
    c.add_argument("train", help="train ARFF file")
    c.add_argument("test", help="test ARFF file")
    c.add_argument("k", type=int, help="number of neighbors")
    c.add_argument("threads", nargs="?", type=int, default=None,
                   help="worker count (multi-thread persona's 4th positional "
                   "arg)")
    c.add_argument("--persona", choices=sorted(_PERSONAS), default="cuda")
    c.add_argument("--backend", default=None,
                   help="override the persona's backend: cuda (the stripe "
                   "kernels or the XLA scans, as tpu), cuda-tile (the "
                   "wide-feature rung), cuda-sharded, cuda-train-sharded, "
                   "cuda-ring (the mesh rungs), native, native-mt, oracle")
    c.add_argument(
        "--no-fallback", action="store_true",
        help="disable the degradation ladder: an unavailable backend exits 2 "
        "instead of substituting a rung, and a failing host rung exits 1 "
        "instead of degrading (transient-fault retry stays on; a card rung "
        "never degrades)")
    c.add_argument("--precision", choices=["exact", "fast", "bf16", "auto"],
                   default="exact",
                   help="distance form: exact (reference parity), fast "
                   "(matmul expansion), bf16 (bfloat16 cross term), auto "
                   "(defer to the backend's default)")
    c.add_argument("--metric",
                   choices=["euclidean", "manhattan", "chebyshev", "cosine"],
                   default="euclidean",
                   help="distance metric (euclidean = reference semantics; "
                   "the native backends implement euclidean only)")
    c.add_argument("--engine",
                   choices=["auto", "stripe", "xla", "full", "tiled"],
                   default="auto",
                   help="candidate route of the cuda and sharded backends: "
                   "auto (the stripe kernels for the euclidean forms), "
                   "stripe (the kernels at any k), xla (the tiled scan); "
                   "full/tiled are cuda-ring-only per-step scorers")
    c.add_argument("--query-tile", type=int, default=256)
    c.add_argument("--train-tile", type=int, default=2048)
    c.add_argument("--query-batch", type=int, default=None,
                   help="stream queries through the device in chunks of this "
                   "size (bounds device memory for huge query sets)")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the cuda backends run (cpu: their plain "
                   "PyTorch versions)")
    c.add_argument("--devices", type=int, default=None,
                   help="mesh size of the sharded backends (default: every "
                   "visible card; with --device cpu, logical shards, "
                   "default 1)")
    c.add_argument("--warmup", action="store_true",
                   help="run once before timing (excludes build and upload)")
    c.add_argument(
        "--approx", action="store_true",
        help="approximate top-k as in the JAX CLI; the card has no "
        "approximate selection, so it selects exactly (recall 1.0, which "
        "meets every --recall-target)")
    c.add_argument("--recall-target", type=float, default=None,
                   help="per-candidate expected recall for --approx "
                   "(0 < r <= 1, default 0.95)")
    c.add_argument(
        "--sweep-k", default=None, metavar="K1,K2,...",
        help="classify at every listed k from ONE shared retrieval "
        "(positional k is ignored): prints the result line per k, each "
        "reporting the whole sweep's time. Runs the exact retrieval with "
        "--engine auto/stripe/xla, --metric and --device; --backend, "
        "--approx, a non-exact --precision, --query-batch, the threads "
        "positional and tile knobs are rejected")
    c.add_argument(
        "--dump-predictions", default=None, metavar="FILE.npy",
        help="save the int32 prediction vector (with --sweep-k: one file per "
        "k, FILE.k{K}.npy)")
    c.add_argument("--json", action="store_true",
                   help="emit structured JSON metrics")
    c.add_argument(
        "--metrics-out", default=None, metavar="FILE",
        help="write the observability metrics document (per-phase span "
        "totals + counters/gauges/histograms) to FILE as JSON; a .prom/.txt "
        "suffix selects the Prometheus text exposition. Enables the obs "
        "tracer for this run")
    c.add_argument(
        "--trace-out", default=None, metavar="FILE",
        help="write a Chrome/Perfetto trace_event JSON of the run's nested "
        "spans to FILE. Enables the obs tracer for this run")
    c.add_argument(
        "--profile-out", default=None, metavar="FILE",
        help="capture a torch.profiler profile (CPU and CUDA activities) "
        "spanning the classify region and write ONE Perfetto-loadable "
        "trace to FILE: host phase spans ride the kernels' timeline as "
        "record_function ranges. Enables the obs tracer for this run")
    c.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the classify region "
                   "into DIR (created if missing)")
    return p


def _add_history_cmd_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("dir", help="the --history-dir a serve process wrote")
    p.add_argument("--metric", default=None, metavar="NAME",
                   help="filter to one instrument (default: all)")
    p.add_argument("--label", action="append", default=[], metavar="K=V",
                   help="label subset filter (repeatable)")
    p.add_argument("--window", default=None, metavar="W",
                   help="trailing window back from the newest snapshot "
                   "(e.g. 300, 300s, 5m, 1h; default: everything)")
    p.add_argument("--json", action="store_true",
                   help="print the full query document as JSON instead "
                   "of the human summary")


def _add_report_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--history", required=True, metavar="DIR",
                   help="the --history-dir the incident's process wrote")
    p.add_argument("--window", default=None, metavar="W",
                   help="trailing window back from the newest artifact "
                   "timestamp (e.g. 15m, 1h; default: everything)")
    p.add_argument("--access-log", default=None, metavar="FILE",
                   help="the serve --access-log file; its error lines "
                   "join the timeline")
    p.add_argument("--captures", default=None, metavar="DIR",
                   help="the serve --capture-dir; workload manifests "
                   "(alert-armed ones included) join the timeline")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="write the markdown report to FILE (default: "
                   "stdout)")
    p.add_argument("--json-out", default=None, metavar="FILE",
                   help="also write the JSON document to FILE")


def _add_serve_args(p: argparse.ArgumentParser) -> None:
    """The ``serve`` flags, with the JAX CLI's names and defaults. The
    replication flags of the fleet layer, still to port, are absent, so
    argparse refuses them (exit 2)."""
    p.add_argument("index", help="index artifact directory (save-index "
                   "output, of either package)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8099,
                   help="TCP port (0 picks an ephemeral port, reported in "
                   "the ready line)")
    p.add_argument("--max-batch", type=int, default=256,
                   help="close a micro-batch at this many coalesced query "
                   "rows")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="...or when the oldest queued request has waited "
                   "this long (the latency price of coalescing)")
    p.add_argument("--max-queue-rows", type=int, default=4096,
                   help="admission bound: queued rows beyond this are "
                   "refused with HTTP 429")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request deadline (HTTP 504 on expiry); "
                   "requests may override with a deadline_ms body field")
    p.add_argument("--drain-timeout-s", type=float, default=10.0,
                   help="SIGTERM graceful-drain window: answer every "
                   "in-flight request within this many seconds (remainders "
                   "fail 504), then exit 0")
    p.add_argument("--warmup-batches", default=None, metavar="B1,B2,...",
                   help="batch shapes to run before reporting ready "
                   "(default: 1, --max-batch, and every --batch-buckets "
                   "bucket)")
    p.add_argument("--batch-buckets", default="auto",
                   metavar="B1,B2,...|auto|off",
                   help="the server's bucket ladder: a batch stages its "
                   "upload in the smallest bucket >= its rows (pinned "
                   "memory, side stream, double-buffered), continuous "
                   "batching tops a closed batch up to its bucket, and "
                   "every bucket is warmed. 'auto' (default): 16,32,... "
                   "capped at --max-batch; 'off': no ladder, no staging")
    p.add_argument("--result-cache-rows", type=int, default=0,
                   metavar="ROWS",
                   help="exact-match result cache capacity in cached query "
                   "rows (identical rows at the same index_version are "
                   "answered without a dispatch, bit-identical); 0 "
                   "(default) constructs nothing")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the index is served (cpu: the kernels' plain "
                   "PyTorch versions)")
    p.add_argument("--shards", default=None, metavar="N|auto",
                   help="sharded serving: partition the index over N "
                   "logical shards on the card — train rows for the exact "
                   "rung, whole IVF cells for the ivf rung, delta slots "
                   "for the mutable tail — answering bit-identically to "
                   "the unsharded ladder. 'auto' shards one per visible "
                   "card (one with --device cpu); unset (default) "
                   "constructs no shard machinery")
    p.add_argument("--access-log", default=None, metavar="FILE",
                   help="append one structured JSON line per terminal "
                   "request outcome to FILE; '-' logs to stderr")
    p.add_argument("--flight-recorder-size", type=int, default=256,
                   help="per-request timelines kept for /debug/requests "
                   "(0 disables request tracing entirely)")
    p.add_argument("--slowest-k", type=int, default=32,
                   help="slowest-request reservoir size for /debug/slowest")
    p.add_argument("--slo-availability-target", type=float, default=0.999,
                   help="availability SLO: target fraction of non-400 "
                   "requests answered 200")
    p.add_argument("--slo-latency-ms", type=float, default=100.0,
                   help="latency SLO threshold: a 200 slower than this "
                   "spends latency error budget")
    p.add_argument("--slo-latency-target", type=float, default=0.99,
                   help="latency SLO: target fraction of requests answered "
                   "200 within --slo-latency-ms")
    p.add_argument("--slo-fast-rung-target", type=float, default=0.99,
                   help="degradation SLO: target fraction of requests "
                   "served by the model's own engine")
    p.add_argument("--slo-quality-target", type=float, default=0.999,
                   help="quality SLO: target fraction of shadow-scored "
                   "requests whose answers match the oracle exactly (the "
                   "ivf rung: meet --ivf-recall-floor)")
    p.add_argument("--slo-windows", default=None, metavar="S1,S2,...",
                   help="burn-rate windows in seconds (default: 300,3600)")
    p.add_argument("--cost-accounting", choices=["on", "off"], default="on",
                   help="per-request device-cost attribution + the "
                   "capacity/headroom model (knn_cost_*/knn_capacity_*, GET "
                   "/debug/capacity, the x-knn-class request class); 'off' "
                   "constructs nothing")
    p.add_argument("--capacity-window-s", type=int, default=60,
                   help="trailing observation window for the capacity "
                   "rate rings / duty cycle / headroom model")
    p.add_argument("--ivf-probes", type=int, default=None, metavar="P",
                   help="serve the approximate ivf rung over the artifact's "
                   "IVF partition, probing the nearest P cells per query "
                   "(needs a format-3 artifact built with `save-index "
                   "--ivf-cells`); a typed failure of the rung is answered "
                   "by the exact kernels. Omitted (default): exact-only "
                   "serving, no IVF machinery")
    p.add_argument("--ivf-recall-floor", type=float, default=0.95,
                   help="recall@k floor the ivf rung is held to: a "
                   "shadow-scored ivf answer under this mean recall burns "
                   "the quality SLO (the signal the probe policy widens "
                   "--ivf-probes on)")
    p.add_argument("--shadow-rate", type=float, default=0.0,
                   help="shadow-score this fraction of served requests "
                   "against the host oracle in a background thread "
                   "(knn_quality_* metrics, /debug/quality); 0 (default) "
                   "constructs nothing")
    p.add_argument("--drift-rate", type=float, default=0.0,
                   help="fold this fraction of served query rows into the "
                   "query-drift sketch, scored against the artifact's "
                   "training sketch (knn_drift_* gauges); 0 disables")
    p.add_argument("--quality-queue", type=int, default=256,
                   help="bounded shadow/drift sample queue: a full queue "
                   "sheds samples (counted), never blocks serving")
    p.add_argument("--quality-seed", type=int, default=0,
                   help="RNG seed for shadow/drift sampling")
    p.add_argument("--mutable", choices=["on", "off"], default="off",
                   help="online-mutable serving: POST /insert and /delete "
                   "mutate a delta tier + tombstone set merged into every "
                   "answer under the shared (distance, index) contract, "
                   "with a write-ahead epoch log in the artifact directory "
                   "and compaction folding writes into fresh index "
                   "generations (POST /admin/compact forces one). 'off' "
                   "(the default) constructs no mutable machinery")
    p.add_argument("--delta-cap", type=int, default=4096,
                   help="delta-tier row bound: inserts past this are "
                   "refused HTTP 429 until compaction folds the tier")
    p.add_argument("--compact-threshold", type=int, default=1024,
                   help="pending mutations (delta rows + tombstones) that "
                   "trigger a compaction")
    p.add_argument("--compact-interval-s", type=float, default=30.0,
                   help="compaction check interval; 0 runs no timer thread "
                   "(threshold kicks and /admin/compact still compact)")
    p.add_argument("--capture-dir", default=None, metavar="DIR",
                   help="workload capture: finalized capture windows land "
                   "versioned workload artifacts under DIR that `replay` "
                   "re-drives; windows are armed by POST /admin/capture "
                   "or the burn trigger. Omitted (default): no capture "
                   "machinery")
    p.add_argument("--capture-rate", type=float, default=1.0,
                   help="per-request sampling probability while a capture "
                   "window is armed")
    p.add_argument("--capture-max-requests", type=int, default=65536,
                   help="a capture window finalizes itself at this many "
                   "captured events")
    p.add_argument("--capture-queue", type=int, default=1024,
                   help="bounded capture sample queue: a full queue sheds "
                   "records (counted), never blocks serving")
    p.add_argument("--capture-burn-threshold", type=float, default=None,
                   metavar="BURN",
                   help="arm a capture window when the chosen SLO "
                   "objective's short-window burn rate exceeds BURN. "
                   "Omitted (default): manual arming only")
    p.add_argument("--capture-burn-objective",
                   choices=["availability", "latency", "fast_rung",
                            "quality"],
                   default="availability",
                   help="which SLO objective's burn rate arms the "
                   "burn-triggered capture")
    p.add_argument("--capture-burn-window-s", type=float, default=60.0,
                   help="burn-triggered capture windows auto-stop after "
                   "this many seconds (or at --capture-max-requests)")
    p.add_argument("--priority", default=None,
                   metavar="CLASS=LEVEL,...",
                   help="priority admission: map request classes to shed "
                   "levels (e.g. 'interactive=0,batch=1,bulk=2'; LOWER = "
                   "more protected). Past the knee (headroom under the "
                   "floor, or availability/latency burn over threshold) "
                   "the HIGHEST levels shed first with a typed 429 + "
                   "headroom-derived Retry-After, tier by tier; the lowest "
                   "level is never shed by policy. Needs --cost-accounting "
                   "on. Unset (default): no admission machinery")
    p.add_argument("--brownout", choices=["on", "off"], default="off",
                   help="reversible brownout ladder: under sustained "
                   "pressure walk shadow/drift sampling rates, ivf nprobe "
                   "to base and the deadline down one cooldown at a time, "
                   "each step audited and walked back on recovery; "
                   "compaction and sampling defer while headroom is "
                   "negative. Needs one such knob. 'off' (default): "
                   "nothing constructed")
    p.add_argument("--autotune-interval-s", type=float, default=None,
                   metavar="S",
                   help="adaptive batching: every S seconds capture a short "
                   "live-arrival window, sweep max_wait_ms candidates "
                   "through the what-if frontier, and apply the best one "
                   "ONLY after a replay of the window on the live batcher "
                   "verifies bit-identical answers. Needs --capture-dir "
                   "and --cost-accounting on. Unset (default): "
                   "max_wait_ms stays static")
    p.add_argument("--history-dir", default=None, metavar="DIR",
                   help="durable metrics history: append delta-encoded "
                   "registry snapshots to an on-disk segment ring under "
                   "DIR, queryable live at GET /debug/history and "
                   "post-mortem with `history DIR`. Unset (default): no "
                   "history machinery")
    p.add_argument("--history-interval-s", type=float, default=5.0,
                   metavar="S",
                   help="snapshot cadence for --history-dir (and the "
                   "alert-rule evaluation cadence); default 5")
    p.add_argument("--history-retention-s", type=float, default=3600.0,
                   metavar="S",
                   help="on-disk retention: whole segments older than "
                   "this are pruned (default 3600)")
    p.add_argument("--alert-rules", default=None, metavar="RULES.json",
                   help="declarative alerting: threshold / burn-rate / "
                   "absence / derivative rules with for: durations and "
                   "hysteretic fire->resolve, evaluated each "
                   "--history-interval-s; transitions land in alerts.jsonl "
                   "under --history-dir, knn_alerts_firing{alert} and GET "
                   "/debug/alerts; actions arm a workload capture, take a "
                   "profile or run an audited command. Unset (default): "
                   "no alerting machinery")


def _add_replay_args(p: argparse.ArgumentParser) -> None:
    """``replay``'s flags, with the JAX CLI's names and defaults;
    ``--device`` is the port's own (where the in-process batcher runs)."""
    p.add_argument("workload", help="workload artifact directory "
                   "(manifest.json + queries.npz + events.jsonl)")
    target = p.add_mutually_exclusive_group(required=True)
    target.add_argument("--url", default=None, metavar="BASE_URL",
                        help="replay against a live server (e.g. "
                        "http://127.0.0.1:8099)")
    target.add_argument("--index", default=None, metavar="DIR",
                        help="replay against an in-process micro-batcher "
                        "over this index artifact (no HTTP overhead)")
    p.add_argument("--speed", type=float, default=1.0,
                   help="arrival-clock multiplier: 1 = original "
                   "inter-arrival timing, 2 = twice as fast, 0 = no "
                   "pacing")
    p.add_argument("--verify", choices=["tag", "always", "off"],
                   default="tag",
                   help="answer verification: 'tag' (default) requires "
                   "bit-identical digests wherever index_version and "
                   "mutation_seq match the capture; 'always' compares "
                   "every answered pair; 'off' skips verification")
    p.add_argument("--max-batch", type=int, default=None,
                   help="in-process batcher policy (default: the "
                   "workload's captured policy, else 256)")
    p.add_argument("--max-wait-ms", type=float, default=None,
                   help="in-process batcher policy (default: the "
                   "workload's captured policy, else 2.0)")
    p.add_argument("--mutable", choices=["on", "off"], default="off",
                   help="in-process mutation replay: 'on' builds a mutable "
                   "engine over --index and re-applies the captured "
                   "insert/delete stream (this WRITES epoch records into "
                   "the artifact directory — replay into a copy). 'off' "
                   "(default) skips mutations with a warning; reads still "
                   "replay")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the in-process batcher serves the index "
                   "(cpu: the kernels' plain PyTorch versions)")
    p.add_argument("--verdict-out", default=None, metavar="FILE",
                   help="write the verdict JSON to FILE (stdout always "
                   "gets the one-line summary + the JSON)")
    p.add_argument("--fail-on-divergence", action="store_true",
                   help="exit 1 when any verified answer diverged")


def _add_save_index_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("train", help="train ARFF file")
    p.add_argument("out", help="output artifact directory")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--family", choices=["classifier", "regressor"],
                   default="classifier")
    p.add_argument("--backend", default="cuda",
                   help="classifier backend recorded in the manifest (under "
                   "its JAX name: cuda as tpu, cuda-tile as tpu-pallas)")
    p.add_argument("--metric",
                   choices=["euclidean", "manhattan", "chebyshev", "cosine"],
                   default="euclidean")
    p.add_argument("--weights", choices=["uniform", "distance"],
                   default="uniform")
    p.add_argument("--engine", choices=["auto", "stripe", "xla"],
                   default="auto",
                   help="candidate engine (regressor; for the classifier it "
                   "is recorded as a backend option when not auto)")
    p.add_argument("--ivf-cells", type=int, default=None, metavar="N",
                   help="also build an IVF partition: k-means the train rows "
                   "into N cells and persist centroids + the cell-sorted "
                   "row layout in the artifact (format 3) — what `serve "
                   "--ivf-probes` answers from. Euclidean metric only")
    p.add_argument("--ivf-seed", type=int, default=0,
                   help="k-means seed (deterministic partitions; recorded in "
                   "the manifest)")
    p.add_argument("--ivf-iters", type=int, default=25,
                   help="max Lloyd iterations for the partition build")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the partition build's k-means assignment "
                   "steps run (with --ivf-cells)")


def _normalize_argv(argv: Optional[Sequence[str]]) -> "list[str]":
    """Prepend ``classify`` unless argv already names it (or asks for
    top-level help), keeping the reference's bare positional invocation."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or (argv[0] not in _SUBCOMMANDS
                    and argv[0] not in ("-h", "--help")):
        argv = ["classify"] + argv
    return argv


def _error(msg: str) -> None:
    print("error: " + " | ".join(str(msg).splitlines()), file=sys.stderr)


def run(argv: Optional[Sequence[str]] = None, stdout=None) -> int:
    """CLI entry. Observability enabled by --metrics-out/--trace-out is
    scoped to this call: the prior global on/off state is restored on the
    way out, so an embedder that invokes the CLI once with artifacts does
    not keep paying for tracing afterwards."""
    was_enabled = obs.enabled()
    try:
        return _run(argv, stdout)
    finally:
        if not was_enabled and obs.enabled():
            obs.disable()


def _run(argv: Optional[Sequence[str]], stdout) -> int:
    stdout = stdout or sys.stdout
    try:
        args = build_parser().parse_args(_normalize_argv(argv))
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else EXIT_USAGE
    # Re-read KNN_TPU_FAULTS so env-armed chaos runs work for in-process
    # run() calls too; inject()-armed plans are kept. A malformed spec is
    # user input: one line, the usage exit code.
    try:
        faults.install_from_env()
    except ValueError as e:
        _error(f"{faults.FAULT_ENV}: {e}")
        return EXIT_USAGE
    if args.command == "serve":
        return _run_serve(args, stdout)
    if args.command == "save-index":
        return _run_save_index(args, stdout)
    if args.command == "replay":
        return _run_replay(args, stdout)
    if args.command == "history":
        return _run_history(args, stdout)
    if args.command == "report":
        return _run_report(args, stdout)
    return _run_classify(args, stdout)


def _dump_predictions(path: str, preds) -> bool:
    """Save a prediction vector, keeping the CLI's error contract (a bad
    path reports ``error: ...`` and exits 1, never a traceback). Runs after
    the result line, so a failed save does not discard the computed
    output."""
    import numpy as np

    try:
        np.save(path, preds)
        return True
    except OSError as e:
        _error(e)
        return False


def _setup_obs(args) -> Optional[str]:
    """Enable the span tracer when observability artifacts were requested,
    failing fast (before any parse or compute) on unwritable destinations.
    Returns an error message or None."""
    if not (args.metrics_out or args.trace_out or args.profile_out):
        return None
    from knn_tpu_torch.obs.export import check_parent_dir

    for path in (args.metrics_out, args.trace_out, args.profile_out):
        if path:
            try:
                check_parent_dir(path)
            except OSError as e:
                return str(e)
    obs.enable()
    obs.reset()  # the artifacts describe this run, not earlier spans
    return None


@contextlib.contextmanager
def _maybe_capture(path: Optional[str]):
    """Wrap the classify region in a ``torch.profiler`` capture when
    ``--profile-out`` was given (``obs/devprof.py``); yields the Capture
    (its ``.trace`` is readable after the region) or None."""
    if not path:
        yield None
        return
    from knn_tpu_torch.obs import devprof

    with devprof.capture() as cap:
        yield cap


def _write_profile(path: str, cap) -> bool:
    """Write the captured profile after the result line (one-line error and
    exit 1 on failure, as the other artifacts)."""
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(cap.trace, f)
    except OSError as e:
        _error(e)
        return False
    return True


def _phases(classify_span) -> "dict | None":
    """``{phase: total_ms}`` over the classify region's direct children
    (they partition the region), or None with obs off."""
    return obs.tracer().phase_totals(classify_span) if obs.enabled() else None


def _write_obs_artifacts(args, classify_span, wall_ms) -> bool:
    """Write --trace-out / --metrics-out, after the result line, so a
    failed save does not discard the computed output."""
    if not (args.metrics_out or args.trace_out):
        return True
    from knn_tpu_torch.obs.export import write_metrics, write_trace

    try:
        if args.trace_out:
            write_trace(args.trace_out, obs.tracer())
        if args.metrics_out:
            write_metrics(args.metrics_out, obs.tracer(), obs.registry(),
                          phase_parent=classify_span, wall_ms=wall_ms)
    except OSError as e:
        _error(e)
        return False
    return True


def _sweep_ks(args) -> "tuple[list[int] | None, str | None]":
    """``--sweep-k``'s sorted, deduplicated ks and no error, or no ks and
    the error line; checked before any file is read."""
    try:
        ks = sorted({int(s) for s in args.sweep_k.split(",") if s})
        if not ks or ks[0] < 1:
            raise ValueError
    except ValueError:
        return None, (f"--sweep-k wants positive integers, got "
                      f"{args.sweep_k!r}")
    # Options the retrieval cannot honor are rejected rather than silently
    # computing something else.
    rejected = [name for name, bad in (
        ("--backend", args.backend is not None),
        ("--approx", args.approx),
        ("--precision", args.precision not in ("exact", "auto")),
        ("--query-batch", args.query_batch is not None),
        ("--engine full/tiled", args.engine in ("full", "tiled")),
        ("--threads", args.threads is not None),
        ("--devices", args.devices is not None),
        ("--query-tile", args.query_tile != 256),
        ("--train-tile", args.train_tile != 2048),
    ) if bad]
    if rejected:
        return None, ("--sweep-k runs the exact candidate-retrieval path; "
                      f"incompatible with {', '.join(rejected)}")
    return ks, None


def _run_sweep(args, ks, stdout) -> int:
    from knn_tpu_torch.models.knn import sweep_k

    try:
        train = load_arff(args.train)
        test = load_arff(args.test)
        train.validate_for_knn(max(ks), test)
    except (OSError, ValueError) as e:
        _error(e)
        return EXIT_USAGE
    opts = {"metric": args.metric, "engine": args.engine,
            "device": args.device}
    try:
        if args.warmup:
            sweep_k(train, test, ks, **opts)
        with _maybe_capture(args.profile_out) as capture:
            with maybe_profile(args.trace_dir):
                with RegionTimer() as t:
                    with obs.span("classify", mode="sweep",
                                  engine=args.engine) as classify_span:
                        preds_by_k = sweep_k(train, test, ks, **opts)
    except ResilienceError as e:
        _error(f"{type(e).__name__}: {e}")
        return EXIT_RUNTIME
    except (ValueError, RuntimeError) as e:
        _error(e)
        return EXIT_RUNTIME
    phases = _phases(classify_span)
    base = args.dump_predictions
    if base and base.endswith(".npy"):
        base = base[:-4]
    for k in ks:
        acc = accuracy(confusion_matrix(preds_by_k[k], test.labels,
                                        test.num_classes))
        print(result_line(k, test.num_instances, train.num_instances, t.ms,
                          acc), file=stdout)
        if args.json:
            print(result_json(k, test.num_instances, train.num_instances,
                              t.ms, acc, f"sweep:{args.engine}",
                              phases=phases), file=stdout)
        if base and not _dump_predictions(f"{base}.k{k}.npy", preds_by_k[k]):
            return EXIT_RUNTIME
    if not _write_obs_artifacts(args, classify_span, round(t.ns / 1e6, 3)):
        return EXIT_RUNTIME
    if capture is not None and not _write_profile(args.profile_out, capture):
        return EXIT_RUNTIME
    return 0


def _static_rung(args) -> "tuple[str | None, int]":
    """The backend to start from: the persona's or ``--backend``. A known
    backend that is unavailable on this install (the native rungs without
    a C++ compiler) is replaced by its first available ladder rung, with a
    warning; under ``--no-fallback``, or with no rung left, or for an
    unknown name, it is a usage error. Returns (backend, 0) or (None,
    exit code)."""
    from knn_tpu_torch.backends import available_backends, is_available

    name = args.backend or _PERSONAS[args.persona]
    if is_available(name):
        return name, 0
    fallback = (degrade.fallback_for(name, available_backends())
                if degrade.known_backend(name) else None)
    if fallback is None:
        _error(f"backend '{name}' unavailable")
        return None, EXIT_USAGE
    if args.no_fallback:
        _error(f"backend '{name}' unavailable and --no-fallback forbids "
               f"degrading to '{fallback}'")
        return None, EXIT_USAGE
    reason = ("native runtime unavailable (no C++ compiler: $CXX or g++)"
              if name.startswith("native")
              else "backend not registered on this install")
    print(f"warning: backend '{name}' unavailable — {reason}; falling back "
          f"to '{fallback}'", file=sys.stderr)
    return fallback, 0


def _run_classify(args, stdout) -> int:
    obs_err = _setup_obs(args)
    if obs_err is not None:
        _error(obs_err)
        return EXIT_USAGE
    if args.sweep_k is not None:
        ks, err = _sweep_ks(args)
        if err is not None:
            _error(err)
            return EXIT_USAGE
        return _run_sweep(args, ks, stdout)
    if args.recall_target is not None and not args.approx:
        _error("--recall-target only applies with --approx")
        return EXIT_USAGE

    backend, code = _static_rung(args)
    if backend is None:
        return code
    # MPI_Init's analogue: joins the process group a launcher (or torchrun)
    # describes, so --persona mpi spans its processes; a no-op otherwise.
    from knn_tpu_torch.parallel.mesh import maybe_init_distributed

    try:
        maybe_init_distributed(args.device)
    except ResilienceError as e:
        _error(f"{type(e).__name__}: {e}")
        return EXIT_RUNTIME
    try:
        train = load_arff(args.train)
        test = load_arff(args.test)
        train.validate_for_knn(args.k, test)
    except (OSError, ValueError) as e:
        _error(e)
        return EXIT_USAGE

    opts = {"device": args.device, "query_tile": args.query_tile,
            "train_tile": args.train_tile}
    if args.metric != "euclidean":
        opts["metric"] = args.metric
    if args.query_batch is not None:
        opts["query_batch"] = args.query_batch
    if args.precision != "auto":
        opts["precision"] = args.precision
    if args.engine != "auto":
        opts["engine"] = args.engine
    if args.approx:
        opts["approx"] = True
    if args.recall_target is not None:
        opts["recall_target"] = args.recall_target
    if args.threads is not None:
        opts["num_threads"] = args.threads
    if args.devices is not None:
        opts["num_devices"] = args.devices
    try:
        if args.warmup:
            warm = degrade.predict_with_ladder(
                backend, train, test, args.k, opts,
                no_fallback=args.no_fallback)
            # Time from the rung (and query_batch) the warmup survived on,
            # so the timed region measures that configuration rather than
            # re-walking the failures.
            backend, opts = warm.backend, warm.opts
        with _maybe_capture(args.profile_out) as capture:
            with maybe_profile(args.trace_dir):
                with RegionTimer() as t:
                    with obs.span("classify",
                                  backend=backend) as classify_span:
                        result = degrade.predict_with_ladder(
                            backend, train, test, args.k, opts,
                            no_fallback=args.no_fallback)
    except ResilienceError as e:
        # A card rung's failure, the ladder exhausted, or --no-fallback.
        _error(f"{type(e).__name__}: {e}")
        return EXIT_RUNTIME
    except (ValueError, RuntimeError) as e:  # e.g. a metric the rung lacks
        _error(e)
        return EXIT_RUNTIME
    predictions = result.predictions

    acc = accuracy(confusion_matrix(predictions, test.labels, test.num_classes))
    print(result_line(args.k, test.num_instances, train.num_instances, t.ms, acc),
          file=stdout)
    if args.dump_predictions and not _dump_predictions(args.dump_predictions,
                                                       predictions):
        return EXIT_RUNTIME
    if args.json:
        print(result_json(args.k, test.num_instances, train.num_instances, t.ms,
                          acc, result.backend, phases=_phases(classify_span)),
              file=stdout)
    # The artifact records the precise region wall (float ms); the result
    # line keeps the reference's integer-floor contract.
    if not _write_obs_artifacts(args, classify_span, round(t.ns / 1e6, 3)):
        return EXIT_RUNTIME
    if capture is not None and not _write_profile(args.profile_out, capture):
        return EXIT_RUNTIME
    return 0


def _run_save_index(args, stdout) -> int:
    """``save-index TRAIN OUT``: parse once, write the versioned artifact
    ``serve`` boots from (the JAX package's format). Bad inputs (missing
    or malformed ARFF, bad k, unknown backend, a clobber target that is
    not an artifact) exit 2; a write failure mid-save exits 1."""
    from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor
    from knn_tpu_torch.serve.artifact import save_index

    if args.family == "classifier" and not degrade.known_backend(args.backend):
        _error(f"backend '{args.backend}' unavailable")
        return EXIT_USAGE
    if args.ivf_cells is not None:
        # Partition-build validation BEFORE the parse: flag contradictions
        # are usage errors, not compute failures.
        if args.ivf_cells < 1:
            _error(f"--ivf-cells must be >= 1, got {args.ivf_cells}")
            return EXIT_USAGE
        if args.metric != "euclidean":
            _error(f"--ivf-cells partitions by squared-euclidean k-means; "
                   f"--metric {args.metric} would probe cells under the "
                   f"wrong geometry (docs/INDEXES.md)")
            return EXIT_USAGE
        if args.ivf_iters < 1:
            _error(f"--ivf-iters must be >= 1, got {args.ivf_iters}")
            return EXIT_USAGE
    try:
        train = load_arff(args.train)
        if args.family == "classifier":
            opts = {} if args.engine == "auto" else {"engine": args.engine}
            model = KNNClassifier(
                args.k, backend=args.backend, metric=args.metric,
                weights=args.weights, **opts,
            )
        else:
            model = KNNRegressor(
                args.k, weights=args.weights, metric=args.metric,
                engine=args.engine,
            )
        model.fit(train)
    except (OSError, ValueError) as e:
        _error(e)
        return EXIT_USAGE
    ivf = None
    if args.ivf_cells is not None:
        if args.ivf_cells > train.num_instances:
            _error(f"--ivf-cells {args.ivf_cells} exceeds the train rows "
                   f"({train.num_instances})")
            return EXIT_USAGE
        from knn_tpu_torch.index.ivf import IVFIndex

        try:
            ivf = IVFIndex.build(
                train.features, args.ivf_cells, seed=args.ivf_seed,
                iters=args.ivf_iters, device=args.device,
            )
        except ResilienceError as e:  # no card, a failed assignment step
            _error(f"{type(e).__name__}: {e}")
            return EXIT_RUNTIME
    try:
        out = save_index(model, args.out, ivf=ivf)
    except ValueError as e:  # clobber refusal / non-directory target
        _error(e)
        return EXIT_USAGE
    except OSError as e:  # the write itself failed
        _error(e)
        return EXIT_RUNTIME
    ivf_note = ""
    if ivf is not None:
        ivf_note = (f", ivf_cells={ivf.num_cells} "
                    f"(imbalance {ivf.imbalance()}, "
                    f"{ivf.meta['iterations']} iters)")
    print(
        f"wrote index {out}: {train.num_instances} rows x "
        f"{train.num_features} features, family={args.family}, "
        f"k={args.k}{ivf_note}",
        file=stdout,
    )
    return 0


def _int_list(raw: str) -> "list[int]":
    """Sorted distinct positive integers of a comma list; ValueError
    otherwise."""
    out = sorted({int(s) for s in raw.split(",") if s})
    if not out or out[0] < 1:
        raise ValueError(raw)
    return out


def _serve_batch_buckets(args) -> "tuple[tuple | None, str | None]":
    """The server's bucket ladder from ``--batch-buckets``: always topped
    by ``--max-batch`` (every admissible batch stages onto a warmed
    bucket); buckets past ``--max-batch`` are refused."""
    from knn_tpu_torch.models.knn import DEFAULT_BATCH_BUCKETS

    if args.batch_buckets == "off":
        return None, None
    if args.batch_buckets == "auto":
        return tuple(sorted({b for b in DEFAULT_BATCH_BUCKETS
                             if b < args.max_batch} | {args.max_batch})), None
    try:
        parsed = _int_list(args.batch_buckets)
    except ValueError:
        return None, (f"--batch-buckets wants positive integers (or 'auto' "
                      f"/ 'off'), got {args.batch_buckets!r}")
    if parsed[-1] > args.max_batch:
        return None, (f"--batch-buckets {parsed[-1]} exceeds --max-batch "
                      f"{args.max_batch}; no batch can ever fill that "
                      f"bucket")
    return tuple(sorted({*parsed, args.max_batch})), None


def _serve_shards(args) -> "tuple[int | None, str | None]":
    """``--shards``: None (unset), a positive count, or ``auto`` — one shard
    per visible card (one on ``--device cpu``)."""
    if args.shards is None:
        return None, None
    if str(args.shards).lower() == "auto":
        if args.device == "cpu":
            return 1, None
        import torch

        return max(1, torch.cuda.device_count()), None
    try:
        shards = int(args.shards)
        if shards < 1:
            raise ValueError
    except ValueError:
        return None, (f"--shards wants a positive integer or 'auto', got "
                      f"{args.shards!r}")
    return shards, None


def _run_serve(args, stdout) -> int:
    """``serve INDEX``: load the artifact, warm every batch shape on the
    card, then serve until SIGINT/SIGTERM. Bad policy values or a bad
    artifact exit 2 before any compute; bind/warmup failures exit 1 (a
    missing card fails the warmup)."""
    from knn_tpu_torch.resilience.errors import DataError
    from knn_tpu_torch.serve.server import control_flag_error

    for bad, msg in (
        (args.max_batch < 1, f"--max-batch must be >= 1, got {args.max_batch}"),
        (args.max_wait_ms < 0,
         f"--max-wait-ms must be >= 0, got {args.max_wait_ms}"),
        (args.max_queue_rows < args.max_batch,
         f"--max-queue-rows ({args.max_queue_rows}) must be >= --max-batch "
         f"({args.max_batch})"),
        (args.deadline_ms is not None and args.deadline_ms <= 0,
         f"--deadline-ms must be > 0, got {args.deadline_ms}"),
        (args.drain_timeout_s <= 0,
         f"--drain-timeout-s must be > 0, got {args.drain_timeout_s}"),
        (not 0 <= args.port <= 65535, f"--port out of range: {args.port}"),
        (args.flight_recorder_size < 0,
         f"--flight-recorder-size must be >= 0, got "
         f"{args.flight_recorder_size}"),
        (args.slowest_k < 0, f"--slowest-k must be >= 0, got {args.slowest_k}"),
        (not 0 < args.slo_availability_target < 1,
         f"--slo-availability-target must be in (0, 1), got "
         f"{args.slo_availability_target}"),
        (not 0 < args.slo_latency_target < 1,
         f"--slo-latency-target must be in (0, 1), got "
         f"{args.slo_latency_target}"),
        (not 0 < args.slo_fast_rung_target < 1,
         f"--slo-fast-rung-target must be in (0, 1), got "
         f"{args.slo_fast_rung_target}"),
        (args.slo_latency_ms <= 0,
         f"--slo-latency-ms must be > 0, got {args.slo_latency_ms}"),
        (not 0 < args.slo_quality_target < 1,
         f"--slo-quality-target must be in (0, 1), got "
         f"{args.slo_quality_target}"),
        (args.capacity_window_s < 5,
         f"--capacity-window-s must be >= 5 (shorter windows make every "
         f"rate gauge noise), got {args.capacity_window_s}"),
        (args.result_cache_rows < 0,
         f"--result-cache-rows must be >= 0, got "
         f"{args.result_cache_rows}"),
        (args.ivf_probes is not None and args.ivf_probes < 1,
         f"--ivf-probes must be >= 1, got {args.ivf_probes}"),
        (not 0 < args.ivf_recall_floor <= 1,
         f"--ivf-recall-floor must be in (0, 1], got "
         f"{args.ivf_recall_floor}"),
        (not 0 <= args.shadow_rate <= 1,
         f"--shadow-rate must be in [0, 1], got {args.shadow_rate}"),
        (not 0 <= args.drift_rate <= 1,
         f"--drift-rate must be in [0, 1], got {args.drift_rate}"),
        (args.quality_queue < 1,
         f"--quality-queue must be >= 1, got {args.quality_queue}"),
        (not 0 < args.capture_rate <= 1,
         f"--capture-rate must be in (0, 1], got {args.capture_rate}"),
        (args.capture_max_requests < 1,
         f"--capture-max-requests must be >= 1, got "
         f"{args.capture_max_requests}"),
        (args.capture_queue < 1,
         f"--capture-queue must be >= 1, got {args.capture_queue}"),
        (args.capture_burn_threshold is not None
         and args.capture_burn_threshold <= 0,
         f"--capture-burn-threshold must be > 0, got "
         f"{args.capture_burn_threshold}"),
        (args.capture_burn_window_s <= 0,
         f"--capture-burn-window-s must be > 0, got "
         f"{args.capture_burn_window_s}"),
        (args.capture_burn_threshold is not None
         and args.capture_dir is None,
         "--capture-burn-threshold needs --capture-dir (the trigger "
         "has nowhere to write its artifact)"),
        (args.delta_cap < 1,
         f"--delta-cap must be >= 1, got {args.delta_cap}"),
        (args.compact_threshold < 1,
         f"--compact-threshold must be >= 1, got "
         f"{args.compact_threshold}"),
        (args.compact_interval_s < 0,
         f"--compact-interval-s must be >= 0, got "
         f"{args.compact_interval_s}"),
    ):
        if bad:
            _error(msg)
            return EXIT_USAGE
    err = control_flag_error(
        cost_accounting=args.cost_accounting == "on",
        priority=args.priority is not None,
        autotune_interval_s=args.autotune_interval_s,
        capture_dir=args.capture_dir,
        history_interval_s=args.history_interval_s,
        history_retention_s=args.history_retention_s)
    if err is not None:
        _error(err)
        return EXIT_USAGE
    alert_rules, err = _load_alert_rules(args)
    if err is not None:
        _error(err)
        return EXIT_USAGE
    priority_map = None
    if args.priority is not None:
        from knn_tpu_torch.control.admission import parse_priority_map

        try:
            priority_map = parse_priority_map(args.priority)
        except ValueError as e:
            _error(f"--priority: {e}")
            return EXIT_USAGE
    slo_windows = None
    if args.slo_windows is not None:
        try:
            slo_windows = _int_list(args.slo_windows)
        except ValueError:
            _error(f"--slo-windows wants positive integer seconds, got "
                   f"{args.slo_windows!r}")
            return EXIT_USAGE
    warmup_batches = None
    if args.warmup_batches is not None:
        try:
            warmup_batches = _int_list(args.warmup_batches)
        except ValueError:
            _error(f"--warmup-batches wants positive integers, got "
                   f"{args.warmup_batches!r}")
            return EXIT_USAGE
    batch_buckets, err = _serve_batch_buckets(args)
    if err is not None:
        _error(err)
        return EXIT_USAGE
    shards, err = _serve_shards(args)
    if err is not None:
        _error(err)
        return EXIT_USAGE
    from knn_tpu_torch.serve import artifact
    from knn_tpu_torch.serve.server import ServeApp, make_server, serve_forever

    mutable_on = args.mutable == "on"
    try:
        if mutable_on:
            # The mutable tier owns the artifact's lifecycle: boot from the
            # generation CURRENT.json names (the root artifact when never
            # compacted); the engine replays the newer epoch records.
            base_dir, current = artifact.resolve_mutable_base(args.index)
        else:
            base_dir, current = args.index, None
        model = artifact.load_index(base_dir, device=args.device)
        manifest = artifact.read_manifest(base_dir)
        version = artifact.index_version(manifest)
    except DataError as e:
        _error(e)
        return EXIT_USAGE
    # The /metrics endpoint is this process's observability artifact.
    obs.enable()
    from knn_tpu_torch.obs.slo import DEFAULT_WINDOWS_S, SLOTracker

    slo = SLOTracker(
        availability_target=args.slo_availability_target,
        latency_target_ms=args.slo_latency_ms,
        latency_target=args.slo_latency_target,
        fast_rung_target=args.slo_fast_rung_target,
        quality_target=args.slo_quality_target,
        windows_s=slo_windows or DEFAULT_WINDOWS_S,
    )
    try:
        app = ServeApp(
            model, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_queue_rows=args.max_queue_rows, deadline_ms=args.deadline_ms,
            index_path=args.index, index_version=version,
            flight_recorder_size=args.flight_recorder_size,
            slowest_k=args.slowest_k, access_log=args.access_log, slo=slo,
            cost_accounting=(args.cost_accounting == "on"),
            capacity_window_s=args.capacity_window_s,
            batch_buckets=batch_buckets,
            result_cache_rows=args.result_cache_rows, device=args.device,
            ivf_probes=args.ivf_probes,
            ivf_recall_floor=args.ivf_recall_floor,
            shadow_rate=args.shadow_rate, drift_rate=args.drift_rate,
            quality_queue=args.quality_queue, quality_seed=args.quality_seed,
            reference_sketch=artifact.reference_sketch(manifest),
            capture_dir=args.capture_dir,
            capture_rate=args.capture_rate,
            capture_max_requests=args.capture_max_requests,
            capture_queue=args.capture_queue,
            capture_burn_threshold=args.capture_burn_threshold,
            capture_burn_objective=args.capture_burn_objective,
            capture_burn_window_s=args.capture_burn_window_s,
            mutable=mutable_on, delta_cap=args.delta_cap,
            compact_threshold=args.compact_threshold,
            compact_interval_s=args.compact_interval_s,
            mutable_current=current,
            mutable_base_dir=base_dir if mutable_on else None,
            shards=shards, priority_map=priority_map,
            brownout=(args.brownout == "on"),
            autotune_interval_s=args.autotune_interval_s,
            history_dir=args.history_dir,
            history_interval_s=args.history_interval_s,
            history_retention_s=args.history_retention_s,
            alert_rules=alert_rules,
        )
    except OSError as e:  # an unwritable --access-log / --capture-dir path
        _error(e)
        return EXIT_USAGE
    except DataError as e:  # --ivf-probes on an exact-only artifact, a bad WAL
        _error(e)
        return EXIT_USAGE
    except ValueError as e:  # a malformed/mismatched manifest drift sketch
        _error(f"{args.index}: {e}")
        return EXIT_USAGE
    try:
        server = make_server(app, args.host, args.port)
    except OSError as e:
        _error(f"cannot bind {args.host}:{args.port}: {e}")
        app.close()
        return EXIT_RUNTIME
    host, port = server.server_address[:2]
    try:
        warmed = app.warm(warmup_batches)
    except (ResilienceError, ValueError, RuntimeError) as e:
        _error(f"warmup failed: {type(e).__name__}: {e}")
        server.server_close()
        app.close()
        return EXIT_RUNTIME
    bucket_note = ""
    if batch_buckets is not None:
        bucket_note = f", buckets={'/'.join(str(b) for b in batch_buckets)}"
    if args.result_cache_rows > 0:
        bucket_note += f", result_cache_rows={args.result_cache_rows}"
    if app.ivf is not None:
        bucket_note += (f", ivf_probes={args.ivf_probes}/"
                        f"{model.ivf_.num_cells}")
    if app.shards is not None:
        bucket_note += f", shards={app.shards}"
    if app.mutable is not None:
        m = app.mutable.export()
        bucket_note += (f", mutable=on (gen={m['generation']}, "
                        f"epoch={m['epoch']}, "
                        f"replayed_delta={m['delta_slots']}, "
                        f"delta_cap={args.delta_cap})")
    if app.admission is not None:
        bucket_note += ", priority=" + "/".join(
            f"{c}:{level}" for c, level in sorted(priority_map.items()))
    if app.brownout is not None:
        bucket_note += ", brownout=" + "+".join(
            s.name for s in app.brownout.steps)
    if app.autotune is not None:
        bucket_note += f", autotune={args.autotune_interval_s:g}s"
    print(
        f"knn-tpu serve: ready on http://{host}:{port} "
        f"(family={app.family}, k={model.k}, "
        f"train_rows={model.train_.num_instances}, "
        f"index_version={version}, device={args.device}{bucket_note}, "
        f"warmed={sorted(warmed)})",
        file=stdout, flush=True,
    )
    return serve_forever(server, drain_timeout_s=args.drain_timeout_s)


def _load_alert_rules(args):
    """Parse ``--alert-rules`` (None when unset): ``(rules, None)`` or
    ``(None, error)``. Every failure is a pre-boot usage error (exit 2),
    including an action whose layer the other flags left off."""
    if args.alert_rules is None:
        return None, None
    from knn_tpu_torch.obs.alerts import load_rules
    from knn_tpu_torch.resilience.errors import DataError

    try:
        rules = load_rules(args.alert_rules)
    except DataError as e:
        return None, str(e)
    actions = {a["do"] for r in rules for a in r["actions"]}
    if args.history_dir is None and "profile" in actions:
        return None, ("--alert-rules: profile actions write under "
                      "--history-dir; set it")
    if args.capture_dir is None and "capture" in actions:
        return None, ("--alert-rules: capture actions arm the workload "
                      "recorder; set --capture-dir")
    return rules, None


def _parse_window_arg(raw) -> "tuple[float | None, str | None]":
    """``--window`` of ``history``/``report``: ``(seconds, None)``,
    ``(None, None)`` when unset, or ``(None, error)``."""
    if raw is None:
        return None, None
    from knn_tpu_torch.obs.history import parse_window

    try:
        return parse_window(raw), None
    except ValueError as e:
        return None, f"--window: {e}"


def _run_history(args, stdout) -> int:
    """``history DIR``: decode a (possibly dead) serve's segment ring,
    repairing a torn final segment, and answer a range query. Unreadable
    or corrupt history and bad filters exit 2."""
    from knn_tpu_torch.obs.history import load_history
    from knn_tpu_torch.resilience.errors import DataError

    labels = {}
    for item in args.label:
        k, sep, v = item.partition("=")
        if not sep or not k:
            _error(f"--label {item!r}: want K=V")
            return EXIT_USAGE
        labels[k] = v
    window_s, err = _parse_window_arg(args.window)
    if err is not None:
        _error(err)
        return EXIT_USAGE
    try:
        hist = load_history(args.dir)
    except (DataError, OSError) as e:
        _error(e)
        return EXIT_USAGE
    doc = hist.query(metric=args.metric, labels=labels, window_s=window_s)
    doc["segments"] = len(hist.segments)
    doc["samples"] = len(hist.samples)
    doc["repaired_torn_tail"] = hist.repaired
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True), file=stdout)
        return 0
    w = doc["window"]
    print(f"knn-tpu history: {args.dir}: {doc['samples']} snapshot(s) in "
          f"{doc['segments']} segment(s), window {w['from']}..{w['to']}"
          + (" (torn tail repaired)" if hist.repaired else ""),
          file=stdout)
    for s in doc["series"]:
        labels_txt = ",".join(f"{k}={v}"
                              for k, v in sorted(s["labels"].items()))
        pts = s["points"]
        if not pts:
            continue
        first, last = pts[0], pts[-1]
        print(f"  {s['name']}{{{labels_txt}}} [{s['kind']}] "
              f"{len(pts)} point(s): {first[1]} @ {first[0]} -> "
              f"{last[1]} @ {last[0]}", file=stdout)
    if not doc["series"]:
        print("  (no matching series)", file=stdout)
    return 0


def _run_report(args, stdout) -> int:
    """``report --history DIR``: the one-command incident report. Missing
    or corrupt inputs exit 2; the output is deterministic (every timestamp
    comes from the artifacts)."""
    from knn_tpu_torch.obs.report import build_report, render_markdown
    from knn_tpu_torch.resilience.errors import DataError

    window_s, err = _parse_window_arg(args.window)
    if err is not None:
        _error(err)
        return EXIT_USAGE
    try:
        doc = build_report(args.history, window=window_s,
                           access_log=args.access_log,
                           captures=args.captures)
    except (DataError, OSError) as e:
        _error(e)
        return EXIT_USAGE
    md = render_markdown(doc)
    if args.json_out is not None:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
    if args.out is not None:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(md)
        print(f"knn-tpu report: wrote {args.out}"
              + (f" and {args.json_out}" if args.json_out else ""),
              file=stdout)
    else:
        print(md, file=stdout)
    return 0


def _run_replay(args, stdout) -> int:
    """``replay WORKLOAD (--url BASE | --index DIR)``: re-drive a captured
    workload and print/write the verdict JSON. A bad workload or index
    artifact, or a flag the port cannot honor, exits 2 before any
    compute; a replay that cannot run exits 1; a completed replay exits 0
    — unless ``--fail-on-divergence`` and a verified answer diverged."""
    from knn_tpu_torch.obs.replay import replay_workload
    from knn_tpu_torch.obs.workload import load_workload
    from knn_tpu_torch.resilience.errors import DataError

    for bad, msg in (
        (args.speed < 0, f"--speed must be >= 0, got {args.speed}"),
        (args.max_batch is not None and args.max_batch < 1,
         f"--max-batch must be >= 1, got {args.max_batch}"),
        (args.max_wait_ms is not None and args.max_wait_ms < 0,
         f"--max-wait-ms must be >= 0, got {args.max_wait_ms}"),
        (args.url is not None and args.mutable == "on",
         "--mutable applies to the in-process --index mode only (a live "
         "server owns its own mutable engine)"),
    ):
        if bad:
            _error(msg)
            return EXIT_USAGE
    try:
        wl = load_workload(args.workload)
    except DataError as e:
        _error(e)
        return EXIT_USAGE
    policy = wl.manifest.get("policy") or {}
    batcher = None
    engine = None
    try:
        if args.index is not None:
            from knn_tpu_torch.obs.capacity import CapacityTracker
            from knn_tpu_torch.serve import artifact
            from knn_tpu_torch.serve.batcher import MicroBatcher

            try:
                model = artifact.load_index(args.index, device=args.device)
                version = artifact.index_version(
                    artifact.read_manifest(args.index))
            except DataError as e:
                _error(e)
                return EXIT_USAGE
            if model.train_.num_features != wl.manifest["num_features"]:
                _error(f"{args.index}: feature width "
                       f"{model.train_.num_features} does not match the "
                       f"workload's {wl.manifest['num_features']} — this "
                       f"workload was captured against a different schema")
                return EXIT_USAGE
            max_batch = args.max_batch or policy.get("max_batch") or 256
            max_wait = (args.max_wait_ms if args.max_wait_ms is not None
                        else policy.get("max_wait_ms", 2.0))
            replay_mutations = args.mutable == "on"
            if wl.manifest.get("mutations", 0) > 0 and not replay_mutations:
                print(f"warning: the workload carries "
                      f"{wl.manifest['mutations']} mutations but --mutable "
                      f"is off; skipping them (reads still replay; their "
                      f"mutation_seq tags will not match)", file=sys.stderr)
            if replay_mutations:
                from knn_tpu_torch.mutable.engine import MutableEngine

                try:
                    engine = MutableEngine(model, args.index,
                                           version=version)
                except DataError as e:
                    _error(e)
                    return EXIT_USAGE
            capacity = CapacityTracker(max_batch)
            artifact.warmup(model, batch_sizes=(1, max_batch),
                            kinds=("predict",))
            batcher = MicroBatcher(
                model, max_batch=max_batch, max_wait_ms=max_wait,
                max_queue_rows=max(4096, max_batch), index_version=version,
                capacity=capacity, mutable=engine,
            )
            verdict = replay_workload(
                wl, batcher=batcher, speed=args.speed, verify=args.verify,
                replay_mutations=replay_mutations)
            verdict["capacity"] = capacity.export()
        else:
            verdict = replay_workload(wl, base_url=args.url.rstrip("/"),
                                      speed=args.speed, verify=args.verify)
    except ResilienceError as e:  # no card, a failed build or launch
        _error(f"replay failed: {type(e).__name__}: {e}")
        return EXIT_RUNTIME
    except (OSError, RuntimeError, ValueError) as e:
        _error(f"replay failed: {type(e).__name__}: {e}")
        return EXIT_RUNTIME
    finally:
        if batcher is not None:
            batcher.close()
        if engine is not None:
            engine.close()
    m, v = verdict["measured"], verdict["verify"]
    print(
        f"replayed {m['requests']} requests "
        f"({verdict['mutations']['fired']} mutations) at speed "
        f"{args.speed}: p50 {m['p50_ms']} ms / p99 {m['p99_ms']} ms / "
        f"{m['qps']} q/s; verified {v['verified']}, divergences "
        f"{v['divergences']}, tag-mismatch skipped "
        f"{v['skipped_tag_mismatch']}",
        file=stdout,
    )
    doc = json.dumps(verdict)
    if args.verdict_out:
        try:
            from pathlib import Path

            Path(args.verdict_out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.verdict_out, "w", encoding="utf-8") as f:
                f.write(doc + "\n")
        except OSError as e:
            _error(e)
            return EXIT_RUNTIME
    print(doc, file=stdout)
    if args.fail_on_divergence and v["divergences"] > 0:
        _error(f"{v['divergences']} verified answer(s) diverged from the "
               f"capture")
        return EXIT_RUNTIME
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
