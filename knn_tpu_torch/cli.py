"""CLI driver: the ``classify`` job of the JAX package's CLI, on the port.

``python -m knn_tpu_torch TRAIN TEST k`` (bare positional argv implies the
``classify`` subcommand) loads both ARFF files, classifies every test row
against the train rows, and prints the reference's result line
(main.cpp:146), timing the classify region only, parsing excluded. The
region ends after the predictions are back on the host, so it includes the
device work.

Flags: ``--backend {cuda,cuda-tile,oracle}`` (default ``cuda``: the twin of
``tpu``, the stripe route's kernels or the XLA scans; ``cuda-tile``: the
wide-feature rung, the twin of ``tpu-pallas``), ``--precision
{exact,fast,bf16,auto}`` (default ``exact``; ``auto`` passes nothing, so
the backend's own default applies, as in the JAX CLI), ``--metric
{euclidean,manhattan,chebyshev,cosine}``, ``--engine {auto,stripe,xla}``,
``--query-tile`` (256), ``--train-tile`` (2048) and ``--query-batch``, with
the JAX CLI's names and defaults (passed on as it passes them),
``--device {cuda,cpu}`` (default ``cuda``; ``cpu`` runs the kernels' plain
PyTorch versions), ``--warmup`` (one untimed run first: kernel build and
upload), ``--json`` (a structured line after the result line),
``--sweep-k K1,K2,...`` (every listed k from one retrieval at the largest,
``models/knn.py::sweep_k``: one result line per k, each with the whole
sweep's ms; the positional k is ignored; ``--backend``, a non-exact
``--precision``, ``--query-batch`` and non-default tiles are rejected with
one ``incompatible`` error before any file is read) and ``--dump-predictions
FILE.npy`` (the int32 predictions, written after the result line; with
``--sweep-k`` one file per k, ``FILE.k{K}.npy``).

Exit codes, as the JAX package's (knn_tpu/cli.py:45-54): 0 success; 2 the
input was rejected before classification (bad flags, bad k, missing or
malformed files, mismatched feature counts); 1 the computation failed — on
``cuda`` that includes a missing card or a failing kernel, with no fallback
to another backend or to the host. Errors are one ``error:`` line on
stderr.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from knn_tpu_torch.data.arff import load_arff
from knn_tpu_torch.resilience.errors import ResilienceError
from knn_tpu_torch.utils.cli_format import result_json, result_line
from knn_tpu_torch.utils.evaluate import accuracy, confusion_matrix
from knn_tpu_torch.utils.timing import RegionTimer

EXIT_USAGE = 2
EXIT_RUNTIME = 1

_SUBCOMMANDS = ("classify",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="knn_tpu_torch",
        description="KNN classify on a CUDA card (PyTorch port of knn_tpu)",
    )
    sub = p.add_subparsers(dest="command", metavar="{classify}")
    c = sub.add_parser(
        "classify",
        help="one-shot classify (bare positional argv implies it)",
        description="Reference-parity KNN classifier",
    )
    c.add_argument("train", help="train ARFF file")
    c.add_argument("test", help="test ARFF file")
    c.add_argument("k", type=int, help="number of neighbors")
    c.add_argument("--backend", choices=["cuda", "cuda-tile", "oracle"],
                   default=None,
                   help="cuda: the stripe kernels or the XLA scans, as tpu "
                   "(default); cuda-tile: the wide-feature rung; oracle: numpy")
    c.add_argument("--precision", choices=["exact", "fast", "bf16", "auto"],
                   default="exact",
                   help="distance form: exact (reference parity), fast "
                   "(matmul expansion), bf16 (bfloat16 cross term), auto "
                   "(defer to the backend's default)")
    c.add_argument("--metric",
                   choices=["euclidean", "manhattan", "chebyshev", "cosine"],
                   default="euclidean",
                   help="distance metric (euclidean = reference semantics)")
    c.add_argument("--engine", choices=["auto", "stripe", "xla"],
                   default="auto",
                   help="candidate route of the cuda backend: auto (the "
                   "stripe kernels where the tpu backend takes them), stripe "
                   "(the kernels at any k), xla (the tiled scan)")
    c.add_argument("--query-tile", type=int, default=256)
    c.add_argument("--train-tile", type=int, default=2048)
    c.add_argument("--query-batch", type=int, default=None,
                   help="stream queries through the device in chunks of this "
                   "size (bounds device memory for huge query sets)")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the cuda backend runs (cpu: its plain "
                   "PyTorch version)")
    c.add_argument("--warmup", action="store_true",
                   help="run once before timing (excludes build and upload)")
    c.add_argument(
        "--sweep-k", default=None, metavar="K1,K2,...",
        help="classify at every listed k from ONE shared retrieval "
        "(positional k is ignored): prints the result line per k, each "
        "reporting the whole sweep's time. Runs the exact retrieval with "
        "--engine auto/stripe/xla, --metric and --device; --backend, a "
        "non-exact --precision, --query-batch and tile knobs are rejected")
    c.add_argument(
        "--dump-predictions", default=None, metavar="FILE.npy",
        help="save the int32 prediction vector (with --sweep-k: one file per "
        "k, FILE.k{K}.npy)")
    c.add_argument("--json", action="store_true",
                   help="emit structured JSON metrics")
    return p


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
    stdout = stdout or sys.stdout
    try:
        args = build_parser().parse_args(_normalize_argv(argv))
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else EXIT_USAGE
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
        ("--precision", args.precision not in ("exact", "auto")),
        ("--query-batch", args.query_batch is not None),
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
        with RegionTimer() as t:
            preds_by_k = sweep_k(train, test, ks, **opts)
    except ResilienceError as e:
        _error(f"{type(e).__name__}: {e}")
        return EXIT_RUNTIME
    except (ValueError, RuntimeError) as e:
        _error(e)
        return EXIT_RUNTIME
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
                              t.ms, acc, f"sweep:{args.engine}"), file=stdout)
        if base and not _dump_predictions(f"{base}.k{k}.npy", preds_by_k[k]):
            return EXIT_RUNTIME
    return 0


def _run_classify(args, stdout) -> int:
    from knn_tpu_torch.backends import get_backend

    if args.sweep_k is not None:
        ks, err = _sweep_ks(args)
        if err is not None:
            _error(err)
            return EXIT_USAGE
        return _run_sweep(args, ks, stdout)
    try:
        train = load_arff(args.train)
        test = load_arff(args.test)
        train.validate_for_knn(args.k, test)
    except (OSError, ValueError) as e:
        _error(e)
        return EXIT_USAGE

    backend = args.backend or "cuda"
    predict = get_backend(backend)
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
    try:
        if args.warmup:
            predict(train, test, args.k, **opts)
        with RegionTimer() as t:
            predictions = predict(train, test, args.k, **opts)
    except ResilienceError as e:
        _error(f"{type(e).__name__}: {e}")
        return EXIT_RUNTIME
    except (ValueError, RuntimeError) as e:  # an unported option, a CUDA error
        _error(e)
        return EXIT_RUNTIME

    acc = accuracy(confusion_matrix(predictions, test.labels, test.num_classes))
    print(result_line(args.k, test.num_instances, train.num_instances, t.ms, acc),
          file=stdout)
    if args.dump_predictions and not _dump_predictions(args.dump_predictions,
                                                       predictions):
        return EXIT_RUNTIME
    if args.json:
        print(result_json(args.k, test.num_instances, train.num_instances, t.ms,
                          acc, backend), file=stdout)
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
