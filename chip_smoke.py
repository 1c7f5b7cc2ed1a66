#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``knn_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, each printed as it runs; any failure exits non-zero:

1. ``env``            — card name and power limit (nvidia-smi), versions.
2. ``build``          — every ``knn_tpu_torch/csrc/*.cu`` built with nvcc,
                        one process per source, all started together.
3. ``kernel_parity``  — the stripe scan and merge kernels, and the two
                        together, against their plain PyTorch versions on
                        the card: bit-equal keys and distances, equal indices.
4. ``kernel_parity_tile`` — the tile kernels in their three forms against
                        their plain version: bit-equal keys on integer grids
                        (and in the exact form on float rows), the stated
                        tolerance on float rows in the matmul forms; the
                        bf16 (wgmma) kernel at d from 1 to 1,000, k up to
                        1,000, both train stores, two split layouts.
5. ``kernel_parity_select`` — the stripe scan's selection variants (rounds,
                        lite, nosel) against their plain versions, bit-equal
                        keys, at split_plan's layout and at splits of
                        several 64-row tiles; rounds and lite merged,
                        bit-equal to the shipped knn_stripe_candidates.
6. ``kernel_parity_matmul`` — the bf16 tensor-core matmul (P1, wgmma)
                        against its plain version: bit-equal on integer
                        grids, the stated bound on float rows; block_n
                        from 8 to 1,024, N and D off the tile sizes.
7. ``kernel_parity_bigk`` — the merge and the tile scan's three forms at
                        k in BIGK_PARITY (17 up to 4,096 and k = n_valid),
                        at the tile kernel's split plan and at forced plans,
                        against their plain versions.
8. ``classify_large`` — the main path, ``knn_tpu_torch.cli.run``, on the
                        large-fixture shape written as ARFF under build/.
9. ``classify_xl``    — the stripe kernels and their plain versions on
                        ~1.02 M train rows: equal results, timed.
10. ``classify_wide`` — the wide-feature rung (bench.py's mnist784 shape):
                        ``cli.run --backend cuda-tile --precision auto``,
                        then the exact and bf16 forms through the backend,
                        each with the launch counters read around it; the
                        predictions against the plain versions and the
                        oracle; each form timed beside its plain version,
                        the bare cross-term matmul and its bound.
11. ``classify_bigk`` — ``cli.run --backend cuda-tile`` at k = 32 on the
                        large shape (the tile kernel's merge route), the
                        counters read around it; predictions against the
                        plain version and the oracle; the tile scan, the
                        merge and ``torch.topk`` timed at k = 32, 256, 1000;
                        the bf16 form through the backend at k = 32 and
                        256, held to its plain version and timed.
12. ``classify_xla``  — ``cli.run --backend cuda`` on the large shape
                        through the XLA route (torch ops, no hand kernel):
                        ``--engine xla`` at k = 32 (the tiled scan) and
                        k = 5, ``--metric cosine`` at k = 32; predictions
                        against the oracle and ``cuda-tile``; the route
                        timed beside ``cuda-tile``. Then ``--backend cuda``
                        at k = 32 with the default engine, which sends
                        euclidean problems to the kernels: the tile kernel's
                        counters move, predictions equal ``cuda-tile``'s
                        and the oracle's, and its result line is no slower
                        than ``cuda-tile``'s.
13. ``models``        — the model layer (``knn_tpu_torch.models.knn``) at the
                        shapes of bench.py's ``kneighbors`` and ``sweepk``
                        configs, the launch counters read around each call:
                        ``KNNClassifier.kneighbors`` on the large shape
                        (engine auto: the stripe kernels; ``xla`` and
                        manhattan: no hand kernel) against the oracle and the
                        plain version; 109,952 and 659,712 queries;
                        ``kneighbors_async``; ``radius_neighbors`` (the tile
                        scan at k = 128); ``--sweep-k 1,5,10`` through the
                        CLI (one retrieval's launches) with
                        ``--dump-predictions``; the sweep against three
                        predicts at large and xl; ``KNNRegressor`` and the
                        distance-weighted vote on xl. Each timed.
14. ``cli_ladder``    — the rest of the classify command through
                        ``cli.run`` on the large fixture, the counters read
                        around each call: the default path with --json,
                        --metrics-out and --trace-out (stripe scan and merge
                        twice each, the phases against the region, obs off
                        and on in turns); --persona main and multi-thread 8
                        (the native rungs: no kernel, equal predictions);
                        faults injected on the card rung (once: recovered
                        with one retry; always: exit 1, one typed error, no
                        host rung; once:oom: query_batch halved, at k = 5
                        and, rerunning the tile kernel, at k = 32 and at the
                        wide files' exact form); --approx;
                        the native ARFF parser against the pure-Python one
                        on the large and wide files (byte-equal, MB/s).
15. ``serve``         — ``save-index`` and ``serve`` on the card: index
                        artifacts of the large fixture (through the CLI),
                        xl and wide; an in-process ``ServeApp`` on xl under
                        closed-loop HTTP clients from another process
                        (single-row ``/predict`` at c = 1, 8 and 32, 64-row
                        requests at c = 8, ``/kneighbors``), the stripe
                        scan's and the merge's launches equal to the
                        dispatched batches, every answer equal to the
                        synchronous retrieval's and the oracle's, latency,
                        q/s, batch sizes and the dispatch's breakdown; the
                        ``serve.dispatch`` faults (``once:oom`` halves
                        ``max_batch`` on the same kernels; ``always`` gives
                        typed 500s, the breaker opens, no kernel and no
                        other route answers, and it closes after the
                        cooldown); the card's memory over three reloads of
                        xl; the wide index through the tile kernel; then
                        ``python -m knn_tpu_torch serve`` as a subprocess
                        on the large index (banner, ``/healthz``, both
                        ``/metrics`` expositions, a request id resolved,
                        ``/debug/profile`` under load holding stripe-scan
                        kernel events, re-save + SIGHUP, SIGTERM).
16. ``probe_selection`` — P2's entry point
                        (``knn_tpu_torch.probes.tune_stripe_selection``) on
                        the large shape, counters read around it; each
                        selection's kernel, at that shape's layout, held
                        bit-equal to its plain version and timed beside it.
17. ``probe_wide``    — P1's entry point (``knn_tpu_torch.probes.
                        probe_mnist_r3``) at 65,536 x 784 with 2,048 queries,
                        the counter read around it; P1 held to its plain
                        version at block_n 8, 256 and 1,024, and timed
                        beside it and the library's bfloat16 matmul with
                        float32 output.
18. ``ivf``           — the IVF index family at xl (1,024 cells): the
                        k-means build timed in its parts (k-means++ seeding
                        on the host, the assignment steps on the card, the
                        float64 updates), saved and loaded back; the
                        assignment on the card against its CPU version on a
                        65,536-row slice (equal but for counted near ties);
                        full probe with the device scorer bit-identical to
                        the oracle and equal to the stripe kernel's answer
                        (its launches counted around it); the two scorers
                        bit-identical at nprobe 32; recall@10 and q/s at
                        16-row dispatches at nprobe 8, 32 and 128 beside
                        the fast rung; the segment scorer, the assignment
                        step and the centroid ranking against their bounds
                        and library calls; the host and device scorers at
                        1-256 rows (the auto rule's crossing); then
                        ``ServeApp(ivf_probes=32)`` under closed-loop
                        clients (200 requests at c = 1, 800 at c = 8),
                        ``/healthz``'s ivf block, and one injected failure
                        of the ivf rung answered by the stripe kernels.
19. ``quality``       — answer quality, drift, workload capture and replay
                        (run after ``ivf``): ``ServeApp`` on the xl index
                        under closed-loop clients at c = 1 and 8 with the
                        layers off, then shadow scoring at 0.1 and at 1.0
                        with drift and an armed capture window (one stripe
                        scan and one merge per batch in every case, the
                        answers equal to the synchronous ones); the
                        shadow-scored recall, divergences and shed count,
                        the drift of the large test rows; corruption caught
                        and attributed to ``fast``; the exact rung against
                        the host oracle on xl and large rows, each
                        divergence a near tie by the ulp rule; the probe
                        policy's loop on the large fixture's IVF (176
                        cells, ``ivf_probes=1``, shadow rate 1.0): nprobe
                        widens, recall before and after; the captured xl
                        window replayed twice in process (zero
                        divergences); ``python -m knn_tpu_torch replay`` on
                        the committed fixture (120 ok, every predict
                        digest equal, each differing kneighbors answer the
                        oracle's within the ulp rule).
20. ``mutable``       — the mutable tier (run after ``quality``): the xl
                        index served ``--mutable on`` (``delta_cap`` 4,096,
                        threshold 16,384, no interval thread) — 200
                        single-row ``/predict`` and 16 ``/kneighbors``
                        byte-equal to ``--mutable off``, 1 stripe scan and
                        1 merge per batch; 1,024 inserts in bodies of 64,
                        256 base and 64 delta deletes, each write read back
                        at its ``mutation_seq``; 256 queries against the
                        merged oracle (indices but for near ties, distances
                        by the ulp rule), shadow scoring at 1.0; p50, p99,
                        q/s at c = 1 and 8 with the delta empty, after the
                        writes and full, launches per batch and the host
                        merge's share; the 429 past the cap; the delta tail
                        on the card (the large fixture, ``engine="xla"``,
                        k = 5: bit-equal to the host merge, no hand kernel)
                        and the fused delta segment scorer on the ivf
                        phase's partition (``--ivf-probes 32``: equal to the
                        host merge, recall@10 against the merged oracle);
                        B4's programs timed with CUDA events; compaction of
                        the exact index and the ivf artifact (the split of
                        its wall, the 256 queries the same before and after,
                        ``CURRENT.json`` and ``generations/gen-1``, the
                        ``incremental`` path); a compaction rolled back by
                        ``mutable.compact``; a restart over a torn epoch
                        record. One ``mutable: {...}`` JSON line.
21. ``sharded``       — multi-device (run after ``probe_wide``): at xl,
                        k = 10, ``cli.run --persona mpi``, ``--backend
                        cuda-train-sharded`` and ``--backend cuda-ring
                        --engine stripe`` on the visible cards, each equal
                        to ``--backend cuda``; the three engines on 2 and 4
                        logical shards of the card (and the torch-scan
                        engines on 4), equal to the single-card answer, the
                        stripe kernels launched per shard, the collectives'
                        bytes audited against the byte model, each timed;
                        on the large fixture the ring's ``full`` and
                        ``tiled`` engines and k = 32 through the tile
                        kernel on every engine; ``python -m
                        knn_tpu_torch.parallel.launch -np 2`` (gloo: the
                        ranks share the card) with its result line equal to
                        the single process's; ``ServeApp(shards=4)`` on the
                        xl index at c = 1 and 8 (answers byte-equal to
                        unsharded, launches 4 per batch, p50/p99/q/s beside
                        the ``serve`` phase's unsharded levels, the card's
                        memory with and without shards), with
                        ``ivf_probes=32`` and with ``--mutable on`` after
                        256 inserts and 64 deletes (equal to the unsharded
                        merged answers). With two or more cards, also the
                        engines across them and the launcher on NCCL. One
                        ``sharded: {...}`` JSON line.
22. ``control``       — the serving process's control plane and durable
                        history (after ``sharded``): single-row /predict
                        at c = 8 on the xl index with every flag off and
                        on, alternated over two rounds (the layers' host
                        cost, over the 200s); then ``ServeApp`` with
                        priority admission (interactive=0, batch=1),
                        brownout, shadow and drift sampling at 0.1, a
                        50 ms deadline, capture, autotune every 3 s,
                        history every 1 s and one alert rule, under
                        64-row ``batch`` requests sent open loop past the
                        sustainable rate beside closed-loop single-row
                        ``interactive`` (phase A), then ``interactive``
                        alone (phase B), clients in another process: every
                        200 equal to the synchronous answer, no answer but
                        a 200, a 504 or a policy shed of ``batch``,
                        ``batch`` shed by policy and ``interactive`` never,
                        the 504s by part and class with the top tier's
                        share bounded in A and B, the brownout down and
                        back, each applied autotune cycle replay-verified,
                        the alert's fire before its resolve with its
                        actions in event order, one scan and one merge per
                        batch, then ``history --json`` (its sample count
                        and widest gap) and ``report`` over the
                        directories.
23. ``kernels``       — one JSON line describing every kernel.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# Outside a checkout of the repository these imports fail: no result.
from knn_tpu_torch.obs.bench_timing import cuda_ms  # noqa: E402
from knn_tpu_torch.probes.data import (  # noqa: E402
    large_fixture,
    tiled_large,
    wide_data,
    write_arff,
)

# H100 SXM peaks (NVIDIA data sheet). Its FP32 rate outside the tensor
# cores, 67 TFLOP/s, counts a fused multiply-add as two operations; the
# kernels are built with --fmad=false and run sub, mul and add (and the
# key compare) as one instruction each, so their rate is half of it.
PEAK_FP32_INSTR = 67e12 / 2
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores
PEAK_HBM_BYTES = 3.35e12
# The k of kernel_parity_bigk ("n_valid": k equal to the valid rows) and the
# k timed in classify_bigk.
BIGK_PARITY = (17, 32, 100, 256, 257, 1000, 4096, "n_valid")
BIGK_TIMED = (32, 256, 1000)
# The k at which classify_bigk times the bf16 form.
BF16_BIGK_TIMED = (32, 256)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(ops: int, nbytes: int,
             rate: float = PEAK_FP32_INSTR) -> "tuple[float, str]":
    """The larger of ``ops`` at ``rate`` (default the FP32 instruction rate)
    and ``nbytes`` at the HBM rate, in ms, and which of the two it is."""
    t_ops, t_bytes = ops / rate, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def scan_bound_ms(q: int, n_valid: int, d: int, k: int, splits: int):
    """The scan: 3*d unfused FP32 instructions (sub, mul, add) plus one key
    compare per (query, valid train row); train and queries read once, the
    [Q, splits, k] int64 keys written once."""
    return bound_ms(q * n_valid * (3 * d + 1),
                    (n_valid * d + q * d) * 4 + q * splits * k * 8)


def merge_bound_ms(q: int, k: int, splits: int):
    """The merge of sorted split lists: per query, the head of each list and
    then one key per output slot read (splits + k int64 keys, not the whole
    [Q, splits, k] scratch), [Q, k] float32 distances and int32 indices
    written once; one compare per key read."""
    return bound_ms(q * (splits + k), q * (splits + k) * 8 + q * k * 8)


def stripe_bound_ms(q: int, n_valid: int, d: int, k: int):
    """Scan and merge as one function: the scan's operations, and the bytes
    of the inputs read once and the [Q, k] output written once."""
    return bound_ms(q * n_valid * (3 * d + 1),
                    (n_valid * d + q * d) * 4 + q * k * 8)


def tile_bound_ms(form: str, q: int, n_valid: int, d: int, k: int,
                  splits: int, train_bytes: int):
    """The tile scan in ``form``: exact, 3*d unfused FP32 instructions plus
    one key compare per (query, valid row); fast, 2*d flops at the
    FMA-counted FP32 rate; bf16, 2*d flops at the dense bf16 tensor-core
    rate. Bytes: the stored train (``train_bytes`` per value) and the
    float32 queries read once, the [Q, splits, k] keys written once."""
    nbytes = n_valid * d * train_bytes + q * d * 4 + q * splits * k * 8
    if form == "exact":
        return bound_ms(q * n_valid * (3 * d + 1), nbytes)
    rate = PEAK_BF16_FLOPS if form == "bf16" else PEAK_FP32_FLOPS
    return bound_ms(2 * q * n_valid * d, nbytes, rate)


def parity_cases(rng):
    """(name, train, queries, n_valid, k): integer grids with duplicated
    rows (dist == 0 ties), float rows, NaN rows and n_valid < N, over
    d in {1, 7, 11, 64, 128} and k in {1, 5, 10, 16}; plus a case with
    fewer finite rows than k."""
    for d in (1, 7, 11, 64, 128):
        for k in (1, 5, 10, 16):
            n, q = 3001, 300
            grid = rng.integers(0, 4, (n, d)).astype(np.float32)
            grid[1500:2000] = grid[:500]
            gq = np.concatenate([grid[rng.choice(n, q // 2, replace=False)],
                                 rng.integers(0, 4, (q - q // 2, d))
                                 .astype(np.float32)])
            grid[rng.choice(n, 40, replace=False), rng.integers(0, d, 40)] = np.nan
            gq[:3, 0] = np.nan
            yield f"grid d={d} k={k}", grid, gq, n - 77, k
            fl = rng.standard_normal((n, d)).astype(np.float32)
            fq = rng.standard_normal((q, d)).astype(np.float32)
            yield f"float d={d} k={k}", fl, fq, n, k
    few = rng.standard_normal((40, 7)).astype(np.float32)
    few[5:, 3] = np.nan
    yield "few-finite d=7 k=16", few, few[:9].copy(), 40, 16


def max_err(torch, got, want) -> float:
    """Largest |got - want| over the finite entries of ``want``."""
    fin = torch.isfinite(want)
    return (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0


def check_equal(what: str, torch, got, want) -> None:
    if not torch.equal(got, want):
        raise SystemExit(f"{what}: {(got != want).sum().item()} of "
                         f"{got.numel()} entries differ")


# The bf16 kernel's parity cases: feature counts around its 64-feature
# granule, and k on both selection paths.
BF16_PARITY_D = (1, 11, 15, 64, 129, 784, 1000)
BF16_PARITY_K = (1, 5, 16, 17, 256, 1000)


def tile_parity_cases(rng):
    """(name, form, train, queries, n_valid, k): for the exact and fast forms
    d in {1, 11, 128, 129, 784, 1000} x k in {1, 5, 16}, for the bf16 form d
    in BF16_PARITY_D x k in BF16_PARITY_K; each an integer grid with
    duplicated rows, NaN rows and n_valid < N, and float rows (N = 3,001
    and Q = 300, neither a multiple of 128)."""
    for form in ("exact", "fast", "bf16"):
        ds, ks = ((BF16_PARITY_D, BF16_PARITY_K) if form == "bf16"
                  else ((1, 11, 128, 129, 784, 1000), (1, 5, 16)))
        for d in ds:
            for k in ks:
                n, q = 3001, 300
                grid = rng.integers(0, 4, (n, d)).astype(np.float32)
                grid[1500:2000] = grid[:500]
                gq = np.concatenate([grid[rng.choice(n, q // 2, replace=False)],
                                     rng.integers(0, 4, (q - q // 2, d))
                                     .astype(np.float32)])
                grid[rng.choice(n, 40, replace=False),
                     rng.integers(0, d, 40)] = np.nan
                gq[:3, 0] = np.nan
                yield f"{form} grid d={d} k={k}", form, grid, gq, n - 77, k
                fl = rng.standard_normal((n, d)).astype(np.float32)
                fq = rng.standard_normal((q, d)).astype(np.float32)
                yield f"{form} float d={d} k={k}", form, fl, fq, n, k


def form_dist64(torch, form, q, t):
    """float64 values of ``form``'s formula for query rows ``q`` against
    their rows ``t`` (as stored): the bf16 cross term from rounded
    operands."""
    qd, td = q.double(), t.double()
    if form == "bf16":
        cross = (q.to(torch.bfloat16).double()
                 * t.to(torch.bfloat16).double()).sum(-1)
        return (qd * qd).sum(-1) + (td * td).sum(-1) - 2 * cross
    return ((qd - td) ** 2).sum(-1)


def check_near(what: str, torch, form, t, q, kd, ki, rd, ri) -> int:
    """The kernel's lists against the plain version's on float rows, the
    stated tolerance: each side is off its formula's exact value by at most
    (d + 2) * 2^-24 * (q2 + t2), so distances agree within
    atol = 4 * (d + 2) * 2^-24 * (q2 + max t2) per query, and an index may
    differ only where the two rows' float64 distances lie within twice
    that. Returns the number of such near-tie swaps."""
    d = q.shape[1]
    tf, qf = t.double(), q.double()
    scale = (qf * qf).sum(1) + (tf * tf).sum(1).nan_to_num(0).max()
    tol = (4 * (d + 2) * 2.0**-24 * scale)[:, None].expand_as(kd)
    fin = torch.isfinite(rd) & torch.isfinite(kd)
    if not torch.equal(torch.isfinite(rd), torch.isfinite(kd)):
        raise SystemExit(f"{what}: finite entries differ")
    if ((kd.double() - rd.double()).abs()[fin] > tol[fin]).any():
        raise SystemExit(f"{what}: distances outside the tolerance")
    rows, cols = torch.nonzero(ki != ri, as_tuple=True)
    if rows.numel():
        da = form_dist64(torch, form, q[rows], t[ki[rows, cols].long()])
        db = form_dist64(torch, form, q[rows], t[ri[rows, cols].long()])
        if ((da - db).abs() > 2 * tol[rows, cols]).any():
            raise SystemExit(f"{what}: an index differs outside a near tie")
    return int(rows.numel())


def phase_kernel_parity_tile(torch, dev, tile_knn, cuda_knn) -> dict:
    """The tile kernels against their plain version on tile_parity_cases:
    the exact and fast forms at the CUDA-core kernel's split layout, the
    bf16 form with the train stored as float32 and as bfloat16, each at the
    bf16 kernel's plan and at 700-row splits (ending inside a 128-row
    tile); then scan and merge through knn_tile_candidates. Returns the
    largest |kernel - plain| distance per form."""
    rng = np.random.default_rng(1)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    err = dict.fromkeys(tile_knn.FORMS, 0.0)
    n_cases = swaps = 0
    for name, form, tx, qx, n_valid, k in tile_parity_cases(rng):
        t32 = torch.from_numpy(tx).to(dev)
        qt = torch.from_numpy(qx).to(dev)
        if form == "bf16":
            stores = (t32, t32.to(torch.bfloat16))
            plans = [tile_knn.tile_split_plan(n_valid, qt.shape[0], sm_count,
                                              k, form),
                     (-(-n_valid // 700), 700)]
        else:
            stores = (t32,)
            plans = [cuda_knn.split_plan(n_valid, qt.shape[0], sm_count,
                                         tile_rows=tile_knn._TILE_ROWS,
                                         blocks_per_sm=tile_knn._BLOCKS_PER_SM)]
        for t in stores:
            what = f"kernel_parity_tile {name} store={t.dtype}"
            for plan in plans:
                partial = tile_knn.knn_tile_scan(t, qt, n_valid, k, form, *plan)
                want = tile_knn.knn_tile_scan_reference(t, qt, n_valid, k,
                                                        form, *plan)
                if "grid" in name or form == "exact":
                    check_equal(f"{what} plan={plan} scan keys", torch,
                                partial, want)
                else:
                    md, mi = cuda_knn.knn_stripe_merge(partial)
                    wd, wi = cuda_knn.knn_stripe_merge_reference(want)
                    swaps += check_near(f"{what} plan={plan}", torch, form, t,
                                        qt, md, mi, wd, wi)
            kd, ki = tile_knn.knn_tile_candidates(t, qt, n_valid, k, form)
            rd, ri = tile_knn.knn_tile_candidates_reference(t, qt, n_valid, k,
                                                            form)
            if "grid" in name or form == "exact":
                check_equal(f"{what} indices", torch, ki, ri)
                check_equal(f"{what} distances", torch, kd, rd)
            else:
                swaps += check_near(what, torch, form, t, qt, kd, ki, rd, ri)
            err[form] = max(err[form], max_err(torch, kd, rd))
            n_cases += 1
    print(f"{n_cases} cases (bf16: both train stores, its plan and 700-row "
          "splits, k up to 1000, d from 1 to 1000 around the 64-feature "
          "granule): integer grids (all forms) and float rows (exact form) "
          "bit-equal keys, indices and distances; float rows in the fast and "
          "bf16 forms within atol = 4*(d+2)*2^-24*(q2 + max t2), "
          f"{swaps} near-tie index swaps; max_abs_err {err}")
    return err


def phase_classify_wide(torch, dev, tile_knn, cuda_knn, vote_neighbors) -> dict:
    """The wide-feature rung at bench.py's mnist784 shape; returns the
    launches, times and bounds of each tile form."""
    from knn_tpu_torch import cli
    from knn_tpu_torch.backends import get_backend
    from knn_tpu_torch.backends.oracle import knn_oracle
    from knn_tpu_torch.data.arff import load_arff

    data_dir = REPO / "build" / "chip_smoke"
    data_dir.mkdir(parents=True, exist_ok=True)
    os.environ["KNN_TPU_ARFF_CACHE"] = str(data_dir / "arff-cache")
    t0 = time.perf_counter()
    x, y, qx_np, qy = wide_data(seed=0)
    train_path, test_path = data_dir / "wide-train.arff", data_dir / "wide-test.arff"
    write_arff(train_path, x, y, "wide-train")
    write_arff(test_path, qx_np, qy, "wide-test")
    print(f"wrote {x.shape[0]}x{x.shape[1]} train and {qx_np.shape[0]} queries "
          f"as ARFF in {time.perf_counter() - t0:.1f} s (set-up)")
    scan, merge = tile_knn.knn_tile_scan, cuda_knn.knn_stripe_merge
    k = 5

    def reset():
        for form in scan.launches:
            scan.launches[form] = 0
        merge.launches = 0

    out = io.StringIO()
    reset()
    t0 = time.perf_counter()
    rc = cli.run([str(train_path), str(test_path), str(k), "--backend",
                  "cuda-tile", "--precision", "auto", "--warmup", "--json"],
                 stdout=out)
    launches = {"fast": scan.launches["fast"], "merge": merge.launches}
    if rc != 0:
        raise SystemExit(f"classify_wide: cli.run exited {rc}")
    line, js = out.getvalue().splitlines()
    print(line)
    print(js)
    print(f"cli.run (parse, --warmup run, timed run) took "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}, all tile "
          f"forms {dict(scan.launches)}")
    if min(launches.values()) < 1:
        raise SystemExit(f"classify_wide: a kernel was never launched: {launches}")
    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    preds = {}
    for form in ("exact", "bf16"):
        reset()
        preds[form] = get_backend("cuda-tile")(train, test, k, precision=form)
        launches[form] = scan.launches[form]
        print(f"get_backend('cuda-tile')(precision={form!r}): launches "
              f"{dict(scan.launches)}, merge {merge.launches}")
        if launches[form] < 1 or merge.launches < 1:
            raise SystemExit(f"classify_wide {form}: a kernel was never launched")
    preds["fast"] = get_backend("cuda-tile")(train, test, k)  # auto -> fast
    acc = float((preds["fast"] == test.labels).mean())
    if f"Accuracy was {acc:.4f}" not in line:
        raise SystemExit(f"classify_wide: accuracy {acc:.4f} not in {line!r}")

    n, d, q = train.num_instances, train.num_features, test.num_instances
    tx32 = torch.from_numpy(train.features.copy()).to(dev)
    stored = {"exact": tx32, "fast": tx32, "bf16": tx32.to(torch.bfloat16)}
    ty = torch.from_numpy(train.labels.copy()).to(dev)
    qx = torch.from_numpy(test.features.copy()).to(dev)
    for form in tile_knn.FORMS:
        t = stored[form]
        kd, ki = tile_knn.knn_tile_candidates(t, qx, n, k, form)
        rd, ri = tile_knn.knn_tile_candidates_reference(t, qx, n, k, form)
        mine = vote_neighbors(ki, ty, train.num_classes).cpu().numpy()
        plain = vote_neighbors(ri, ty, train.num_classes).cpu().numpy()
        if not np.array_equal(preds[form], mine):
            raise SystemExit(f"classify_wide {form}: the backend's predictions "
                             "differ from its kernel's")
        if form == "exact":
            check_equal("classify_wide exact indices", torch, ki, ri)
            check_equal("classify_wide exact distances", torch, kd, rd)
            swaps = 0
        else:
            swaps = check_near(f"classify_wide {form}", torch, form, t, qx,
                               kd, ki, rd, ri)
        same = (ki == ri).all(dim=1).cpu().numpy()
        if not np.array_equal(mine[same], plain[same]):
            raise SystemExit(f"classify_wide {form}: predictions differ from "
                             "the plain version's on equal neighbor lists")
        print(f"{form}: predictions equal to the plain version's on "
              f"{int((mine == plain).sum())} of {q} queries; {swaps} near-tie "
              f"index swaps in {int((~same).sum())} lists")
    oracle = knn_oracle(train.features, train.labels, test.features[:128], k,
                        train.num_classes)
    if not np.array_equal(oracle, preds["exact"][:128]):
        raise SystemExit("classify_wide: exact form disagrees with the oracle")
    print("exact form: predictions equal to the numpy oracle on 128 queries")

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    queries = [qx.clone() for _ in range(12)]
    res = {"launches": launches, "ms": {}, "plain_ms": {}, "bound": {},
           "shape": {}}
    flops = 2 * q * n * d
    for form in tile_knn.FORMS:
        t = stored[form]
        plan = tile_knn.tile_split_plan(n, q, sm_count, k, form)
        res["shape"][form] = f"q={q} n={n} d={d} k={k} splits={plan[0]}"
        res["ms"][form] = cuda_ms(scan, [(t, qb, n, k, form, *plan)
                                         for qb in queries], reps=12)
        res["plain_ms"][form] = cuda_ms(
            tile_knn.knn_tile_scan_reference,
            [(t, qb, n, k, form, *plan) for qb in queries[:3]], reps=3)
        both = cuda_ms(tile_knn.knn_tile_candidates,
                       [(t, qb, n, k, form) for qb in queries], reps=12)
        res["bound"][form] = tile_bound_ms(form, q, n, d, k, plan[0],
                                           t.element_size())
        rate = flops / res["ms"][form] / 1e9
        print(f"wide {form} ({plan[0]} splits of {plan[1]} rows): tile scan "
              f"{res['ms'][form]} ms (median of 12, CUDA events), scan+merge "
              f"{both} ms, plain {res['plain_ms'][form]} ms (median of 3), "
              f"bound {res['bound'][form][0]} ms ({res['bound'][form][1]}); "
              f"cross term at {rate} TFLOP/s, {100 * rate / 989} % of the "
              "bf16 tensor-core peak (989 TFLOP/s)")
    plan = tile_knn.tile_split_plan(n, q, sm_count, k, "bf16")
    res["ms_f32_store"] = cuda_ms(scan, [(tx32, qb, n, k, "bf16", *plan)
                                         for qb in queries], reps=12)
    print(f"wide bf16 with the train stored as float32 (rounded once into "
          f"the kernel's copy): {res['ms_f32_store']} ms")
    torch.backends.cuda.matmul.allow_tf32 = False
    q16 = [qb.to(torch.bfloat16) for qb in queries]
    res["matmul_ms"] = {
        "float32": cuda_ms(lambda qb: qb @ tx32.T,
                           [(qb,) for qb in queries], reps=12),
        "bfloat16": cuda_ms(lambda qb: qb @ stored["bf16"].T,
                            [(qb,) for qb in q16], reps=12),
    }
    print(f"attribution: the bare cross term q @ t.T alone (torch.matmul, "
          f"TF32 off) {res['matmul_ms']['float32']} ms in float32, "
          f"{res['matmul_ms']['bfloat16']} ms in bfloat16 (median of 12)")
    return res


def matmul_bound_ms(q: int, n: int, d: int):
    """P1: 2*Q*N*D flops at the dense bf16 tensor-core rate; the bfloat16
    train and queries read once, the [Q, 8] float32 sums written once."""
    return bound_ms(2 * q * n * d, (n + q) * d * 2 + q * 8 * 4,
                    PEAK_BF16_FLOPS)


def check_matmul_near(what: str, torch, probe_matmul, got, want, t, q,
                      block_n: int) -> float:
    """P1 against its plain version on float rows, the stated tolerance:
    both sum the same exact products (bf16 x bf16 is exact in float32) in
    other orders, the tensor cores possibly truncating where the plain
    version rounds, so each is off the exact sum by at most (D + m) * 2^-23
    * S, with m the rows of a slot and S the sum of the products'
    magnitudes: atol = 2 * (D + m) * 2^-23 * S. Returns max |got - want|."""
    n, d = t.shape
    m = -(-n // block_n) * block_n // 8
    mags = probe_matmul.pure_matmul_reference(t.abs(), q.abs(), block_n)
    diff = (got - want).abs()
    if not torch.isfinite(got).all() or (
            diff > 2 * (d + m) * 2.0**-23 * mags).any():
        raise SystemExit(f"{what}: outside atol = 2*(D+m)*2^-23*S")
    return diff.max().item()


def forced_plans(n_valid: int):
    """Split layouts whose splits span several 64-row tiles, so a thread's
    levels carry from tile to tile: 256-row splits (whole tiles) and
    200-row splits (ending inside a tile)."""
    return [(-(-n_valid // rows), rows) for rows in (256, 200)]


def phase_kernel_parity_select(torch, dev, cuda_knn) -> dict:
    """P2's three selections against their plain versions, bit-equal keys,
    on parity_cases (k <= 16), each at split_plan's layout and at the
    forced_plans layouts; rounds on every case, and lite where its gate
    holds, merged and held against the shipped knn_stripe_candidates.
    Returns the largest |kernel - plain| key distance per selection."""
    rng = np.random.default_rng(2)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    err = dict.fromkeys(cuda_knn.SELECT_MODES, 0.0)
    n_cases = merged = 0
    for name, tx, qx, n_valid, k in parity_cases(rng):
        t = torch.from_numpy(tx).to(dev)
        qt = torch.from_numpy(qx).to(dev)
        sd, si = cuda_knn.knn_stripe_candidates(t, qt, n_valid, k)
        lite_ok = (cuda_knn.stripe_inputs_finite(tx[:n_valid], qx)
                   and k <= n_valid)
        for plan in [cuda_knn.split_plan(n_valid, qt.shape[0], sm_count),
                     *forced_plans(n_valid)]:
            what = f"kernel_parity_select {name} plan={plan}"
            for mode in cuda_knn.SELECT_MODES:
                got = cuda_knn.knn_stripe_scan_variant(t, qt, n_valid, k, mode,
                                                       *plan)
                want = cuda_knn.knn_stripe_scan_variant_reference(
                    t, qt, n_valid, k, mode, *plan)
                check_equal(f"{what} {mode} keys", torch, got, want)
                err[mode] = max(err[mode], max_err(torch, *(
                    cuda_knn._unpack_keys(x)[0] for x in (got, want))))
                if mode == "rounds" or (mode == "lite" and lite_ok):
                    md, mi = cuda_knn.knn_stripe_merge(got)
                    check_equal(f"{what} {mode} merged indices", torch, mi, si)
                    check_equal(f"{what} {mode} merged distances", torch, md, sd)
                    merged += 1
            n_cases += 1
    print(f"{n_cases} (case, split layout) pairs x {len(err)} selections "
          "(tolerance: bit-equal), layouts of split_plan and of 256- and "
          "200-row splits: keys equal to the plain versions; "
          f"{merged} merged lists (rounds on every pair, lite where "
          "stripe_inputs_finite holds and k <= n_valid) equal to "
          f"knn_stripe_candidates, distances bit-equal; max_abs_err {err}")
    return err


def phase_kernel_parity_matmul(torch, dev, probe_matmul) -> float:
    """P1 against its plain version: bit-equal on integer grids whose
    values differ by row and feature (every partial sum an integer below
    2^24), and check_matmul_near on normal float rows. Returns the largest
    |kernel - plain| on the float rows."""
    rng = np.random.default_rng(3)
    err = 0.0
    # N and Q around the 128-row tiles, D around the 64-feature chunks,
    # block_n from one row per slot to slots spanning whole tiles.
    cases = ((700, 100, 128, 200), (1000, 37, 8, 300), (3001, 129, 256, 77),
             (8192, 784, 1024, 512), (5000, 784, 1024, 130),
             (3001, 1000, 8, 200), (4099, 64, 256, 129), (130, 1, 8, 1))
    for n, d, block_n, q in cases:
        r, f = np.arange(n)[:, None], np.arange(d)[None, :]
        grid = ((r * 7 + f * 3 + rng.integers(0, 3, (n, d))) % 5)
        gq = rng.integers(0, 4, (q, d))
        for kind, tx, qx in (
                ("grid", grid, gq),
                ("float", rng.standard_normal((n, d)),
                 rng.standard_normal((q, d)))):
            t = torch.from_numpy(tx.astype(np.float32)).to(dev, torch.bfloat16)
            qt = torch.from_numpy(qx.astype(np.float32)).to(dev, torch.bfloat16)
            got = probe_matmul.pure_matmul(t, qt, block_n)
            want = probe_matmul.pure_matmul_reference(t, qt, block_n)
            what = f"kernel_parity_matmul {kind} n={n} d={d} block_n={block_n}"
            if kind == "grid":
                if want.abs().max().item() >= 2**24:
                    raise SystemExit(f"{what}: a sum reaches 2^24")
                check_equal(what, torch, got, want)
            else:
                err = max(err, check_matmul_near(what, torch, probe_matmul,
                                                 got, want, t, qt, block_n))
    print(f"{len(cases)} shapes: integer grids bit-equal; normal float rows "
          f"within atol = 2*(D+m)*2^-23*S; max_abs_err {err}")
    return err


def bigk_plans(n_valid: int, q: int, sm_count: int, k: int, tile_knn,
               form: str):
    """The tile kernel's own plan for ``form`` at k, and two forced ones:
    splits of one 128-row tile (shorter than k, so lists end in sentinels)
    and of 700 rows (ending inside a tile)."""
    return [tile_knn.tile_split_plan(n_valid, q, sm_count, k, form),
            *[(-(-n_valid // rows), rows) for rows in (128, 700)]]


def phase_kernel_parity_bigk(torch, dev, cuda_knn, tile_knn) -> dict:
    """Any k: the merge and the tile scan in its three forms against their
    plain versions at k in BIGK_PARITY (k = n_valid included, and k past
    N), on an integer grid (duplicated rows, NaN rows, n_valid < N) and on
    float rows, at the tile kernels' split plans and at forced plans (d = 11;
    d = 129 at the kernel's plan), the bf16 form with the train stored as
    float32 and as bfloat16: bit-equal keys, and the merge bit-equal on
    every case; the fast and bf16 forms on float rows held by check_near
    after the merge. Returns the largest |kernel - plain| distance per
    kernel."""
    rng = np.random.default_rng(4)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    err = {"merge": 0.0, **dict.fromkeys(tile_knn.FORMS, 0.0)}
    n_cases = swaps = 0
    n, q = 3001, 300
    for k in BIGK_PARITY:
        for d in (11, 129):
            grid = rng.integers(0, 4, (n, d)).astype(np.float32)
            grid[1500:2000] = grid[:500]
            gq = np.concatenate([grid[rng.choice(n, q // 2, replace=False)],
                                 rng.integers(0, 4, (q - q // 2, d))
                                 .astype(np.float32)])
            grid[rng.choice(n, 40, replace=False), rng.integers(0, d, 40)] = np.nan
            gq[:3, 0] = np.nan
            fl = rng.standard_normal((n, d)).astype(np.float32)
            fq = rng.standard_normal((q, d)).astype(np.float32)
            for kind, tx, qx, n_valid in (("grid", grid, gq, n - 77),
                                          ("float", fl, fq, n)):
                kk = n_valid if k == "n_valid" else k
                t = torch.from_numpy(tx).to(dev)
                qt = torch.from_numpy(qx).to(dev)
                for form, tt in (("exact", t), ("fast", t), ("bf16", t),
                                 ("bf16", t.to(torch.bfloat16))):
                    plans = bigk_plans(n_valid, q, sm_count, kk, tile_knn, form)
                    for plan in plans if d <= 128 else plans[:1]:
                        what = (f"kernel_parity_bigk {kind} d={d} k={kk} "
                                f"plan={plan} {form} store={tt.dtype}")
                        partial = tile_knn.knn_tile_scan(tt, qt, n_valid, kk,
                                                         form, *plan)
                        want = tile_knn.knn_tile_scan_reference(
                            tt, qt, n_valid, kk, form, *plan)
                        md, mi = cuda_knn.knn_stripe_merge(partial)
                        rd, ri = cuda_knn.knn_stripe_merge_reference(partial)
                        check_equal(f"{what} merge indices", torch, mi, ri)
                        check_equal(f"{what} merge distances", torch, md, rd)
                        err["merge"] = max(err["merge"], max_err(torch, md, rd))
                        wd, wi = cuda_knn.knn_stripe_merge_reference(want)
                        if kind == "grid" or form == "exact":
                            check_equal(f"{what} tile scan keys", torch,
                                        partial, want)
                        else:
                            swaps += check_near(what, torch, form, tt, qt, md,
                                                mi, wd, wi)
                        err[form] = max(err[form], max_err(torch, md, wd))
                        n_cases += 1
    print(f"{n_cases} cases at k in {BIGK_PARITY}: merge bit-equal to its "
          "plain version on every case; tile scan keys bit-equal (all forms "
          "on integer grids, exact on float rows) at the tile kernel's plan "
          "and at 128- and 700-row splits; fast and bf16 on float rows within "
          f"the tile tolerance, {swaps} near-tie index swaps; max_abs_err {err}")
    return err


def phase_classify_bigk(torch, dev, cuda_knn, tile_knn, vote_neighbors,
                        train_path, test_path) -> dict:
    """``cli.run --backend cuda-tile`` at k = 32 on the large shape (the
    merge route: k > 16 leaves the stripe route, as in predict_pallas),
    with the counters read around it; predictions against the plain
    version and the oracle; then at each k of BIGK_TIMED one
    ``get_backend("cuda-tile")`` call (counters read around it), and the
    tile scan (at its own split plan), the merge and ``torch.topk`` on the
    same keys timed. Returns launches, times and bounds by k."""
    from knn_tpu_torch import cli
    from knn_tpu_torch.backends import get_backend
    from knn_tpu_torch.backends.oracle import knn_oracle
    from knn_tpu_torch.data.arff import load_arff

    scan, merge = tile_knn.knn_tile_scan, cuda_knn.knn_stripe_merge

    def reset():
        for form in scan.launches:
            scan.launches[form] = 0
        merge.launches = 0

    reset()
    out = io.StringIO()
    rc = cli.run([str(train_path), str(test_path), "32", "--backend",
                  "cuda-tile", "--warmup", "--json"], stdout=out)
    cli_launches = {"exact": scan.launches["exact"], "merge": merge.launches}
    if rc != 0:
        raise SystemExit(f"classify_bigk: cli.run exited {rc}")
    line, js = out.getvalue().splitlines()
    print(line)
    print(js)
    print(f"launches on the path: {cli_launches} (--warmup run + timed run), "
          f"all tile forms {dict(scan.launches)}")
    if min(cli_launches.values()) < 1:
        raise SystemExit(f"classify_bigk: a kernel was never launched: "
                         f"{cli_launches}")
    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    n, d, q = train.num_instances, train.num_features, test.num_instances
    tx = torch.from_numpy(train.features.copy()).to(dev)
    ty = torch.from_numpy(train.labels.copy()).to(dev)
    qx = torch.from_numpy(test.features.copy()).to(dev)
    res = {"launches": {}, "ms": {}, "plain_ms": {}, "bound": {},
           "library_ms": {}, "shape": {}, "line": line}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    queries = [qx.clone() for _ in range(12)]
    for k in BIGK_TIMED:
        reset()
        preds = get_backend("cuda-tile")(train, test, k)
        res["launches"][k] = (cli_launches if k == 32 else
                              {"exact": scan.launches["exact"],
                               "merge": merge.launches})
        kd, ki = tile_knn.knn_tile_candidates(tx, qx, n, k, "exact")
        rd, ri = tile_knn.knn_tile_candidates_reference(tx, qx, n, k, "exact")
        check_equal(f"classify_bigk k={k} indices", torch, ki, ri)
        check_equal(f"classify_bigk k={k} distances", torch, kd, rd)
        plain = vote_neighbors(ri, ty, train.num_classes).cpu().numpy()
        if not np.array_equal(preds, plain):
            raise SystemExit(f"classify_bigk k={k}: predictions differ from "
                             "the plain version's")
        oracle = knn_oracle(train.features, train.labels, test.features[:128],
                            k, train.num_classes)
        if not np.array_equal(oracle, preds[:128]):
            raise SystemExit(f"classify_bigk k={k}: disagrees with the oracle")
        if k == 32:
            acc = float((preds == test.labels).mean())
            if f"Accuracy was {acc:.4f}" not in line:
                raise SystemExit(f"classify_bigk: accuracy {acc:.4f} not in "
                                 f"{line!r}")
        plan = tile_knn.tile_split_plan(n, q, sm_count, k)
        partials = [scan(tx, qb, n, k, "exact", *plan) for qb in queries]
        check_equal(f"classify_bigk k={k} scan keys", torch, partials[0],
                    tile_knn.knn_tile_scan_reference(tx, queries[0], n, k,
                                                     "exact", *plan))
        res["ms"][k] = {
            "scan": cuda_ms(scan, [(tx, qb, n, k, "exact", *plan)
                                   for qb in queries], reps=12),
            "merge": cuda_ms(merge, [(pb,) for pb in partials], reps=12)}
        res["plain_ms"][k] = {
            "scan": cuda_ms(tile_knn.knn_tile_scan_reference,
                            [(tx, qb, n, k, "exact", *plan)
                             for qb in queries[:3]], reps=3),
            "merge": cuda_ms(cuda_knn.knn_stripe_merge_reference,
                             [(pb,) for pb in partials], reps=12)}
        # The merge's library call: one torch.topk over a query's packed
        # keys gives its k best keys, sorted (the unpacking is a bit-cast).
        res["library_ms"][k] = cuda_ms(lambda pb: torch.topk(
            pb.view(q, -1), k, dim=1, largest=False, sorted=True),
            [(pb,) for pb in partials], reps=12)
        res["bound"][k] = {"scan": tile_bound_ms("exact", q, n, d, k, plan[0], 4),
                           "merge": merge_bound_ms(q, k, plan[0])}
        res["shape"][k] = f"q={q} n={n} d={d} k={k} splits={plan[0]}"
        del partials
        print(f"k={k}: predictions equal to the plain version's and, on 128 "
              f"queries, the oracle's; keys, indices and distances bit-equal; "
              f"launches of one get_backend('cuda-tile') call "
              f"{res['launches'][k]}. Tile scan (exact, {plan[0]} splits of "
              f"{plan[1]} rows) {res['ms'][k]['scan']} ms, plain "
              f"{res['plain_ms'][k]['scan']} ms, bound "
              f"{res['bound'][k]['scan'][0]} ms ({res['bound'][k]['scan'][1]}); "
              f"merge {res['ms'][k]['merge']} ms, plain "
              f"{res['plain_ms'][k]['merge']} ms, torch.topk on the keys "
              f"{res['library_ms'][k]} ms, bound {res['bound'][k]['merge'][0]} "
              f"ms ({res['bound'][k]['merge'][1]})")

    # The bf16 form on the same path: k > 16 takes the merge route, which
    # stores the train as bfloat16.
    txb = tx.to(torch.bfloat16)
    res["bf16"] = {}
    for k in BF16_BIGK_TIMED:
        reset()
        preds = get_backend("cuda-tile")(train, test, k, precision="bf16")
        launches = {"bf16": scan.launches["bf16"], "merge": merge.launches}
        if min(launches.values()) < 1:
            raise SystemExit(f"classify_bigk bf16 k={k}: a kernel was never "
                             f"launched: {launches}")
        kd, ki = tile_knn.knn_tile_candidates(txb, qx, n, k, "bf16")
        rd, ri = tile_knn.knn_tile_candidates_reference(txb, qx, n, k, "bf16")
        swaps = check_near(f"classify_bigk bf16 k={k}", torch, "bf16", txb, qx,
                           kd, ki, rd, ri)
        mine = vote_neighbors(ki, ty, train.num_classes).cpu().numpy()
        plain = vote_neighbors(ri, ty, train.num_classes).cpu().numpy()
        same = (ki == ri).all(dim=1).cpu().numpy()
        if not np.array_equal(preds, mine) or not np.array_equal(
                mine[same], plain[same]):
            raise SystemExit(f"classify_bigk bf16 k={k}: predictions differ "
                             "from the kernel's or, on equal neighbor lists, "
                             "the plain version's")
        plan = tile_knn.tile_split_plan(n, q, sm_count, k, "bf16")
        entry = {
            "launches": launches,
            "ms": cuda_ms(scan, [(txb, qb, n, k, "bf16", *plan)
                                 for qb in queries], reps=12),
            "plain_ms": cuda_ms(tile_knn.knn_tile_scan_reference,
                                [(txb, qb, n, k, "bf16", *plan)
                                 for qb in queries[:3]], reps=3),
            "bound": tile_bound_ms("bf16", q, n, d, k, plan[0], 2),
            "max_abs_err": max_err(torch, kd, rd),
            "shape": f"q={q} n={n} d={d} k={k} splits={plan[0]}",
        }
        res["bf16"][k] = entry
        print(f"bf16 k={k}: launches of one get_backend('cuda-tile', "
              f"precision='bf16') call {launches}; distances within the tile "
              f"tolerance of the plain version's, {swaps} near-tie index "
              f"swaps, predictions equal on equal lists. Tile scan (bf16, "
              f"{plan[0]} splits of {plan[1]} rows) {entry['ms']} ms, plain "
              f"{entry['plain_ms']} ms, bound {entry['bound'][0]} ms "
              f"({entry['bound'][1]}); the exact form's scan above "
              f"{res['ms'][k]['scan']} ms")
    return res


def cosine_near_ties(what: str, train_x, test_x, got_i, want_i) -> int:
    """Two cosine neighbor lists of the same queries may differ only at
    near ties: where they differ, the float64 distances of the two lists'
    rows, sorted, agree within ``4 * (d + 2) * 2^-24`` (twice the bound on
    each side's float32 error). Returns the number of queries whose lists
    differ."""
    rows = np.nonzero((got_i != want_i).any(axis=1))[0]
    tol = 4 * (train_x.shape[1] + 2) * 2.0**-24
    for r in rows:
        qv = test_x[r].astype(np.float64)

        def dist(idx):
            t = train_x[idx].astype(np.float64)
            den = np.linalg.norm(t, axis=1) * np.linalg.norm(qv)
            return np.sort(1 - np.where(den > 0, t @ qv / np.where(den > 0, den, 1),
                                        0))

        if np.abs(dist(got_i[r]) - dist(want_i[r])).max() > tol:
            raise SystemExit(f"{what}: query {r}'s neighbors differ outside a "
                             "near tie")
    return int(rows.size)


def phase_classify_xla(torch, dev, cuda_knn, tile_knn, vote_neighbors,
                       train_path, test_path) -> dict:
    """The XLA route of ``--backend cuda`` (torch ops on the card, no hand
    kernel) on the large shape: ``cli.run --engine xla`` at k = 32 (the
    tiled scan: 1,718 x 30,803 cells are past the 16 Mi full-matrix limit)
    and k = 5, and ``--metric cosine`` at k = 32, the kernels' counters read
    around each (they stay 0). Predictions against the oracle's (cosine:
    equal wherever the neighbor lists agree, the lists differing only at
    near ties) and ``cuda-tile``'s; the route's device time beside
    ``cuda-tile``'s on the same problem (CUDA events). Then the default
    engine at k = 32 (``auto-k32``), which sends the euclidean problem to
    the kernels: the tile scan's and the merge's counters must move, the
    predictions equal ``cuda-tile``'s and the oracle's, and the result line
    be no slower than ``cuda-tile``'s run just after it (the ms field's
    resolution, 1 ms, allowed)."""
    from knn_tpu_torch import cli
    from knn_tpu_torch.backends import cuda as cuda_backend
    from knn_tpu_torch.backends import get_backend
    from knn_tpu_torch.backends.oracle import knn_oracle, oracle_kneighbors
    from knn_tpu_torch.data.arff import load_arff

    counters = (cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge)
    tile_scan = tile_knn.knn_tile_scan

    def launched():
        return (sum(c.launches for c in counters)
                + sum(tile_scan.launches.values()))

    def reset():
        for c in counters:
            c.launches = 0
        for form in tile_scan.launches:
            tile_scan.launches[form] = 0

    def line_of(k, *flags):
        out = io.StringIO()
        rc = cli.run([str(train_path), str(test_path), str(k), *flags,
                      "--warmup", "--json"], stdout=out)
        if rc != 0:
            raise SystemExit(f"classify_xla {flags}: cli.run exited {rc}")
        line, js = out.getvalue().splitlines()
        print(line)
        print(js)
        return line

    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    n, d, q = train.num_instances, train.num_features, test.num_instances
    res = {"lines": {}}
    for name, k, metric, engine in (("k32", 32, "euclidean", "xla"),
                                    ("cosine", 32, "cosine", "auto"),
                                    ("engine-xla", 5, "euclidean", "xla")):
        reset()
        line = line_of(k, "--backend", "cuda", "--metric", metric,
                       "--engine", engine)
        if launched():
            raise SystemExit(f"classify_xla {name}: a hand kernel launched on "
                             "the XLA route")
        res["lines"][name] = line
        preds = get_backend("cuda")(train, test, k, metric=metric,
                                    engine=engine)
        acc = float((preds == test.labels).mean())
        if f"Accuracy was {acc:.4f}" not in line:
            raise SystemExit(f"classify_xla {name}: accuracy {acc:.4f} not in "
                             f"{line!r}")
        if metric == "euclidean":
            tile = get_backend("cuda-tile")(train, test, k)
            if not np.array_equal(preds, tile):
                raise SystemExit(f"classify_xla {name}: differs from cuda-tile")
            oracle = knn_oracle(train.features, train.labels,
                                test.features[:128], k, train.num_classes)
            if not np.array_equal(oracle, preds[:128]):
                raise SystemExit(f"classify_xla {name}: differs from the oracle")
            print(f"{name}: predictions equal to cuda-tile's on {q} queries "
                  "and the oracle's on 128")
            continue
        oracle = knn_oracle(train.features, train.labels, test.features, k,
                            train.num_classes, metric="cosine")
        tx = torch.from_numpy(train.features.copy()).to(dev)
        ty = torch.from_numpy(train.labels.copy()).to(dev)
        qx = torch.from_numpy(test.features.copy()).to(dev)
        # The route's own tiles and padding, so every matmul has its shape.
        pad = cuda_backend._pad_rows
        _, got_i, _ = cuda_backend.forward_candidates_core(
            pad(tx, 2048), pad(ty, 2048), pad(qx, 256), n, k, "cosine",
            query_tile=256, train_tile=2048)
        got_i = got_i[:q]
        mine = vote_neighbors(got_i, ty, train.num_classes).cpu().numpy()
        if not np.array_equal(mine, preds):
            raise SystemExit("classify_xla cosine: the backend's predictions "
                             "differ from its candidates' vote")
        _, want_i = oracle_kneighbors(train.features, test.features, k, "cosine")
        differ = cosine_near_ties("classify_xla cosine", train.features,
                                  test.features, got_i.cpu().numpy(), want_i)
        same = ~(got_i.cpu().numpy() != want_i).any(axis=1)
        if not np.array_equal(preds[same], oracle[same]):
            raise SystemExit("classify_xla cosine: predictions differ from the "
                             "oracle's on equal neighbor lists")
        print(f"cosine: predictions equal to the oracle's on "
              f"{int((preds == oracle).sum())} of {q} queries; {differ} lists "
              "differ from the oracle's, each only at near ties")

    # The route's device time beside cuda-tile's, k = 32, the same inputs
    # on the card: the tiled scan and its vote, against the tile kernel,
    # the merge and the vote.
    k, tile_rows = 32, 2048
    tx = torch.from_numpy(train.features.copy()).to(dev)
    ty = torch.from_numpy(train.labels.copy()).to(dev)
    txp = cuda_backend._pad_rows(tx, tile_rows)
    typ = cuda_backend._pad_rows(ty, tile_rows)
    queries = [cuda_backend._pad_rows(
        torch.from_numpy(test.features.copy()).to(dev), 256) for _ in range(6)]

    def xla_route(qb):
        return cuda_backend.forward_tiled_core(txp, typ, qb, n, k,
                                               train.num_classes, "exact",
                                               256, tile_rows)

    def tile_route(qb):
        _, idx = tile_knn.knn_tile_candidates(tx, qb[:q], n, k, "exact")
        return vote_neighbors(idx, ty, train.num_classes)

    if not torch.equal(xla_route(queries[0])[:q], tile_route(queries[0])):
        raise SystemExit("classify_xla: the timed routes disagree")
    res["ms"] = cuda_ms(xla_route, [(qb,) for qb in queries], reps=6)
    res["tile_ms"] = cuda_ms(tile_route, [(qb,) for qb in queries], reps=6)
    res["shape"] = f"q={q} n={n} d={d} k={k}"
    # The same function's bound: the exact form's 3*d + 1 instructions per
    # (query, row), the inputs read once and the [Q, k] answer written.
    res["bound"] = stripe_bound_ms(q, n, d, k)
    print(f"XLA route (forward_tiled_core, query_tile 256, train_tile "
          f"{tile_rows}; torch ops, no hand kernel) at {res['shape']}: "
          f"{res['ms']} ms (median of 6, CUDA events), bound "
          f"{res['bound'][0]} ms ({res['bound'][1]}); cuda-tile (tile scan, "
          f"merge, vote) {res['tile_ms']} ms; result lines "
          f"{[_ms_of(x) for x in res['lines'].values()]} ms "
          f"(k32, cosine, engine-xla)")

    # The default engine sends the euclidean k = 32 problem to the kernels.
    reset()
    auto_line = line_of(32, "--backend", "cuda")
    launches = {"exact": tile_scan.launches["exact"],
                "merge": cuda_knn.knn_stripe_merge.launches}
    if min(launches.values()) < 1:
        raise SystemExit(f"classify_xla auto-k32: the tile kernel was never "
                         f"launched: {launches}")
    tile_line = line_of(32, "--backend", "cuda-tile")
    preds = get_backend("cuda")(train, test, 32)
    tile = get_backend("cuda-tile")(train, test, 32)
    oracle = knn_oracle(train.features, train.labels, test.features[:128], 32,
                        train.num_classes)
    if not np.array_equal(preds, tile) or not np.array_equal(oracle,
                                                             preds[:128]):
        raise SystemExit("classify_xla auto-k32: predictions differ from "
                         "cuda-tile's or the oracle's")
    acc = float((preds == test.labels).mean())
    if f"Accuracy was {acc:.4f}" not in auto_line:
        raise SystemExit(f"classify_xla auto-k32: accuracy {acc:.4f} not in "
                         f"{auto_line!r}")
    if _ms_of(auto_line) > _ms_of(tile_line) + 1:
        raise SystemExit(f"classify_xla auto-k32: {_ms_of(auto_line)} ms, "
                         f"slower than cuda-tile's {_ms_of(tile_line)} ms")
    res["lines"]["auto-k32"] = auto_line
    res["auto_launches"] = launches
    print(f"auto-k32: launches {launches} (--warmup run + timed run); "
          f"predictions equal to cuda-tile's on {q} queries and the oracle's "
          f"on 128; result line {_ms_of(auto_line)} ms against cuda-tile's "
          f"{_ms_of(tile_line)} ms (XLA route's line above: "
          f"{_ms_of(res['lines']['k32'])} ms)")
    return res


def _ms_of(line: str) -> int:
    """The ms field of a result line."""
    return int(line.split(" required ")[1].split(" ms")[0])


def wall_ms(fn, reps: int) -> "tuple[float, list[float]]":
    """Median host-clock ms of ``fn()`` over ``reps`` calls (each call ends
    with its answers on the host), and every call's time."""
    import statistics

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def source_order_sq_dists(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """numpy brute force of the port's exact form: ``acc = acc + diff*diff``
    feature by feature in float32 (each operation rounded), NaN -> +inf."""
    acc = np.zeros((q.shape[0], t.shape[0]), np.float32)
    for f in range(q.shape[1]):
        diff = q[:, f : f + 1] - t[:, f]
        acc = acc + diff * diff
    return np.where(np.isnan(acc), np.float32(np.inf), acc)


# bench.py's kneighbors config: the large test set tiled 64 and 384 times
# with 1e-4 noise (seeds 1 and 2), and 10 async calls resolved together.
MODEL_QUERY_REPS = ((64, 1), (384, 2))
ASYNC_CALLS = 10
# Rounds of ten sync calls and of ten async calls, taken in turns.
ASYNC_ROUNDS = 8
# A squared radius under which every large-shape query has fewer than 128
# train rows (at most 87), so radius_neighbors' k = 128 list is complete.
RADIUS = 10.0


def phase_models(torch, dev, cuda_knn, tile_knn, train_path, test_path,
                 xl_x, xl_y) -> dict:
    """The model layer on the card, at bench.py's kneighbors and sweepk
    shapes. Every model call is made with the launch counters set to 0 just
    before it and read just after; returns the launches and times."""
    from knn_tpu_torch import cli
    from knn_tpu_torch.backends.oracle import oracle_kneighbors
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.models.knn import (
        KNNClassifier, KNNRegressor, _host_vote, aggregate_targets, sweep_k,
        vote_from_labels)

    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    tile_scan = tile_knn.knn_tile_scan

    def reset():
        scan.launches = merge.launches = 0
        for form in tile_scan.launches:
            tile_scan.launches[form] = 0

    def counts():
        return {"stripe_scan": scan.launches, "stripe_merge": merge.launches,
                **{f"tile_{f}": n for f, n in tile_scan.launches.items()}}

    def launched(fn):
        reset()
        out = fn()
        return out, counts()

    def need(what, got, **want):
        """Fail unless each named counter moved (True) or stayed 0 (False)."""
        for name, moved in want.items():
            if bool(got[name]) != moved:
                raise SystemExit(f"models {what}: {name} launched "
                                 f"{got[name]} times; launches {got}")

    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    n, d, q = train.num_instances, train.num_features, test.num_instances
    k = 5
    tx = torch.from_numpy(train.features.copy()).to(dev)
    qx = torch.from_numpy(test.features.copy()).to(dev)
    res = {"launches": {}, "ms": {}}

    # Large shape, k = 5: engine auto (the stripe kernels), xla, manhattan.
    model = KNNClassifier(k=k).fit(train)
    (kd, ki), res["launches"]["kneighbors_auto"] = launched(
        lambda: model.kneighbors(test))
    need("kneighbors auto", res["launches"]["kneighbors_auto"],
         stripe_scan=True, stripe_merge=True)
    od, oi = oracle_kneighbors(train.features, test.features, k)
    if not np.array_equal(ki, oi):
        raise SystemExit("models kneighbors auto: indices differ from the "
                         "oracle's")
    rd, ri = cuda_knn.knn_stripe_candidates_reference(tx, qx, n, k)
    if not (np.array_equal(kd, rd.cpu().numpy())
            and np.array_equal(ki, ri.cpu().numpy())):
        raise SystemExit("models kneighbors auto: differs from the plain "
                         "version on the card")
    xla_model = KNNClassifier(k=k, engine="xla").fit(train)
    (xd, xi), res["launches"]["kneighbors_xla"] = launched(
        lambda: xla_model.kneighbors(test))
    need("kneighbors xla", res["launches"]["kneighbors_xla"],
         stripe_scan=False, stripe_merge=False, tile_exact=False)
    if not (np.array_equal(xi, ki) and np.array_equal(xd, kd)):
        raise SystemExit("models kneighbors xla: differs from engine auto")
    man = KNNClassifier(k=k, metric="manhattan").fit(train)
    (md, mi), res["launches"]["kneighbors_manhattan"] = launched(
        lambda: man.kneighbors(test))
    if any(res["launches"]["kneighbors_manhattan"].values()):
        raise SystemExit(f"models manhattan: a hand kernel launched: "
                         f"{res['launches']['kneighbors_manhattan']}")
    _, omi = oracle_kneighbors(train.features, test.features, k, "manhattan")
    hmd, hmi = KNNClassifier(k=k, metric="manhattan", device="cpu").fit(
        train).kneighbors(test)
    if not (np.array_equal(mi, omi) and np.array_equal(mi, hmi)
            and np.array_equal(md, hmd)):
        raise SystemExit("models manhattan: differs from the oracle or the "
                         "host's plain version")
    for name, m in (("auto", model), ("xla", xla_model)):
        res["ms"][f"kneighbors_{name}"], trials = wall_ms(
            lambda m=m: m.kneighbors(test), 5)
        print(f"kneighbors[{name}] at q={q} n={n} d={d} k={k}: "
              f"{res['ms'][f'kneighbors_{name}']} ms/call (median of 5 wall "
              f"times {trials})")
    print(f"large: auto launches {res['launches']['kneighbors_auto']}; xla "
          f"{res['launches']['kneighbors_xla']}; manhattan "
          f"{res['launches']['kneighbors_manhattan']}. Indices equal to the "
          "oracle's (euclidean and manhattan); auto's distances and indices "
          "bit-equal to the plain version on the card and to xla's; "
          "manhattan's bit-equal to the host's plain version")

    # Many queries through one call each.
    sample = np.random.default_rng(3)
    for reps, seed in MODEL_QUERY_REPS:
        big = np.tile(test.features, (reps, 1))
        big += 1e-4 * np.random.default_rng(seed).standard_normal(
            big.shape, dtype=np.float32)
        big_ds = Dataset(big, np.zeros(len(big), np.int32))
        (bd, bi), got = launched(lambda: model.kneighbors(big_ds))
        need(f"{len(big)} queries", got, stripe_scan=True, stripe_merge=True)
        rows = np.sort(sample.choice(len(big), 2048, replace=False))
        pd, pi = cuda_knn.knn_stripe_candidates_reference(
            tx, torch.from_numpy(big[rows]).to(dev), n, k)
        if not (np.array_equal(bi[rows], pi.cpu().numpy())
                and np.array_equal(bd[rows], pd.cpu().numpy())):
            raise SystemExit(f"models {len(big)} queries: differs from the "
                             "plain version on 2,048 sampled rows")
        ms, trials = wall_ms(lambda: model.kneighbors(big_ds), 3)
        res["launches"][f"kneighbors_q{len(big)}"] = got
        res["ms"][f"kneighbors_q{len(big)}"] = ms
        res[f"qps_q{len(big)}"] = len(big) / ms * 1e3
        print(f"kneighbors at {len(big)} queries: {ms} ms (median of 3 wall "
              f"times {trials}), {len(big) / ms * 1e3} q/s; launches {got}; "
              "2,048 sampled rows bit-equal to the plain version")
        huge_ds, huge_want = big_ds, (bd, bi)  # the last: the largest

    # Async: rounds of ten handles resolved together against rounds of ten
    # sync calls, in turns (the host's clock moves between rounds), then
    # one handle on the 659,712 queries.
    def ten_async():
        handles = [model.kneighbors_async(test) for _ in range(ASYNC_CALLS)]
        return [h.result() for h in handles]

    def ten_sync():
        return [model.kneighbors(test) for _ in range(ASYNC_CALLS)]

    outs, got = launched(ten_async)
    need("kneighbors_async", got, stripe_scan=True, stripe_merge=True)
    for out in outs:
        if not (np.array_equal(out[0], kd) and np.array_equal(out[1], ki)):
            raise SystemExit("models kneighbors_async: differs from the sync "
                             "call")
    rounds = {"sync": [], "async": []}
    for r in range(ASYNC_ROUNDS):
        order = (("sync", ten_sync), ("async", ten_async))
        for name, fn in order if r % 2 == 0 else order[::-1]:
            rounds[name].append(wall_ms(fn, 1)[0])
    for name in rounds:
        res["ms"][f"{name}_per_call"] = float(
            np.median(rounds[name])) / ASYNC_CALLS
    res["launches"]["kneighbors_async_x10"] = got
    t0 = time.perf_counter()
    handle = model.kneighbors_async(huge_ds)
    res["ms"]["async_return_huge"] = (time.perf_counter() - t0) * 1e3
    hd, hi = handle.result()
    res["ms"]["async_result_huge"] = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(hd, huge_want[0])
            and np.array_equal(hi, huge_want[1])):
        raise SystemExit(f"models kneighbors_async: {huge_ds.num_instances} "
                         "queries differ from the sync call")
    print(f"kneighbors_async x{ASYNC_CALLS} resolved together: "
          f"{res['ms']['async_per_call']} ms per call against "
          f"{res['ms']['sync_per_call']} ms for {ASYNC_CALLS} sync calls "
          f"(medians of {ASYNC_ROUNDS} rounds each, in turns; round times "
          f"{rounds} ms); launches of one async round {got}. At "
          f"{huge_ds.num_instances} queries: returned after "
          f"{res['ms']['async_return_huge']} ms, result() done at "
          f"{res['ms']['async_result_huge']} ms. Async answers bit-equal to "
          "the sync ones")

    # radius_neighbors at max_neighbors = 128: the tile scan's k > 16 path.
    (rd, ri, mask), got = launched(lambda: model.radius_neighbors(
        test, RADIUS))
    need("radius_neighbors", got, tile_exact=True, stripe_merge=True,
         stripe_scan=False)
    rows = np.sort(sample.choice(q, 256, replace=False))
    bf = source_order_sq_dists(test.features[rows], train.features)
    order = np.lexsort((np.broadcast_to(np.arange(n), bf.shape), bf),
                       axis=1)[:, :128]
    want_d = np.take_along_axis(bf, order, axis=1)
    if not (np.array_equal(ri[rows], order) and np.array_equal(
            rd[rows], want_d) and np.array_equal(mask[rows],
                                                 want_d <= RADIUS)):
        raise SystemExit("models radius_neighbors: differs from the numpy "
                         "brute force on 256 queries")
    res["ms"]["radius"], trials = wall_ms(
        lambda: model.radius_neighbors(test, RADIUS), 5)
    res["launches"]["radius"] = got
    print(f"radius_neighbors (radius {RADIUS}, max_neighbors 128, "
          f"{int(mask.sum())} rows in radius, at most "
          f"{int(mask.sum(1).max())} per query): {res['ms']['radius']} ms "
          f"(median of 5 wall times {trials}); launches {got}; indices, "
          "distances and mask equal to a numpy brute force on 256 queries")

    # --sweep-k through the CLI: one retrieval at k = 10, one vote per k.
    ks = (1, 5, 10)
    dump = REPO / "build" / "chip_smoke" / "sweep.npy"
    out = io.StringIO()
    rc, got = launched(lambda: cli.run(
        [str(train_path), str(test_path), "1", "--sweep-k", "1,5,10",
         "--dump-predictions", str(dump)], stdout=out))
    if rc != 0:
        raise SystemExit(f"models sweep: cli.run exited {rc}")
    if (got["stripe_scan"], got["stripe_merge"]) != (1, 1) or any(
            got[f"tile_{f}"] for f in tile_knn.FORMS):
        raise SystemExit(f"models sweep: not one retrieval's launches: {got}")
    res["launches"]["sweep_cli"] = got
    lines = out.getvalue().splitlines()
    print("\n".join(lines))
    _, oi10 = oracle_kneighbors(train.features, test.features, 10)
    for line, kk in zip(lines, ks):
        single = KNNClassifier(k=kk).fit(train).predict(test)
        oracle = _host_vote(train.labels[oi10[:, :kk]], train.num_classes)
        acc = float((oracle == test.labels).mean())
        if not (np.array_equal(np.load(dump.with_name(f"sweep.k{kk}.npy")),
                               single) and np.array_equal(single, oracle)
                and line.startswith(f"The {kk}-NN classifier")
                and line.endswith(f"Accuracy was {acc:.4f}")):
            raise SystemExit(f"models sweep k={kk}: the line, the dumped "
                             "predictions, a single predict and the oracle "
                             "disagree")
    print(f"sweep launches {got}: one retrieval at k = 10. Each line's "
          "accuracy is the oracle's; each dumped file equals that k's "
          "predict and the oracle. (The golden 0.9919/0.9948/0.7538 belong "
          "to the reference datasets; this phase runs on the synthetic "
          "large fixture.)")

    # The sweep against three single predicts, large and xl.
    xl = Dataset(xl_x, xl_y)
    for name, tr in (("large", train), ("xl", xl)):
        got_sweep = sweep_k(tr, test, ks)  # upload, first call
        preds = {kk: KNNClassifier(k=kk).fit(tr).predict(test) for kk in ks}
        for kk in ks:
            if not np.array_equal(got_sweep[kk], preds[kk]):
                raise SystemExit(f"models sweep {name} k={kk}: differs from "
                                 "the single predict")
        _, got = launched(lambda: sweep_k(tr, test, ks))
        need(f"sweep {name}", got, stripe_scan=True, stripe_merge=True)
        res["ms"][f"sweep_{name}"], t_sweep = wall_ms(
            lambda: sweep_k(tr, test, ks), 5)
        res["ms"][f"three_predicts_{name}"], t_three = wall_ms(
            lambda: [KNNClassifier(k=kk).fit(tr).predict(test) for kk in ks],
            5)
        res["launches"][f"sweep_{name}"] = got
        print(f"sweep_k {ks} on {name} ({tr.num_instances} rows): "
              f"{res['ms'][f'sweep_{name}']} ms (median of 5 {t_sweep}) "
              f"against three predicts {res['ms'][f'three_predicts_{name}']}"
              f" ms ({t_three}); launches of one sweep {got}; each k equal "
              "to its predict")

    # KNNRegressor on xl, float targets: labels plus seeded noise.
    targets = (xl_y + np.random.default_rng(4).normal(
        0, 0.25, len(xl_y))).astype(np.float32)
    xl_reg = Dataset(xl_x, xl_y, raw_targets=targets)
    txl = torch.from_numpy(xl_x).to(dev)
    pdx, pix = cuda_knn.knn_stripe_candidates_reference(txl, qx, len(xl_x), 10)
    pdx, pix = pdx.cpu().numpy(), pix.cpu().numpy()
    for weights in ("uniform", "distance"):
        reg = KNNRegressor(k=10, weights=weights).fit(xl_reg)
        got_p, got = launched(lambda: reg.predict(test))
        need(f"regressor {weights}", got, stripe_scan=True, stripe_merge=True)
        want = aggregate_targets(pdx, targets[pix], weights)
        if not np.array_equal(got_p, want):
            raise SystemExit(f"models regressor {weights}: differs from the "
                             "plain version's neighbors aggregated on the "
                             "host")
        res["ms"][f"regressor_{weights}"], trials = wall_ms(
            lambda: reg.predict(test), 5)
        res["launches"][f"regressor_{weights}"] = got
        print(f"KNNRegressor(k=10, weights={weights!r}) on xl: "
              f"{res['ms'][f'regressor_{weights}']} ms (median of 5 "
              f"{trials}); launches {got}; equal to the plain version's "
              "neighbors aggregated")
    del txl

    # The distance-weighted vote on xl against the oracle's neighbors.
    weighted = KNNClassifier(k=10, weights="distance").fit(xl)
    got_p, got = launched(lambda: weighted.predict(test))
    need("weighted vote", got, stripe_scan=True, stripe_merge=True)
    rows = np.sort(sample.choice(q, 128, replace=False))
    wd, wi = oracle_kneighbors(xl_x, test.features[rows], 10)
    want = vote_from_labels(wd, xl_y[wi], int(xl_y.max()) + 1, "distance")
    if not np.array_equal(got_p[rows], want):
        raise SystemExit("models weighted vote: differs from the oracle's "
                         "neighbors voted by distance")
    res["ms"]["weighted_xl"], trials = wall_ms(lambda: weighted.predict(test),
                                               5)
    res["launches"]["weighted_xl"] = got
    print(f"KNNClassifier(k=10, weights='distance') on xl: "
          f"{res['ms']['weighted_xl']} ms (median of 5 {trials}); launches "
          f"{got}; equal to the oracle's neighbors voted through "
          "vote_from_labels on 128 queries")
    print("models: " + json.dumps(res))
    return res


# Pairs of CLI runs with obs off and on, in turns (cli_ladder case 1).
OBS_PAIRS = 3


def outside_predict_ms(obs, registry_ms: float, reps: int = 2000) -> dict:
    """Host ms of the work that the CLI's classify region holds outside its
    ``predict`` span: ``registry_ms``, the registry updates
    ``observed_backend`` made after the span in the call itself (timed in
    place: alone, on warm caches, they take about half as long), and the
    mean over ``reps`` calls, timed alone with obs on, of the ladder's rung
    set-up and of two spans' enter and exit (the classify span's and the
    predict span's). Obs is off and empty afterwards."""
    from knn_tpu_torch.backends import get_backend, is_available
    from knn_tpu_torch.resilience.degrade import LADDER, opts_for_rung

    opts = {"device": "cuda", "query_tile": 256, "train_tile": 2048}

    def ladder():
        [r for r in LADDER["cuda"] if is_available(r)]
        is_available("cuda")
        opts_for_rung("cuda", "cuda", opts)
        get_backend("cuda")

    def spans():
        with obs.span("outer"):
            with obs.span("inner"):
                pass

    out = {"registry": registry_ms}
    obs.enable()
    try:
        for name, fn in (("ladder", ladder), ("spans", spans)):
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out[name] = (time.perf_counter() - t0) * 1e3 / reps
    finally:
        obs.disable()
        obs.reset()
    out["total"] = sum(out.values())
    return out


def phase_cli_ladder(torch, cuda_knn, tile_knn, train_path, test_path,
                     smi: str) -> dict:
    """The rest of the classify command through ``cli.run`` on the large
    fixture: the default path with --metrics-out/--trace-out, the native
    personas, faults injected on the card rung, --approx, and the native
    ARFF parser against the pure-Python one. Each case reads the launch
    counters around its call; returns the measured numbers."""
    import contextlib

    from knn_tpu_torch import cli, obs
    from knn_tpu_torch.backends.oracle import knn_oracle
    from knn_tpu_torch.obs import instrument
    from knn_tpu_torch.data import pyarff
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.native import arff_native
    from knn_tpu_torch.resilience import degrade, faults
    from knn_tpu_torch.utils.timing import RegionTimer

    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    tile_scan = tile_knn.knn_tile_scan
    data_dir = REPO / "build" / "chip_smoke"
    tr, te = str(train_path), str(test_path)
    metrics_path = str(data_dir / "cli_ladder_metrics.json")
    trace_path = str(data_dir / "cli_ladder_trace.json")
    preds_path = str(data_dir / "cli_ladder_preds.npy")
    res: dict = {"card": smi}

    def reset():
        scan.launches = merge.launches = 0
        for form in tile_scan.launches:
            tile_scan.launches[form] = 0

    def counts():
        return {"stripe_scan": scan.launches, "stripe_merge": merge.launches,
                **{f"tile_{f}": n for f, n in tile_scan.launches.items()}}

    def run(argv, what):
        """cli.run(argv) with the counters set to 0 just before it; returns
        (rc, stdout lines, stderr text, launches, wall ms)."""
        out, err = io.StringIO(), io.StringIO()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.run([tr, te, *argv], stdout=out)
        wall = (time.perf_counter() - t0) * 1e3
        got = counts()
        print(f"{what}: rc {rc}, launches {got}, cli.run wall {wall} ms "
              f"({smi})")
        for line in out.getvalue().splitlines() + err.getvalue().splitlines():
            print(f"  {line}")
        return rc, out.getvalue().splitlines(), err.getvalue(), got, wall

    def fail(msg):
        raise SystemExit(f"cli_ladder: {msg}")

    # 1. The default path, with the obs artifacts; observed_backend's
    # registry updates timed in place (the timed call's are the last).
    record, record_ms = instrument._record_predict, []

    def timed_record(*args):
        t0 = time.perf_counter()
        record(*args)
        record_ms.append((time.perf_counter() - t0) * 1e3)

    instrument._record_predict = timed_record
    try:
        rc, lines, err, got, _ = run(
            ["5", "--warmup", "--json", "--metrics-out", metrics_path,
             "--trace-out", trace_path, "--dump-predictions", preds_path],
            "default persona, --warmup --json --metrics-out --trace-out")
    finally:
        instrument._record_predict = record
    if rc != 0:
        fail(f"the default path exited {rc}")
    js = json.loads(lines[1])
    if js["backend"] != "cuda" or "warning:" in err:
        fail(f"backend {js['backend']!r}, stderr {err!r}")
    if got["stripe_scan"] != 2 or got["stripe_merge"] != 2:
        fail(f"the stripe scan and merge must launch twice each: {got}")
    with open(metrics_path) as fh:
        doc = json.load(fh)
    calls = doc["metrics"].get("knn_predict_calls_total", [])
    if not any(r["labels"] == {"backend": "cuda"} for r in calls):
        fail(f"no knn_predict_calls_total{{backend=cuda}} in {calls}")
    # The phases are the classify span's children: the one `predict` span.
    # The region also holds the ladder's rung set-up, the registry updates
    # observed_backend makes just after the span (as JAX's does) and the
    # spans' own enter and exit; the phases plus that host work, each part
    # measured, must make the region within 10 %.
    phases = js["phases"]
    outside = outside_predict_ms(obs, record_ms[-1])
    uncovered = doc["wall_ms"] - sum(phases.values())
    print(f"region {doc['wall_ms']} ms: phases {phases}, uncovered "
          f"{uncovered} ms; the work outside the predict span (ms; the "
          f"registry updates in the call, the rest alone): {outside} ({smi})")
    res["outside_predict_ms"] = {**outside, "uncovered": uncovered,
                                 "region": doc["wall_ms"]}
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e["name"] for e in events}
    if not {"classify", "predict", "ingest"} <= names:
        fail(f"trace spans {sorted(names)}")
    # Where the uncovered time sits: before the timed predict span (the
    # ladder's set-up) and after it (the registry updates), in the trace.
    stamps = {(e["name"], e["ph"]): e["ts"] for e in events}  # last of each
    res["outside_predict_ms"]["before"] = (
        stamps["predict", "B"] - stamps["classify", "B"]) / 1e3
    res["outside_predict_ms"]["after"] = (
        stamps["classify", "E"] - stamps["predict", "E"]) / 1e3
    print(f"in the trace: {res['outside_predict_ms']['before']} ms before "
          f"the predict span, {res['outside_predict_ms']['after']} ms after "
          f"it, inside the classify span")
    if abs(uncovered - outside["total"]) > 0.1 * doc["wall_ms"]:
        fail(f"phases {phases} and the measured host work "
             f"{outside['total']} ms do not make the region's "
             f"{doc['wall_ms']} ms within 10 %")
    want = np.load(preds_path)
    train, test = load_arff(tr), load_arff(te)
    oracle = knn_oracle(train.features, train.labels, test.features, 5,
                        train.num_classes)
    if not np.array_equal(want, oracle):
        fail("the default path disagrees with the oracle")
    print(f"default path: backend cuda, no warning, launches {got}, "
          f"knn_predict_calls_total{{backend=cuda}} present, phases "
          f"{phases} against the region's {doc['wall_ms']} ms, predictions "
          f"equal to the oracle's ({smi})")
    # Obs off and on in turns: the result line's ms and the region's float
    # ms (obs on: the metrics document's wall_ms; obs off: the ladder call
    # the region times, timed directly on the same Datasets).
    pairs = []
    opts = {"device": "cuda", "query_tile": 256, "train_tile": 2048,
            "precision": "exact"}
    degrade.predict_with_ladder("cuda", train, test, 5, opts)  # warm
    for _ in range(OBS_PAIRS):
        pair = {}
        for mode in ("off", "on"):
            extra = ["--metrics-out", metrics_path] if mode == "on" else []
            rc, lines, _, _, _ = run(["5", "--warmup", *extra],
                                     f"obs {mode}")
            if rc != 0:
                fail(f"obs {mode} run exited {rc}")
            if mode == "on":
                obs.enable()
            try:
                with RegionTimer() as t:
                    degrade.predict_with_ladder("cuda", train, test, 5, opts)
            finally:
                if mode == "on":
                    obs.disable()
                    obs.reset()
            region = t.ns / 1e6
            region_cli = phases_cli = None
            if mode == "on":
                with open(metrics_path) as fh:
                    doc = json.load(fh)
                region_cli = doc["wall_ms"]
                phases_cli = sum(doc["phases"].values())
            pair[mode] = {"line_ms": _ms_of(lines[0]), "region_ms": region,
                          "cli_region_ms": region_cli,
                          "cli_phases_ms": phases_cli}
        pairs.append(pair)
        print(f"obs pair: {pair} ({smi})")
    res["obs_pairs"] = pairs

    # 2. The native personas: no kernel launches, the same predictions.
    res["native"] = {}
    for argv, name in ((["5", "--persona", "main"], "native"),
                       (["5", "8", "--persona", "multi-thread"], "native-mt")):
        rc, lines, err, got, wall = run(
            [*argv, "--json", "--dump-predictions", preds_path],
            f"--persona {argv[-1]}")
        if rc != 0 or json.loads(lines[1])["backend"] != name:
            fail(f"{name}: rc {rc}, {lines}")
        if any(got.values()):
            fail(f"{name} launched a kernel: {got}")
        if not np.array_equal(np.load(preds_path), want):
            fail(f"{name}'s predictions differ from cuda's and the oracle's")
        res["native"][name] = {"line_ms": _ms_of(lines[0]), "wall_ms": wall}
    libs = sorted(p.name for p in (REPO / "build" / "knn_tpu_torch"
                                   / "native").glob("lib*.so"))
    print(f"native personas: predictions equal to cuda's and the oracle's, "
          f"no kernel launched; {res['native']}; libraries {libs} ({smi})")

    # 3. Faults on the card rung.
    res["faults"] = {}
    for spec in ("device.put=once", "backend.compile=once"):
        with faults.inject(spec) as plan:
            rc, lines, err, got, _ = run(
                ["5", "--backend", "cuda", "--metrics-out", metrics_path,
                 "--dump-predictions", preds_path], spec)
        with open(metrics_path) as fh:
            retries = sum(r["value"] for r in json.load(fh)["metrics"].get(
                "knn_retry_total", []))
        if (rc != 0 or retries != 1 or got["stripe_scan"] < 1
                or plan.stats()[spec.split("=")[0]]["fired"] != 1
                or not np.array_equal(np.load(preds_path), want)):
            fail(f"{spec}: rc {rc}, knn_retry_total {retries}, launches "
                 f"{got}, {plan.stats()}")
        res["faults"][spec] = {"line_ms": _ms_of(lines[0]),
                               "retries": retries, "launches": got}
    with faults.inject("device.put=always"):
        rc, lines, err, got, _ = run(["5", "--backend", "cuda"],
                                     "device.put=always")
    err_lines = err.strip().splitlines()
    if (rc != 1 or lines or len(err_lines) != 1
            or not err_lines[0].startswith("error: DeviceError: ")
            or "falling back" in err or any(got.values())):
        fail(f"device.put=always: rc {rc}, stdout {lines}, stderr {err!r}, "
             f"launches {got}")
    res["faults"]["device.put=always"] = {"rc": rc, "stderr": err_lines[0]}
    with faults.inject("device.put=once:oom"):
        rc, lines, err, got, _ = run(
            ["5", "--backend", "cuda", "--dump-predictions", preds_path],
            "device.put=once:oom")
    if (rc != 0 or "out of memory; retrying with query_batch=859" not in err
            or not np.array_equal(np.load(preds_path), want)
            or got["stripe_scan"] < 2):
        fail(f"device.put=once:oom: rc {rc}, stderr {err!r}, launches {got}")
    res["faults"]["device.put=once:oom"] = {"line_ms": _ms_of(lines[0]),
                                            "launches": got}
    # The halving outside stripe_route_ok reruns the tile kernel: k = 32 on
    # the large files, and the exact form on the wide ones (784 features).
    wide_tr, wide_te = (str(data_dir / f"wide-{s}.arff")
                        for s in ("train", "test"))
    wide_train, wide_test = load_arff(wide_tr), load_arff(wide_te)
    for name, files, argv, oracle_q in (
            ("k=32", (tr, te), ["32"], test.num_instances),
            ("wide exact", (wide_tr, wide_te), ["5", "--precision", "exact"],
             128)):
        tr_ds, te_ds = (train, test) if files[0] == tr else (wide_train,
                                                             wide_test)
        half = te_ds.num_instances // 2
        out, errs = io.StringIO(), io.StringIO()
        reset()
        with faults.inject("device.put=once:oom"), \
                contextlib.redirect_stderr(errs):
            rc = cli.run([*files, *argv, "--backend", "cuda",
                          "--dump-predictions", preds_path], stdout=out)
        got, err = counts(), errs.getvalue()
        print(f"device.put=once:oom, {name}: rc {rc}, launches {got} ({smi})")
        for line in out.getvalue().splitlines() + err.splitlines():
            print(f"  {line}")
        k_case = int(argv[0])
        oracle = knn_oracle(tr_ds.features, tr_ds.labels,
                            te_ds.features[:oracle_q], k_case,
                            tr_ds.num_classes)
        preds = np.load(preds_path) if rc == 0 else None
        if (rc != 0 or f"retrying with query_batch={half}" not in err
                or got["tile_exact"] != 2 or got["stripe_scan"]
                or not np.array_equal(preds[:oracle_q], oracle)):
            fail(f"device.put=once:oom, {name}: rc {rc}, stderr {err!r}, "
                 f"launches {got}")
        res["faults"][f"device.put=once:oom {name}"] = {
            "line_ms": _ms_of(out.getvalue().splitlines()[0]),
            "launches": got, "oracle_queries": oracle_q}
    print(f"faults on the card rung: once -> recovered, equal predictions, "
          f"one retry; always -> exit 1, one typed error line, no host rung; "
          f"once:oom -> halved to 859 queries a call, equal predictions; at "
          f"k = 32 and at the wide exact form the halved rerun launches the "
          f"tile kernel twice and agrees with the oracle ({smi})")

    # 4. --approx at 1,718 queries (above JAX's guard sample of 128): the
    # exact selection, on the kernels.
    rc, lines, err, got, _ = run(
        ["5", "--approx", "--warmup", "--dump-predictions", preds_path],
        "--approx")
    if (rc != 0 or "warning" in err or got["stripe_scan"] < 1
            or not np.array_equal(np.load(preds_path), want)):
        fail(f"--approx: rc {rc}, stderr {err!r}, launches {got}")
    res["approx"] = {"line_ms": _ms_of(lines[0]), "launches": got}

    # 5. Ingest: the native parser against the pure-Python one.
    res["ingest"] = {}
    for name in ("large-train", "large-test", "wide-train", "wide-test"):
        path = str(data_dir / f"{name}.arff")
        mb = os.path.getsize(path) / 1e6
        row = {"MB": mb}
        parsed = {}
        for parser, fn in (("native", arff_native.parse),
                           ("python", pyarff.parse_arff_file)):
            t0 = time.perf_counter()
            parsed[parser] = fn(path)
            ms = (time.perf_counter() - t0) * 1e3
            row[parser] = {"ms": ms, "MB_per_s": mb / (ms / 1e3)}
        for field in ("features", "labels", "raw_targets"):
            a, b = (getattr(parsed[p], field) for p in ("native", "python"))
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                fail(f"{name}: {field} differ between the parsers")
        res["ingest"][name] = row
        print(f"ingest {name} ({mb} MB): byte-equal; {row}")
    print(f"cli_ladder: {json.dumps(res)}")
    return res


def phase_probe_selection(torch, dev, cuda_knn) -> dict:
    """P2's entry point, ``tune_stripe_selection.main``, on the large shape
    (k = 5), with the counters read around it; then each selection's kernel
    alone at the shipped plan, beside its plain version and the insertion
    scan."""
    from knn_tpu_torch.probes import tune_stripe_selection as probe
    from knn_tpu_torch.probes.data import load_large

    variant, scan = cuda_knn.knn_stripe_scan_variant, cuda_knn.knn_stripe_scan
    for mode in variant.launches:
        variant.launches[mode] = 0
    scan.launches = 0
    t0 = time.perf_counter()
    rc = probe.main([])
    launches = {**variant.launches, "insert": scan.launches}
    print(f"tune_stripe_selection.main took {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")
    if rc != 0:
        raise SystemExit("probe_selection: a parity check failed")
    if min(launches.values()) < 1:
        raise SystemExit(f"probe_selection: a kernel was never launched: "
                         f"{launches}")
    train, test = load_large()
    (n, d), q, k = train.features.shape, test.num_instances, probe.K
    tx = torch.from_numpy(train.features.copy()).to(dev)
    queries = [torch.from_numpy(test.features + np.float32(i) * np.float32(1e-7))
               .to(dev) for i in range(12)]
    plan = cuda_knn.stripe_split_plan(n, q, dev, d, k)
    res = {"launches": launches, "ms": {}, "plain_ms": {}, "max_abs_err": {},
           "bound": scan_bound_ms(q, n, d, k, plan[0]),
           "shape": f"q={q} n={n} d={d} k={k} splits={plan[0]}"}
    check_equal("probe_selection insert keys", torch,
                scan(tx, queries[0], n, k, *plan),
                cuda_knn.knn_stripe_scan_reference(tx, queries[0], n, k, *plan))
    res["ms"]["insert"] = cuda_ms(scan, [(tx, qb, n, k, *plan)
                                         for qb in queries], reps=12)
    for mode in cuda_knn.SELECT_MODES:
        got = variant(tx, queries[0], n, k, mode, *plan)
        want = cuda_knn.knn_stripe_scan_variant_reference(
            tx, queries[0], n, k, mode, *plan)
        check_equal(f"probe_selection {mode} keys", torch, got, want)
        res["max_abs_err"][mode] = max_err(torch, *(
            cuda_knn._unpack_keys(x)[0] for x in (got, want)))
        res["ms"][mode] = cuda_ms(variant, [(tx, qb, n, k, mode, *plan)
                                            for qb in queries], reps=12)
        res["plain_ms"][mode] = cuda_ms(
            cuda_knn.knn_stripe_scan_variant_reference,
            [(tx, qb, n, k, mode, *plan) for qb in queries[:3]], reps=3)
    print(f"at the shipped scan's plan ({plan[0]} splits of {plan[1]} rows, "
          f"each {plan[1] // cuda_knn._TILE_ROWS} tiles): insert and every "
          "selection's keys bit-equal to their plain versions; median of 12 "
          f"CUDA-event times: {res['ms']} ms; plain versions (median of 3) "
          f"{res['plain_ms']} ms; bound {res['bound'][0]} ms "
          f"({res['bound'][1]})")
    return res


def phase_probe_wide(torch, dev, probe_matmul) -> dict:
    """P1's entry point, ``probe_mnist_r3.main``, at its shape (classify_wide's
    65,536 x 784 train, 2,048 queries), with the counter read around it;
    then P1 alone against its plain version (float rows) and timed beside
    it and beside the library call computing the same function: the
    bfloat16 product with float32 output (``torch.mm(..., out_dtype=
    torch.float32)``, so the products are not rounded to bfloat16 before
    the fold, as P1's are not), then the reshape-sum."""
    from knn_tpu_torch.probes import probe_mnist_r3 as probe

    pm = probe_matmul.pure_matmul
    pm.launches = 0
    t0 = time.perf_counter()
    rc = probe.main([])
    launches = pm.launches
    print(f"probe_mnist_r3.main took {time.perf_counter() - t0:.1f} s; "
          f"pure_matmul launches {launches}")
    if rc != 0 or launches < 1:
        raise SystemExit(f"probe_wide: exit {rc}, launches {launches}")
    train, test = probe.make_data(probe.N, probe.Q)
    n, q, d, block_n = probe.N, probe.Q, probe.D, probe.BLOCK_N
    txb = torch.from_numpy(train).to(dev, torch.bfloat16)
    bufs = [b.to(torch.bfloat16) for b in probe.query_buffers(test, dev)]
    plain = probe_matmul.pure_matmul_reference(txb, bufs[0], block_n)
    err = check_matmul_near("probe_wide", torch, probe_matmul,
                            pm(txb, bufs[0], block_n), plain,
                            txb, bufs[0], block_n)

    def library(qb):
        return torch.mm(qb, txb.T, out_dtype=torch.float32).reshape(
            q, n // block_n, 8, block_n // 8).sum(3).sum(1)

    check_matmul_near("probe_wide library call", torch, probe_matmul,
                      library(bufs[0]), plain, txb, bufs[0], block_n)
    # The other fold layouts, and a train set that ends inside a tile.
    for bn, rows in ((8, n), (256, n), (block_n, n - 77)):
        t = txb[:rows]
        err = max(err, check_matmul_near(
            f"probe_wide block_n={bn} n={rows}", torch, probe_matmul,
            pm(t, bufs[1], bn), probe_matmul.pure_matmul_reference(
                t, bufs[1], bn), t, bufs[1], bn))

    res = {"launches": launches, "max_abs_err": err,
           "ms": cuda_ms(pm, [(txb, qb, block_n) for qb in bufs], reps=12),
           "plain_ms": cuda_ms(probe_matmul.pure_matmul_reference,
                               [(txb, qb, block_n) for qb in bufs[:3]], reps=3),
           "library_ms": cuda_ms(library, [(qb,) for qb in bufs], reps=12),
           "bound": matmul_bound_ms(q, n, d),
           "shape": f"q={q} n={n} d={d} block_n={block_n}"}
    rate = 2 * q * n * d / res["ms"] / 1e9
    print(f"P1 at {res['shape']}: {res['ms']} ms (median of 12, CUDA events), "
          f"{rate} TFLOP/s, {100 * rate / 989} % of the bf16 tensor-core "
          f"peak (989 TFLOP/s); plain {res['plain_ms']} ms (median of 3), "
          "library call (torch.mm bf16, float32 out, + reshape-sum) "
          f"{res['library_ms']} ms, bound {res['bound'][0]} ms "
          f"({res['bound'][1]}); max |kernel - plain| {err} within atol = "
          "2*(D+m)*2^-23*S at block_n 8, 256 and 1,024 and at "
          f"n = {n - 77}")
    return res


# The serve phase: concurrency levels of closed-loop clients on the xl index
# (single-row /predict at each c, then 64-row requests at c = 8).
SERVE_LEVELS = (("predict", 1, 1, 200), ("predict", 1, 8, 800),
                ("predict", 1, 32, 1600), ("predict", 64, 8, 160))


class _Client:
    """A keep-alive HTTP client of one server (one per load thread)."""

    def __init__(self, base: str):
        import http.client
        from urllib.parse import urlparse

        u = urlparse(base)
        self.conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)

    def call(self, method: str, path: str, payload=None, headers=None):
        body = None if payload is None else json.dumps(payload)
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        self.conn.request(method, path, body=body, headers=hdrs)
        resp = self.conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data

    def close(self):
        self.conn.close()


def _dispatch_breakdown(spans) -> dict:
    """Mean ms per ``serve.dispatch`` span, and of each kind of span
    directly under it (``distance``: the retrieval's host entry and the
    kernels' launch; ``fetch``: the wait for the answers; ``vote``), over
    ``spans``; ``other`` is the rest of the dispatch (the batch's concat,
    the stager, the per-request scatter and accounting)."""
    dispatches = [s for s in spans if s.name == "serve.dispatch"
                  and s.dur_ns is not None]
    if not dispatches:
        return {}
    ids = {id(s) for s in dispatches}
    out = {"serve.dispatch": sum(s.dur_ms for s in dispatches)}
    for s in spans:
        if s.parent is not None and id(s.parent) in ids:
            out[s.name] = out.get(s.name, 0.0) + s.dur_ms
    out["other"] = out["serve.dispatch"] - sum(
        v for k, v in out.items() if k != "serve.dispatch")
    return {k: v / len(dispatches) for k, v in out.items()}


def _hist(registry, name: str) -> "tuple[int, float]":
    """(count, sum) of an unlabeled histogram of the global registry."""
    count, total = 0, 0.0
    for inst in registry.instruments():
        if inst.name == name:
            count += inst.count
            total += inst.sum
    return count, total


# The load generator, run as its own process so that its threads do not
# share the server's interpreter lock: argv[1] is a JSON spec (base URL,
# kind, clients, the request count, the .npy file of query blocks); it
# prints one JSON object (answers by request, latencies in ms, wall s).
_LOAD_CLIENT = r"""
import http.client, json, sys, threading, time
from urllib.parse import urlparse
import numpy as np
spec = json.loads(sys.argv[1])
blocks = np.load(spec["queries"])
u = urlparse(spec["base"])
answers, lat, errors = {}, [], []
lock = threading.Lock()
def worker(t):
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    for j in range(t, spec["total"], spec["clients"]):
        body = json.dumps({"instances": blocks[j].tolist()})
        t0 = time.perf_counter()
        conn.request("POST", "/" + spec["kind"], body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        ms = (time.perf_counter() - t0) * 1e3
        with lock:
            if resp.status == 200:
                lat.append(ms)
            else:
                errors.append([resp.status, data.decode()[:200]])
            answers[j] = json.loads(data)
    conn.close()
threads = [threading.Thread(target=worker, args=(t,))
           for t in range(spec["clients"])]
t0 = time.perf_counter()
for th in threads:
    th.start()
for th in threads:
    th.join()
wall = time.perf_counter() - t0
print(json.dumps({"answers": answers, "lat": lat, "wall": wall,
                  "errors": errors}))
"""


def _closed_loop(base: str, kind: str, blocks: np.ndarray, clients: int,
                 tolerate=()):
    """``clients`` keep-alive connections from a separate process, each
    sending its share of the requests ``blocks[j]`` back to back. Returns
    the answers by request, the latencies (ms) of the 200 answers and the
    wall (s). A status in ``tolerate`` is answered (its error document),
    any other non-200 fails."""
    path = REPO / "build" / "chip_smoke" / "serve-queries.npy"
    np.save(path, blocks)
    spec = {"base": base, "kind": kind, "clients": clients,
            "total": int(blocks.shape[0]), "queries": str(path)}
    out = subprocess.run([sys.executable, "-c", _LOAD_CLIENT,
                          json.dumps(spec)], capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"serve: the load client exited {out.returncode}: "
                         f"{out.stderr[-2000:]}")
    doc = json.loads(out.stdout)
    answers = {int(j): a for j, a in doc["answers"].items()}
    errors = [e for e in doc["errors"] if e[0] not in tolerate]
    if errors or len(answers) != blocks.shape[0]:
        raise SystemExit(f"serve: {len(errors)} failed requests "
                         f"({errors[:2]}), {len(answers)}/"
                         f"{blocks.shape[0]} answered")
    return answers, doc["lat"], doc["wall"]


def _near_tie_ok(train_x, queries, ki, oi, d: int) -> bool:
    """Indices equal to the oracle's, except in rows where the two lists
    are equally near in float64 to within the float rule rtol = d * 2^-24
    (the oracle sums the features in another order, so the two may order
    a near tie differently)."""
    for r in np.nonzero((np.asarray(ki) != np.asarray(oi)).any(axis=1))[0]:
        q = queries[r].astype(np.float64)
        dk = ((train_x[ki[r]].astype(np.float64) - q) ** 2).sum(axis=1)
        do = ((train_x[oi[r]].astype(np.float64) - q) ** 2).sum(axis=1)
        if not np.allclose(np.sort(dk), np.sort(do), rtol=d * 2.0 ** -24,
                           atol=0):
            return False
    return True


def _start_server(app):
    """``app`` behind an HTTP server on an ephemeral port, served by a
    thread: ``(server, thread, base_url)``."""
    import threading

    from knn_tpu_torch.serve.server import make_server

    server = make_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    host, port = server.server_address[:2]
    return server, th, f"http://{host}:{port}"


def _stop_server(server, th, app):
    server.shutdown()
    server.server_close()
    th.join(timeout=30)
    app.close()


def phase_serve(torch, cuda_knn, tile_knn, train_path, test_path, xl_x, xl_y,
                smi) -> dict:
    """save-index and serve on the card (ROADMAP A8a): the index artifacts,
    an in-process server on xl under closed-loop HTTP clients, the wide
    index through the tile kernel, the subprocess lifecycle on the large
    index, faults at the dispatch, and the card's memory across reloads."""
    import gc

    from knn_tpu_torch import cli, obs
    from knn_tpu_torch.backends.oracle import knn_oracle, oracle_kneighbors
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.models.knn import DEFAULT_BATCH_BUCKETS, KNNClassifier
    from knn_tpu_torch.resilience import faults
    from knn_tpu_torch.serve.artifact import load_index, save_index
    from knn_tpu_torch.serve.server import ServeApp

    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    tile_scan = tile_knn.knn_tile_scan
    res = {"levels": {}, "smi": smi}

    def fail(msg):
        raise SystemExit(f"serve: {msg}")

    def reset_counts():
        scan.launches = merge.launches = 0
        for form in tile_scan.launches:
            tile_scan.launches[form] = 0

    def counts():
        return {"stripe_scan": scan.launches, "stripe_merge": merge.launches,
                **{f"tile_{f}": n for f, n in tile_scan.launches.items()}}

    data_dir = REPO / "build" / "chip_smoke"
    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    q_all = test.features
    buckets = tuple(sorted({b for b in DEFAULT_BATCH_BUCKETS if b < 256}
                           | {256}))

    # 1. Index artifacts.
    idx_large = data_dir / "idx-large"
    idx_xl = data_dir / "idx-xl"
    idx_wide = data_dir / "idx-wide"
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = cli.run(["save-index", str(train_path), str(idx_large), "--k", "5"],
                 stdout=out)
    if rc != 0:
        fail(f"save-index exited {rc}")
    print(out.getvalue().strip(), f"({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    save_index(KNNClassifier(k=10).fit(Dataset(xl_x, xl_y)), idx_xl)
    print(f"wrote index {idx_xl}: {xl_x.shape[0]} rows x {xl_x.shape[1]} "
          f"features, k=10 ({time.perf_counter() - t0:.2f} s)")
    wide_train = load_arff(str(data_dir / "wide-train.arff"))
    wide_test = load_arff(str(data_dir / "wide-test.arff"))
    save_index(KNNClassifier(k=5).fit(wide_train), idx_wide)
    print(f"wrote index {idx_wide}: {wide_train.num_instances} rows x "
          f"{wide_train.num_features} features, k=5")

    # 2. In-process server on xl, closed-loop clients at each level.
    obs.enable()
    obs.reset()
    model = load_index(idx_xl)
    app = ServeApp(model, max_batch=256, max_wait_ms=2.0,
                   batch_buckets=buckets, cost_accounting=True,
                   index_version="xl")
    t0 = time.perf_counter()
    warmed = app.warm()
    print(f"xl warmed in {time.perf_counter() - t0:.2f} s: {warmed}")
    mem_first = torch.cuda.memory_allocated()
    server, th, base = _start_server(app)
    sync_d, sync_i = model.kneighbors(test)
    sync_p = model.predict_from_candidates(sync_d, sync_i)
    sample = np.random.default_rng(1).choice(len(q_all), 64, replace=False)
    _, oi = oracle_kneighbors(xl_x, q_all[sample], 10)
    oracle_p = knn_oracle(xl_x, xl_y, q_all[sample], 10, int(xl_y.max()) + 1)
    if not np.array_equal(oracle_p, sync_p[sample]):
        fail("the synchronous xl predictions differ from the oracle's")
    if not _near_tie_ok(xl_x, q_all[sample], sync_i[sample], oi, 11):
        fail("the synchronous xl neighbors differ from the oracle's")
    registry = obs.registry()
    tx = None
    for kind, rows, clients, total in SERVE_LEVELS:
        name = f"{kind}_r{rows}_c{clients}"

        starts = [(j * rows) % (len(q_all) - rows) for j in range(total)]
        blocks = np.stack([q_all[s:s + rows] for s in starts])
        n_spans = len(obs.tracer().spans())
        b0 = _hist(registry, "knn_serve_batch_size")
        r0 = _hist(registry, "knn_serve_batch_rows")
        d0 = _hist(registry, "knn_serve_dispatch_ms")
        reset_counts()
        answers, lat, wall = _closed_loop(base, kind, blocks, clients)
        got = counts()
        b1 = _hist(registry, "knn_serve_batch_size")
        r1 = _hist(registry, "knn_serve_batch_rows")
        d1 = _hist(registry, "knn_serve_dispatch_ms")
        batches = b1[0] - b0[0]
        if got["stripe_scan"] != batches or got["stripe_merge"] != batches:
            fail(f"{name}: {batches} batches but launches {got}")
        if any(got[f"tile_{f}"] for f in tile_scan.launches):
            fail(f"{name}: the tile kernel launched at xl: {got}")
        for j, doc in answers.items():
            s = starts[j]
            if doc["predictions"] != sync_p[s:s + rows].tolist():
                fail(f"{name}: request {j} differs from the synchronous "
                     f"answer")
        mean_rows = (r1[1] - r0[1]) / batches
        dispatch_ms = (d1[1] - d0[1]) / batches
        qb = [torch.from_numpy(np.array(
            q_all[i:i + max(1, round(mean_rows))])).to("cuda")
            for i in range(12)]
        if tx is None:
            tx = cuda_knn.cached_train(xl_x, torch.device("cuda"),
                                       model.train_.device_cache)
        kern_ms = cuda_ms(cuda_knn.knn_stripe_candidates,
                          [(tx, b, xl_x.shape[0], 10) for b in qb], reps=12)
        lat.sort()
        lv = {
            "requests": total, "rows": rows, "clients": clients,
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "qps": total / wall, "rows_per_s": total * rows / wall,
            "batches": batches,
            "mean_batch_requests": (b1[1] - b0[1]) / batches,
            "mean_batch_rows": mean_rows,
            "dispatch_ms_mean": dispatch_ms,
            "kernels_ms": kern_ms, "kernels_share": kern_ms / dispatch_ms,
            "dispatch_breakdown_ms": _dispatch_breakdown(
                obs.tracer().spans()[n_spans:]),
            "launches": got,
        }
        res["levels"][name] = lv
        print(f"xl {name}: {json.dumps(lv)}")
    # /kneighbors on a sample: 4-row requests, against the synchronous
    # answer (bit-equal) and the oracle.
    reset_counts()
    answers, _, _ = _closed_loop(
        base, "kneighbors", q_all[sample].reshape(16, 4, -1), 4)
    for j, doc in answers.items():
        rows = sample[4 * j:4 * j + 4]
        kd = np.asarray(doc["distances"], np.float32)
        ki = np.asarray(doc["indices"])
        if not (np.array_equal(kd, sync_d[rows])
                and np.array_equal(ki, sync_i[rows])):
            fail(f"/kneighbors request {j} differs from the synchronous one")
        if not _near_tie_ok(xl_x, q_all[rows], ki, oi[4 * j:4 * j + 4], 11):
            fail(f"/kneighbors request {j} differs from the oracle")
    print(f"xl /kneighbors: 16 requests of 4 rows bit-equal to the "
          f"synchronous retrieval and equal to the oracle; launches "
          f"{counts()}")
    st, _, body = _Client(base).call("GET", "/debug/capacity")
    cap = json.loads(body)
    res["capacity"] = cap["capacity"]
    res["cost_totals"] = cap["cost"]["totals"]

    # 5. Faults at the dispatch (in-process, the xl app).
    feats = [q_all[16 * i:16 * i + 16] for i in range(16)]
    reset_counts()
    with faults.inject("serve.dispatch=once:oom") as plan:
        handles = [app.batcher.submit(f, "predict") for f in feats]
        preds = [h.result(timeout=60) for h in handles]
    got = counts()
    if (plan.stats()["serve.dispatch"]["fired"] != 1
            or app.batcher.max_batch != 128 or got["stripe_scan"] < 2
            or any(not np.array_equal(p, sync_p[16 * i:16 * i + 16])
                   for i, p in enumerate(preds))):
        fail(f"serve.dispatch=once:oom: max_batch {app.batcher.max_batch}, "
             f"launches {got}, {plan.stats()}")
    res["faults"] = {"once:oom": {"max_batch": app.batcher.max_batch,
                                  "launches": got}}
    print(f"serve.dispatch=once:oom: max_batch 256 -> "
          f"{app.batcher.max_batch}, the same kernels launched {got}, "
          f"answers unchanged")
    reset_counts()
    statuses = []
    with faults.inject("serve.dispatch=always"):
        cl = _Client(base)
        for j in range(8):
            st, _, body = cl.call("POST", "/predict",
                                  {"instances": q_all[j:j + 1].tolist()})
            statuses.append((st, json.loads(body).get("error", "")[:60]))
        st, _, body = cl.call("GET", "/healthz")
        health = json.loads(body)
    got = counts()
    fallbacks = [dict(i.labels) for i in registry.instruments()
                 if i.name == "knn_serve_fallback_total"
                 and dict(i.labels)["to"] != dict(i.labels)["from_rung"]]
    if (any(s != 500 or not e.startswith("DeviceError") for s, e in statuses)
            or health["breaker"] != "open" or any(got.values())
            or fallbacks):
        fail(f"serve.dispatch=always: statuses {statuses}, breaker "
             f"{health['breaker']}, launches {got}, moves {fallbacks}")
    time.sleep(1.2)  # the breaker's cooldown (KNN_TPU_BREAKER_COOLDOWN_MS)
    for j in range(3):
        st, _, body = cl.call("POST", "/predict",
                              {"instances": q_all[j:j + 1].tolist()})
        if st != 200 or json.loads(body)["predictions"] != \
                sync_p[j:j + 1].tolist():
            fail(f"after the fault: status {st} {body[:200]!r}")
    st, _, body = cl.call("GET", "/healthz")
    cl.close()
    if json.loads(body)["breaker"] != "closed":
        fail("the breaker did not close after the card recovered")
    res["faults"]["always"] = {"statuses": sorted({s for s, _ in statuses}),
                               "breaker": "open", "launches": got}
    print(f"serve.dispatch=always: every request {statuses[0][0]} "
          f"'{statuses[0][1]}...', the breaker open, no kernel and no other "
          f"route; after the cooldown the probes answered and it closed")

    # 6. Memory across three reloads of the xl index.
    _stop_server(server, th, app)
    del app, model, tx
    gc.collect()
    app = ServeApp(load_index(idx_xl), max_batch=256, batch_buckets=buckets,
                   index_path=str(idx_xl), cost_accounting=True)
    app.warm()
    gc.collect()
    mem_first = torch.cuda.memory_allocated()
    for _ in range(3):
        app.reload()
        gc.collect()
    mem_after = torch.cuda.memory_allocated()
    index_bytes = 2 * xl_x.nbytes  # the train and its feature-major copy
    if mem_after > mem_first + index_bytes:
        fail(f"memory after three reloads {mem_after} B against {mem_first} "
             f"B after the first load (one index: {index_bytes} B)")
    res["memory"] = {"first": mem_first, "after_3_reloads": mem_after,
                     "index_bytes": index_bytes}
    print(f"memory_allocated after the first load {mem_first} B, after "
          f"three reloads {mem_after} B (one index {index_bytes} B)")
    app.close()
    del app
    gc.collect()
    torch.cuda.empty_cache()

    # 3. Wide: the tile kernel's exact form and the merge.
    wmodel = load_index(idx_wide)
    wapp = ServeApp(wmodel, max_batch=64, batch_buckets=(16, 32, 64),
                    cost_accounting=True)
    wapp.warm()
    server, th, base = _start_server(wapp)
    wq = wide_test.features[:48]
    reset_counts()
    answers, lat, wall = _closed_loop(base, "predict", wq.reshape(24, 2, -1),
                                      4)
    got = counts()
    _stop_server(server, th, wapp)
    if got["tile_exact"] < 1 or got["stripe_merge"] < 1 or got["stripe_scan"]:
        fail(f"wide: launches {got}")
    preds = np.concatenate([answers[j]["predictions"] for j in range(24)])
    wdev = torch.device("cuda")
    wtx = torch.from_numpy(wide_train.features.copy()).to(wdev)
    _, ri = cuda_knn.knn_stripe_candidates_reference(
        wtx, torch.from_numpy(wq.copy()).to(wdev), wide_train.num_instances, 5)
    plain = np.array([np.bincount(r, minlength=wide_train.num_classes)
                      .argmax() for r in wide_train.labels[ri.cpu().numpy()]])
    oracle_w = knn_oracle(wide_train.features, wide_train.labels, wq, 5,
                          wide_train.num_classes)
    if not (np.array_equal(preds, plain) and np.array_equal(preds, oracle_w)):
        fail("wide: answers differ from the plain version or the oracle")
    del wtx
    lat.sort()
    res["wide"] = {"requests": 24, "rows": 2, "clients": 4,
                   "p50_ms": lat[len(lat) // 2], "qps": 24 / wall,
                   "launches": got}
    print(f"wide {wide_train.num_instances}x{wide_train.num_features}: 24 "
          f"requests of 2 rows at c=4, launches {got}, predictions equal "
          f"to the plain version and the oracle; {json.dumps(res['wide'])}")

    # 4. The subprocess lifecycle on the large index.
    res["lifecycle"] = _serve_lifecycle(train_path, idx_large, q_all,
                                        knn_oracle, train)
    obs.disable()
    print("serve: " + json.dumps(res))
    return res


def _serve_lifecycle(train_path, idx_large, q_all, knn_oracle, train) -> dict:
    """``python -m knn_tpu_torch serve IDX --port 0`` as a user runs it:
    the banner, /healthz, both /metrics expositions, a request id in the
    flight recorder, /debug/profile under load, SIGHUP reload after a
    re-save, SIGTERM."""
    import signal
    import threading

    def fail(msg):
        proc.kill()
        raise SystemExit(f"serve lifecycle: {msg}")

    proc = subprocess.Popen(
        [sys.executable, "-m", "knn_tpu_torch", "serve", str(idx_large),
         "--port", "0", "--drain-timeout-s", "5"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    t0 = time.perf_counter()
    banner = proc.stdout.readline()
    boot_s = time.perf_counter() - t0
    if "ready on http://" not in banner:
        fail(f"no ready banner: {banner!r} {proc.stderr.read()[-2000:]}")
    base = banner.split("ready on ")[1].split()[0]
    out = {"boot_s": boot_s}
    cl = _Client(base)
    try:
        st, _, body = cl.call("GET", "/healthz")
        h = json.loads(body)
        mem = h["device"]["memory"]
        if (st != 200 or not h["ready"]
                or mem[0]["source"] != "memory_stats" or mem[0]["in_use"] <= 0):
            fail(f"/healthz {st}: {h}")
        want = knn_oracle(train.features, train.labels, q_all[:64], 5,
                          train.num_classes)
        st, hdrs, body = cl.call("POST", "/predict",
                                 {"instances": q_all[:64].tolist()},
                                 {"x-request-id": "chip-smoke-1"})
        doc = json.loads(body)
        if st != 200 or doc["predictions"] != want.tolist():
            fail(f"/predict {st}: differs from the oracle")
        before = doc["predictions"]
        version0 = doc["index_version"]
        st, _, body = cl.call("GET", "/debug/requests?id=chip-smoke-1")
        if st != 200 or json.loads(body)["requests"][0]["outcome"] != "ok":
            fail(f"/debug/requests?id= {st} {body[:300]!r}")
        st, _, prom = cl.call("GET", "/metrics")
        st2, hdrs, om = cl.call("GET", "/metrics", headers={
            "Accept": "application/openmetrics-text"})
        om = om.decode()
        if (st != 200 or b"knn_serve_request_ms_bucket" not in prom
                or st2 != 200 or not om.endswith("# EOF\n")
                or '# {trace_id="' not in om):
            fail("/metrics expositions")
        # /debug/profile under load: two threads keep posting.
        stop_load = threading.Event()

        def load():
            c = _Client(base)
            while not stop_load.is_set():
                c.call("POST", "/predict", {"instances": q_all[:8].tolist()})
            c.close()

        loaders = [threading.Thread(target=load) for _ in range(2)]
        for t in loaders:
            t.start()
        time.sleep(0.2)
        st, _, body = cl.call("GET", "/debug/profile?ms=200")
        stop_load.set()
        for t in loaders:
            t.join(timeout=30)
        trace = json.loads(body)
        names = [e.get("name", "") for e in trace.get("traceEvents", [])]
        kernel_events = sum("stripe_scan" in n for n in names)
        host_spans = sum(n in ("serve.dispatch", "distance") for n in names)
        if st != 200 or kernel_events < 1:
            fail(f"/debug/profile: {st}, {kernel_events} stripe-scan events "
                 f"of {len(names)}, source "
                 f"{trace.get('otherData', {}).get('source')}")
        out["profile"] = {"events": len(names),
                          "stripe_scan_events": kernel_events,
                          "worker_host_spans": host_spans}
        # Re-save, then SIGHUP: a new version, identical predictions.
        time.sleep(0.01)
        rc = subprocess.run(
            [sys.executable, "-m", "knn_tpu_torch", "save-index",
             str(train_path), str(idx_large), "--k", "5"], cwd=str(REPO),
            capture_output=True, text=True, timeout=300).returncode
        if rc != 0:
            fail(f"re-save exited {rc}")
        proc.send_signal(signal.SIGHUP)
        deadline = time.time() + 120
        while time.time() < deadline:
            st, _, body = cl.call("GET", "/healthz")
            h = json.loads(body)
            if h["index_version"] != version0 and h["reloads"] == 1:
                break
            time.sleep(0.1)
        else:
            fail(f"SIGHUP: no reload seen ({h['index_version']})")
        st, _, body = cl.call("POST", "/predict",
                              {"instances": q_all[:64].tolist()})
        doc = json.loads(body)
        if doc["predictions"] != before or doc["index_version"] == version0:
            fail("after SIGHUP: predictions or version")
        out["reload"] = {"from": version0, "to": doc["index_version"]}
    finally:
        cl.close()
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        fail("SIGTERM: still running after 30 s")
    out["sigterm_exit"] = rc
    out["sigterm_s"] = time.perf_counter() - t0
    err = proc.stderr.read()
    if rc != 0 or "drained (clean=" not in err:
        fail(f"SIGTERM: exit {rc}, stderr {err[-1000:]!r}")
    print(f"lifecycle: banner after {boot_s:.2f} s, /healthz ready with its "
          f"device block, /metrics in both expositions (exemplars, # EOF), "
          f"x-request-id resolved, /debug/profile {out['profile']}, SIGHUP "
          f"{out['reload']}, SIGTERM exit {rc} in {out['sigterm_s']:.2f} s")
    return out


# The IVF phase (ROADMAP A9): the index family at xl.
IVF_CELLS = 1024         # ~sqrt(N) at xl (docs/INDEXES.md's rule of thumb)
IVF_SWEEP = (8, 32, 128)
IVF_SERVE_PROBES = 32
# (rows, nprobe) at which the host and device scorers are timed: the auto
# rule's crossing, in candidate elements (rows x largest count x d).
IVF_SCORER_GRID = ((1, 1), (1, 2), (1, 4), (1, 8), (1, 32), (16, 32),
                   (64, 32), (256, 32))
IVF_SERVE_LEVELS = (("predict", 1, 1, 200), ("predict", 1, 8, 800))


def f64_dists(x: np.ndarray, queries: np.ndarray, idx: np.ndarray):
    """float64 squared distances of each query to the rows ``idx [Q, k]``."""
    diff = x[idx].astype(np.float64) - queries[:, None, :].astype(np.float64)
    return (diff * diff).sum(axis=-1)


def phase_ivf(torch, cuda_knn, xl_x, xl_y, q_all, smi) -> dict:
    """The IVF index family on the card at xl: the k-means build (seeding
    on the host, the assignment steps on the card), save and load,
    parity (the assignment against its CPU version, full probe against
    the stripe kernel and the oracle, the two scorers bit for bit), the
    recall and rate sweep, the scorers' crossing, and ``serve
    --ivf-probes`` under closed-loop clients with one typed failure of the
    ivf rung answered by the stripe kernels."""
    import gc
    import statistics
    import threading

    from knn_tpu_torch import obs
    from knn_tpu_torch.backends.oracle import oracle_kneighbors
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.index import ivf as ivf_mod
    from knn_tpu_torch.index.ivf import IVFIndex
    from knn_tpu_torch.index.kmeans import (
        DEFAULT_BATCH_ROWS,
        _assign_batched,
        assign_batch,
    )
    from knn_tpu_torch.models.knn import (
        KNNClassifier,
        DEFAULT_BATCH_BUCKETS,
        candidate_padded_rows,
    )
    from knn_tpu_torch.obs.quality import recall_at_k
    from knn_tpu_torch.ops import segment_score as seg
    from knn_tpu_torch.resilience import faults
    from knn_tpu_torch.serve.artifact import load_index, save_index
    from knn_tpu_torch.serve.server import ServeApp, make_server

    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    dev = torch.device("cuda")
    n, d = xl_x.shape
    k = 10
    res = {"shape": f"n={n} d={d} cells={IVF_CELLS} k={k}", "smi": smi}

    def fail(msg):
        raise SystemExit(f"ivf: {msg}")

    # 1. The build, split: seeding (host), assignment steps (card), the
    # float64 updates (host).
    t = {}
    t0 = time.perf_counter()
    ivf = IVFIndex.build(xl_x, IVF_CELLS, seed=0, device=dev, timings=t)
    build_s = time.perf_counter() - t0
    batches = -(-n // DEFAULT_BATCH_ROWS)
    res["build"] = {
        "s": build_s, **t, "assign_launches": t["assign_steps"] * batches,
        "iterations": ivf.meta["iterations"], "imbalance": ivf.imbalance(),
        "empty_cells": ivf.meta["empty_cells"],
        "inertia": ivf.meta["inertia"],
    }
    print(f"ivf build at {n}x{d}, {IVF_CELLS} cells: {json.dumps(res['build'])}")
    model = KNNClassifier(k=k).fit(Dataset(xl_x, xl_y))
    idx_ivf = REPO / "build" / "chip_smoke" / "idx-xl-ivf"
    t0 = time.perf_counter()
    save_index(model, idx_ivf, ivf=ivf)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_index(idx_ivf)
    load_s = time.perf_counter() - t0
    for key, arr in ivf.to_arrays().items():
        if not np.array_equal(loaded.ivf_.to_arrays()[key], arr):
            fail(f"{key} differs after save and load")
    res["save_s"], res["load_s"] = save_s, load_s
    print(f"saved to {idx_ivf} in {save_s:.2f} s and loaded back in "
          f"{load_s:.2f} s: the partition's arrays equal")

    # 2a. The assignment on the card against its CPU version on a slice.
    sl = np.ascontiguousarray(xl_x[:DEFAULT_BATCH_ROWS])
    ga, gd = _assign_batched(sl, ivf.centroids, DEFAULT_BATCH_ROWS, dev)
    ca, cd = _assign_batched(sl, ivf.centroids, DEFAULT_BATCH_ROWS,
                             torch.device("cpu"))
    diff_rows = np.nonzero(ga != ca)[0]
    x64, c64 = sl.astype(np.float64), ivf.centroids.astype(np.float64)
    for r in diff_rows:
        dg = ((x64[r] - c64[ga[r]]) ** 2).sum()
        dc = ((x64[r] - c64[ca[r]]) ** 2).sum()
        scale = (x64[r] ** 2).sum() + (c64[ga[r]] ** 2).sum() + (
            c64[ca[r]] ** 2).sum()
        if abs(dg - dc) > 2.0 ** -20 * scale:
            fail(f"assignment row {r}: card cell {ga[r]}, cpu cell {ca[r]}, "
                 f"float64 distances {dg} and {dc} are no near tie")
    res["assign_parity"] = {"rows": len(sl), "differing_near_ties":
                            int(diff_rows.size),
                            "max_abs_min_d2": float(np.abs(gd - cd).max())}
    print(f"assignment on the card vs the CPU version, {len(sl)} rows: "
          f"{diff_rows.size} rows differ, each a near tie (tolerance "
          f"2^-20 (|x|^2 + |c|^2)); min_d2 max_abs_err "
          f"{res['assign_parity']['max_abs_min_d2']}")

    # 2b. Full probe, 64 queries, device scorer, against the stripe kernel
    # (counted around its call) and the oracle's einsum form.
    q64 = np.array(q_all[:64])
    fd, fi, fst = loaded.ivf_.search(xl_x, q64, k, IVF_CELLS,
                                     scorer="device", device=dev)
    scan.launches = merge.launches = 0
    sd, si = loaded.kneighbors(Dataset(q64, np.zeros(64, np.int32)))
    stripe_launches = {"scan": scan.launches, "merge": merge.launches}
    if stripe_launches != {"scan": 1, "merge": 1}:
        fail(f"the stripe kernel's kneighbors launched {stripe_launches}")
    full_diff = int((fi != si).any(axis=1).sum())
    if not _near_tie_ok(xl_x, q64, fi, si, d):
        fail("full-probe IVF differs from the stripe kernel beyond near ties")
    od, oi = oracle_kneighbors(xl_x, q64, k)
    if not (np.array_equal(fi, oi)
            and np.array_equal(fd.view(np.uint32), od.view(np.uint32))):
        fail("full-probe IVF is not bit-identical to the oracle")
    res["full_probe"] = {"queries": 64, "stats": fst._asdict(),
                         "rows_differing_from_stripe_near_ties": full_diff,
                         "stripe_launches": stripe_launches}
    print(f"full probe (nprobe {IVF_CELLS}, 64 queries, device scorer): "
          f"indices and distances bit-identical to the oracle; indices "
          f"equal to the stripe kernel's ({stripe_launches}) in "
          f"{64 - full_diff}/64 rows, the rest near ties (rtol d*2^-24)")

    # 2c. nprobe 32: the two scorers bit for bit.
    hd, hi, _ = loaded.ivf_.search(xl_x, q64, k, 32, scorer="host")
    dd, di, _ = loaded.ivf_.search(xl_x, q64, k, 32, scorer="device",
                                   device=dev)
    if not (np.array_equal(hi, di)
            and np.array_equal(hd.view(np.uint32), dd.view(np.uint32))):
        fail("host and device scorers differ at nprobe 32")
    print("nprobe 32, 64 queries: host and device scorers bit-identical")

    # 3. The sweep: recall@10 against the exact answer (the stripe kernel
    # on every query), q/s at 16-row dispatches beside the fast rung.
    ex_d, ex_i = loaded.kneighbors(Dataset(q_all, np.zeros(len(q_all),
                                                           np.int32)))
    ex_d64 = f64_dists(xl_x, q_all, ex_i)
    blocks = [np.array(q_all[s:s + 16]) for s in range(0, 512, 16)]

    def rate(fn, blks):
        fn(blks[0])
        t0 = time.perf_counter()
        for b in blks:
            fn(b)
        return 16 * len(blks) / (time.perf_counter() - t0)

    fast_qps = rate(lambda b: loaded.kneighbors(
        Dataset(b, np.zeros(16, np.int32))), blocks)
    res["sweep"] = {}
    for nprobe in IVF_SWEEP:
        sd_, si_, st = loaded.ivf_.search(xl_x, q_all, k, nprobe,
                                          scorer="device", device=dev)
        rec = recall_at_k(si_, ex_i, ex_d64, f64_dists(xl_x, q_all, si_))
        ent = {"recall_at_10": float(rec.mean()),
               "recall_min": float(rec.min()),
               "candidate_rows_per_query": st.candidate_rows / len(q_all),
               "forced_widenings": st.forced_widenings}
        for scorer in ("device", "host"):
            ent[f"qps_16_{scorer}"] = rate(
                lambda b, s=scorer: loaded.ivf_.search(
                    xl_x, b, k, nprobe, scorer=s, device=dev),
                blocks if scorer == "device" else blocks[:4])
        ent["fast_qps_16"] = fast_qps
        res["sweep"][nprobe] = ent
        print(f"nprobe {nprobe}: {json.dumps(ent)}")

    # The segment scorer at 16 rows and nprobe 32 against its bound, the
    # assignment step and the centroid ranking beside theirs.
    perm_rows, perm_ids = loaded.ivf_._device_operands(
        np.asarray(xl_x, np.float32), dev)
    seg_blocks = []
    for b in blocks[:12]:
        sel, counts = loaded.ivf_._coverage(b, k, 32, None, dev)[:2]
        m_pad = candidate_padded_rows(int(counts.max()))
        seg_blocks.append((
            torch.from_numpy(b).to(dev),
            torch.from_numpy(loaded.ivf_.cell_offsets[:-1][sel].astype(
                np.int32)).to(dev),
            torch.from_numpy(loaded.ivf_.cell_sizes[sel].astype(
                np.int32)).to(dev),
            int(counts.sum()), m_pad))
    kk = k + seg.RERANK_PAD
    ok16 = torch.ones(16, dtype=torch.bool, device=dev)
    seg_ms = cuda_ms(lambda qb, st_, ln, _c, mp: seg.segment_topk_core(
        perm_rows, perm_ids, qb, st_, ln, ok16, mp, kk), seg_blocks, reps=12)
    cand = statistics.median(b[3] for b in seg_blocks)
    seg_bound = bound_ms(int(cand * 3 * d), int(
        cand * (d * 4 + 4) + 16 * d * 4 + 16 * kk * 8))
    xb = [torch.from_numpy(np.ascontiguousarray(
        xl_x[i * DEFAULT_BATCH_ROWS:(i + 1) * DEFAULT_BATCH_ROWS])).to(dev)
        for i in range(4)]
    cents = torch.from_numpy(ivf.centroids).to(dev)
    asg_ms = cuda_ms(lambda xx: assign_batch(xx, cents), [(x_,) for x_ in xb],
                     reps=12)
    asg_lib = cuda_ms(lambda xx: torch.cdist(xx, cents).argmin(dim=1),
                      [(x_,) for x_ in xb], reps=12)
    asg_bound = bound_ms(DEFAULT_BATCH_ROWS * IVF_CELLS * d * 2, (
        DEFAULT_BATCH_ROWS * d + IVF_CELLS * d) * 4 + DEFAULT_BATCH_ROWS * 12,
        rate=PEAK_FP32_FLOPS)
    q16 = [torch.from_numpy(b).to(dev) for b in blocks[:12]]
    from knn_tpu_torch.ops.distance import pairwise_sq_dists_dot
    from knn_tpu_torch.ops.topk import topk_smallest

    rank_ms = cuda_ms(lambda qb: topk_smallest(
        pairwise_sq_dists_dot(qb, cents), 32), [(x_,) for x_ in q16], reps=12)
    rank_lib = cuda_ms(lambda qb: torch.topk(
        torch.cdist(qb, cents), 32, largest=False), [(x_,) for x_ in q16],
        reps=12)
    rank_bound = bound_ms(16 * IVF_CELLS * d * 2, (16 * d + IVF_CELLS * d) * 4
                          + 16 * 32 * 8, rate=PEAK_FP32_FLOPS)
    res["device_programs"] = {
        "segment_scorer": {"ms": seg_ms, "bound_ms": seg_bound[0],
                           "bound_by": seg_bound[1], "library_ms": None,
                           "shape": f"16 queries, nprobe 32, median "
                                    f"{cand:.0f} candidate rows over the "
                                    f"16, kk {kk}"},
        "kmeans_assign": {"ms": asg_ms, "bound_ms": asg_bound[0],
                          "bound_by": asg_bound[1], "library_ms": asg_lib,
                          "library": "torch.cdist(...).argmin",
                          "shape": f"{DEFAULT_BATCH_ROWS} rows x "
                                   f"{IVF_CELLS} cells"},
        "rank_cells": {"ms": rank_ms, "bound_ms": rank_bound[0],
                       "bound_by": rank_bound[1], "library_ms": rank_lib,
                       "library": "torch.topk(torch.cdist(...))",
                       "shape": f"16 queries x {IVF_CELLS} cells, need 32"},
    }
    print(f"device programs (CUDA events, median of 12): "
          f"{json.dumps(res['device_programs'])}")

    # 4. The auto rule's crossing: host and device scorers from one row at
    # one probe to 256 rows at 32 (host clock, the whole search).
    res["scorers"] = {}
    for rows, nprobe in IVF_SCORER_GRID:
        qb = np.array(q_all[:rows])
        counts = loaded.ivf_._coverage(qb, k, nprobe, None, dev)[1]
        ent = {"rows": rows, "nprobe": nprobe,
               "elems": rows * int(counts.max()) * d}
        for scorer in ("host", "device"):
            reps = 3 if scorer == "host" and rows > 16 else 7
            ent[f"{scorer}_ms"] = wall_ms(
                lambda s=scorer: loaded.ivf_.search(
                    xl_x, qb, k, nprobe, scorer=s, device=dev), reps)[0]
        res["scorers"][f"{rows}x{nprobe}"] = ent
    grid = sorted(res["scorers"].values(), key=lambda e: e["elems"])
    slower = [e["elems"] for e in grid if e["device_ms"] >= e["host_ms"]]
    # The smallest work past the last point where the host still won.
    res["crossing_elems"] = next(
        (e["elems"] for e in grid if not slower or e["elems"] > max(slower)),
        None)
    print(f"scorers (host-clock ms; median of 7, host past 16 rows of 3): "
          f"{json.dumps(grid)}; device faster from {res['crossing_elems']} "
          f"elements (DEVICE_SCORER_MIN_ELEMS "
          f"{ivf_mod.DEVICE_SCORER_MIN_ELEMS})")
    mem0 = torch.cuda.memory_allocated()
    del perm_rows, perm_ids
    loaded.ivf_._cache.pop("device", None)
    gc.collect()
    res["perm_train_bytes"] = mem0 - torch.cuda.memory_allocated()
    print(f"the permuted train copy on the card: {res['perm_train_bytes']} B")

    # 5. serve --ivf-probes 32 on the xl IVF artifact.
    obs.enable()
    obs.reset()
    buckets = tuple(sorted({b for b in DEFAULT_BATCH_BUCKETS if b < 256}
                           | {256}))
    app = ServeApp(load_index(idx_ivf), max_batch=256, max_wait_ms=2.0,
                   batch_buckets=buckets, cost_accounting=True,
                   index_version="xl-ivf", ivf_probes=IVF_SERVE_PROBES)
    warmed = app.warm()
    server = make_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    smodel = app.model
    sync_p = smodel.predict_from_candidates(
        *smodel.ivf_.search(xl_x, q_all, k, IVF_SERVE_PROBES,
                            scorer="host")[:2])
    registry = obs.registry()

    def ivf_counter(name):
        return sum(i.value for i in registry.instruments() if i.name == name)

    # The path's kernels: counts 0 just before, read just after.
    scan.launches = merge.launches = 0
    res["serve"] = {"warmed": warmed, "levels": {}}
    for kind, rows, clients, total in IVF_SERVE_LEVELS:
        name = f"{kind}_r{rows}_c{clients}"
        starts = [(j * rows) % (len(q_all) - rows) for j in range(total)]
        blocks_ = np.stack([q_all[s:s + rows] for s in starts])
        q0 = ivf_counter("knn_ivf_queries_total")
        b0 = _hist(registry, "knn_serve_batch_size")
        answers, lat, wall = _closed_loop(base, kind, blocks_, clients)
        b1 = _hist(registry, "knn_serve_batch_size")
        moved = ivf_counter("knn_ivf_queries_total") - q0
        if moved != total * rows:
            fail(f"{name}: knn_ivf_queries_total moved {moved}, not "
                 f"{total * rows}")
        for j, doc in answers.items():
            s = starts[j]
            if doc["predictions"] != sync_p[s:s + rows].tolist():
                fail(f"{name}: request {j} differs from the synchronous "
                     f"ivf answer")
        lat.sort()
        lv = {"requests": total, "clients": clients,
              "p50_ms": lat[len(lat) // 2],
              "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
              "qps": total / wall, "batches": b1[0] - b0[0],
              "knn_ivf_queries_moved": moved}
        res["serve"]["levels"][name] = lv
        print(f"serve --ivf-probes {IVF_SERVE_PROBES} {name}: "
              f"{json.dumps(lv)}")
    cl = _Client(base)
    _, _, body = cl.call("GET", "/healthz")
    cl.close()
    hz = json.loads(body)["ivf"]
    if hz is None or hz["nprobe"] != IVF_SERVE_PROBES or \
            hz["num_cells"] != IVF_CELLS:
        fail(f"/healthz ivf block: {hz}")
    res["serve"]["healthz_ivf"] = hz
    before = (scan.launches, merge.launches)
    with faults.inject("serve.dispatch=once") as plan:
        h = app.batcher.submit(q_all[:1], "predict")
        pred = h.result(timeout=60)
    moved = (scan.launches - before[0], merge.launches - before[1])
    fallbacks = [(dict(i.labels)["from_rung"], dict(i.labels)["to"], i.value)
                 for i in registry.instruments()
                 if i.name == "knn_serve_fallback_total"]
    exact_p = smodel.predict_from_candidates(ex_d[:1], ex_i[:1])
    if (plan.stats()["serve.dispatch"]["fired"] != 1
            or h.meta["rung"] != "fast" or moved != (1, 1)
            or fallbacks != [("ivf", "fast", 1)]
            or not np.array_equal(pred, exact_p)):
        fail(f"the injected ivf failure: rung {h.meta['rung']}, stripe "
             f"launches moved {moved}, moves {fallbacks}")
    launches = {"stripe_scan": scan.launches, "stripe_merge": merge.launches}
    server.shutdown()
    server.server_close()
    th.join(timeout=30)
    app.close()
    obs.disable()
    if min(launches.values()) < 1:
        fail(f"the path's kernels were not launched: {launches}")
    res["serve"]["fault"] = {"rung": "fast", "stripe_launches_moved": moved,
                             "fallbacks": fallbacks}
    res["serve"]["launches"] = launches
    print(f"one injected failure of the ivf rung: answered by 'fast', the "
          f"stripe scan and merge launched {moved} more, the answer equal "
          f"to the exact one; the path's kernel launches {launches}")
    print("ivf: " + json.dumps(res))
    return res


# The quality phase: the xl index under closed-loop single-row /predict with
# the answer-quality and capture layers off, then on at two shadow rates
# (drift at 1.0 and an armed capture window with each).
QUALITY_LEVELS = (("predict", 1, 1, 200), ("predict", 1, 8, 800))
QUALITY_CONFIGS = (("off", {}),
                   ("shadow_0.1", {"shadow_rate": 0.1, "drift_rate": 1.0}),
                   ("shadow_1.0", {"shadow_rate": 1.0, "drift_rate": 1.0}))
# The shadow and drift queues: a full queue sheds; at xl each shadow
# sample is a ~1 M-row host oracle, so a short queue bounds the drain.
QUALITY_QUEUE = 64
# The probe policy's loop: the large fixture's IVF at ~sqrt(N) cells.
QUALITY_IVF_CELLS = 176
QUALITY_IVF_K = 5
# Exact-rung rows checked against the host oracle: xl (its oracle is ~1 M
# rows a query) and every large test row.
QUALITY_XL_ROWS = 128


def _exact_divergences(model, x, queries, k, d) -> list:
    """Rows where the card's exact answer scores recall < 1 against the
    host oracle by the shadow scorer's rule, each with the ulp check that
    clears it: the float64 distances of the card's list and the oracle's
    agree within rtol = d * 2^-24 (a near tie the two sums order
    differently)."""
    from knn_tpu_torch.backends.oracle import oracle_kneighbors
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.obs.quality import recall_at_k, true_distances

    kd, ki = model.kneighbors(Dataset(queries,
                                      np.zeros(len(queries), np.int32)))
    od, oi = oracle_kneighbors(x, queries, k)
    r = recall_at_k(ki, oi, od, true_distances(x, queries, ki, "euclidean"))
    return [{"row": int(row), "recall": float(r[row]),
             "ulp_check": _near_tie_ok(x, queries[row:row + 1],
                                       ki[row:row + 1], oi[row:row + 1], d)}
            for row in np.nonzero(r < 1.0)[0]]


def phase_quality(torch, cuda_knn, train_path, test_path, xl_x, smi) -> dict:
    """Answer quality, drift, workload capture and replay on the card
    (ROADMAP A8b): the xl index served with the three layers off and on
    (launches per batch unchanged), corruption caught and attributed, the
    ivf probe policy's loop closed on the large fixture, and replays of a
    captured workload and of the committed fixture."""
    import tempfile
    import threading

    from knn_tpu_torch import obs
    from knn_tpu_torch.backends.oracle import oracle_kneighbors
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.index.ivf import IVFIndex
    from knn_tpu_torch.models.knn import DEFAULT_BATCH_BUCKETS, KNNClassifier
    from knn_tpu_torch.obs.quality import recall_at_k, true_distances
    from knn_tpu_torch.obs.replay import replay_workload
    from knn_tpu_torch.obs.slo import window_label
    from knn_tpu_torch.obs.workload import answer_digest, load_workload
    from knn_tpu_torch.serve import artifact
    from knn_tpu_torch.serve.batcher import MicroBatcher
    from knn_tpu_torch.serve.server import ServeApp

    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    res = {"smi": smi, "configs": {}}
    data_dir = REPO / "build" / "chip_smoke"
    idx_xl = data_dir / "idx-xl"  # written by the serve phase
    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    q_all = test.features
    buckets = tuple(sorted({b for b in DEFAULT_BATCH_BUCKETS if b < 256}
                           | {256}))
    manifest = artifact.read_manifest(idx_xl)
    version = artifact.index_version(manifest)
    capture_root = Path(tempfile.mkdtemp(prefix="capture-", dir=data_dir))

    def fail(msg):
        raise SystemExit(f"quality: {msg}")

    def quality_burn(app):
        label = window_label(min(app.slo.windows_s))
        return app.slo.burn_rates()["quality"][label]

    obs.enable()
    registry = obs.registry()
    sync_p = None
    captured = None
    # 1. The exact rung on xl with the layers off, then on.
    for name, layers in QUALITY_CONFIGS:
        obs.reset()
        model = artifact.load_index(idx_xl)
        kw = dict(layers)
        if layers:
            kw.update(quality_queue=QUALITY_QUEUE,
                      reference_sketch=artifact.reference_sketch(manifest),
                      capture_dir=str(capture_root / name))
        app = ServeApp(model, max_batch=256, max_wait_ms=2.0,
                       batch_buckets=buckets, cost_accounting=True,
                       index_version=version, **kw)
        app.warm()
        if sync_p is None:
            sync_p = model.predict_from_candidates(*model.kneighbors(test))
        server, th, base = _start_server(app)
        cl = _Client(base)
        if layers:
            st, _, body = cl.call("POST", "/admin/capture",
                                  {"action": "start", "reason": name})
            if st != 200:
                fail(f"{name}: POST /admin/capture start {st} {body!r}")
        cfg = {"levels": {}}
        for kind, rows, clients, total in QUALITY_LEVELS:
            level = f"{kind}_r{rows}_c{clients}"
            starts = [(j * rows) % (len(q_all) - rows) for j in range(total)]
            blocks = np.stack([q_all[s:s + rows] for s in starts])
            b0 = _hist(registry, "knn_serve_batch_size")
            scan.launches = merge.launches = 0
            answers, lat, wall = _closed_loop(base, kind, blocks, clients)
            launches = {"stripe_scan": scan.launches,
                        "stripe_merge": merge.launches}
            batches = _hist(registry, "knn_serve_batch_size")[0] - b0[0]
            if launches != {"stripe_scan": batches, "stripe_merge": batches}:
                fail(f"{name} {level}: {batches} batches but launches "
                     f"{launches}")
            for j, doc in answers.items():
                s = starts[j]
                if doc["predictions"] != sync_p[s:s + rows].tolist():
                    fail(f"{name} {level}: request {j} differs from the "
                         f"synchronous answer")
            lat.sort()
            cfg["levels"][level] = {
                "requests": total, "clients": clients,
                "p50_ms": lat[len(lat) // 2],
                "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
                "qps": total / wall, "batches": batches,
                "launches_per_batch": {k: v / batches
                                       for k, v in launches.items()},
            }
            print(f"quality {name} xl {level}: "
                  f"{json.dumps(cfg['levels'][level])}")
        if layers:
            if not (app.quality.drain(120) and app.drift.drain(60)):
                fail(f"{name}: the shadow or drift queue did not drain")
            block = app.quality_block()
            fast = block["shadow"]["rungs"].get("fast", {})
            cfg["shadow"] = {
                key: block["shadow"][key]
                for key in ("offered", "scored", "shed", "score_errors")}
            cfg["shadow"]["knn_quality_scored_total"] = sum(
                i.value for i in registry.instruments()
                if i.name == "knn_quality_scored_total")
            cfg["shadow"]["fast"] = fast
            cfg["quality_burn"] = quality_burn(app)
            cfg["drift"] = block["drift"]
            if block["shadow"]["score_errors"] or not fast.get("scored"):
                fail(f"{name}: shadow scoring {block['shadow']}")
            st, _, body = cl.call("POST", "/admin/capture",
                                  {"action": "stop"})
            if st != 200:
                fail(f"{name}: POST /admin/capture stop {st} {body!r}")
            cap = json.loads(body)
            wl = load_workload(cap["path"])
            cfg["capture"] = {key: cap[key] for key in (
                "requests", "total_rows", "shed", "duration_ms")}
            cfg["capture"]["digests"] = sum(
                1 for e in wl.read_events if e.get("digest"))
            print(f"quality {name}: shadow {json.dumps(cfg['shadow'])}; "
                  f"quality burn {cfg['quality_burn']}; drift of the large "
                  f"test rows against the xl train's sketch "
                  f"{json.dumps(cfg['drift'])}; capture "
                  f"{json.dumps(cfg['capture'])}")
        if name == "shadow_1.0":
            # 2. Corruption: every served neighbor off by one train row.
            before = dict(fast.get("divergence", {}))
            burn0 = cfg["quality_burn"]
            app.batcher.corrupt_serving = True
            for j in range(16):
                app.batcher.submit(q_all[j:j + 1], "predict").result(
                    timeout=60)
            app.batcher.corrupt_serving = False
            if not app.quality.drain(120):
                fail("corruption: the shadow queue did not drain")
            after = app.quality_block()["shadow"]["rungs"]["fast"]
            burn1 = quality_burn(app)
            moved = (after["divergence"].get("neighbors", 0)
                     - before.get("neighbors", 0))
            if moved < 1 or burn1 <= 1.0 or burn1 <= burn0:
                fail(f"corruption not caught: neighbors +{moved}, quality "
                     f"burn {burn0} -> {burn1}")
            res["corruption"] = {"requests": 16, "fast_neighbors_moved": moved,
                                 "quality_burn_before": burn0,
                                 "quality_burn_after": burn1}
            print(f"corruption: 16 single-row requests with the indices "
                  f"rotated; 'fast' neighbors divergence +{moved}, quality "
                  f"burn {burn0} -> {burn1}")
            captured = (load_workload(cap["path"]), model)
        cl.close()
        _stop_server(server, th, app)
        res["configs"][name] = cfg

    # The exact rung's honest divergences against the host oracle.
    xl_rows = _exact_divergences(captured[1], xl_x, q_all[:QUALITY_XL_ROWS],
                                 10, xl_x.shape[1])
    large_model = KNNClassifier(k=QUALITY_IVF_K).fit(train)
    large_rows = _exact_divergences(large_model, train.features, q_all,
                                    QUALITY_IVF_K, train.num_features)
    res["exact_divergences"] = {
        "xl": {"rows_checked": QUALITY_XL_ROWS, "rows": xl_rows},
        "large": {"rows_checked": len(q_all), "rows": large_rows}}
    if not all(r["ulp_check"] for r in xl_rows + large_rows):
        fail(f"an exact-rung divergence is no near tie: "
             f"{res['exact_divergences']}")
    print(f"exact rung against the host oracle (the shadow scorer's rule): "
          f"{json.dumps(res['exact_divergences'])}")

    # 3. The probe policy's loop on the large fixture's IVF.
    obs.reset()
    t0 = time.perf_counter()
    ivf = IVFIndex.build(train.features, QUALITY_IVF_CELLS, seed=0,
                         device=torch.device("cuda"))
    build_s = time.perf_counter() - t0
    idx_ivf = data_dir / "idx-large-ivf"
    artifact.save_index(large_model, idx_ivf, ivf=ivf)
    app = ServeApp(artifact.load_index(idx_ivf), max_batch=256,
                   max_wait_ms=2.0, batch_buckets=buckets, ivf_probes=1,
                   shadow_rate=1.0, quality_queue=QUALITY_QUEUE,
                   index_version="large-ivf")
    app.warm()
    policy = app.ivf.policy
    trace = []
    halt = threading.Event()

    def poll():
        while not halt.is_set():
            queries = sum(i.value for i in registry.instruments()
                          if i.name == "knn_ivf_queries_total")
            trace.append((time.perf_counter(), queries, policy.export()))
            time.sleep(0.005)

    poller = threading.Thread(target=poll, daemon=True)
    server, th, base = _start_server(app)
    poller.start()
    blocks = np.stack([q_all[j % len(q_all)][None] for j in range(3000)])
    _closed_loop(base, "predict", blocks, 4)
    halt.set()
    poller.join(timeout=10)
    if not app.quality.drain(120):
        fail("ivf: the shadow queue did not drain")
    first = next((t for t, q, _ in trace if q > 0), None)
    widen = next((t for t, _, p in trace if p["moves"]["widen"]), None)
    nprobe_final = policy.current()
    if first is None or widen is None or nprobe_final <= 1:
        fail(f"ivf: the policy did not widen nprobe: {policy.export()}")
    steps = sorted({p["nprobe"] for _, _, p in trace})
    ivf_stats = app.quality_block()["shadow"]["rungs"]["ivf"]
    _stop_server(server, th, app)
    loaded = artifact.load_index(idx_ivf)
    sample = q_all[:256]
    od, oi = oracle_kneighbors(train.features, sample, QUALITY_IVF_K)
    recall = {}
    for nprobe in (1, nprobe_final):
        _, ii, _ = loaded.ivf_.search(train.features, sample, QUALITY_IVF_K,
                                      nprobe)
        recall[nprobe] = float(recall_at_k(ii, oi, od, true_distances(
            train.features, sample, ii, "euclidean")).mean())
    res["ivf_loop"] = {
        "cells": QUALITY_IVF_CELLS, "build_s": build_s,
        "nprobe_before": 1, "nprobe_after": nprobe_final,
        "nprobe_steps": steps, "moves": policy.moves,
        "first_widen_ms": (widen - first) * 1e3,
        "recall_at_k": recall, "shadow_ivf": ivf_stats,
    }
    print(f"ivf loop, large fixture, {QUALITY_IVF_CELLS} cells, k "
          f"{QUALITY_IVF_K}, --ivf-probes 1, shadow rate 1.0: "
          f"{json.dumps(res['ivf_loop'])}")

    # 4. Replay: the window captured with every layer on, twice, in
    # process on the card; then the committed fixture through the CLI.
    wl, model = captured
    res["replay"] = []
    for _ in range(2):
        batcher = MicroBatcher(model, max_batch=256, max_wait_ms=2.0,
                               index_version=version, buckets=buckets)
        scan.launches = merge.launches = 0
        try:
            v = replay_workload(wl, batcher=batcher, speed=1.0, verify="tag")
        finally:
            batcher.close()
        m, ver = v["measured"], v["verify"]
        if (m["errors"] or ver["divergences"] or ver["skipped_tag_mismatch"]
                or ver["verified"] != wl.manifest["requests"]
                or min(scan.launches, merge.launches) < 1):
            fail(f"replay of the captured window: {json.dumps(v)[:2000]}")
        res["replay"].append({**m, "verified": ver["verified"],
                              "launches": {"stripe_scan": scan.launches,
                                           "stripe_merge": merge.launches}})
        print(f"replay of the captured xl window in process: "
              f"{json.dumps(res['replay'][-1])}")
    rng = np.random.default_rng(1234)  # tests/fixtures.py:78
    fx = rng.normal(0.0, 2.0, (512, 8)).astype(np.float32)
    fy = rng.integers(0, 6, 512).astype(np.int32)
    idx_fx = data_dir / "idx-replay-fixture"
    artifact.save_index(KNNClassifier(k=3).fit(Dataset(fx, fy)), idx_fx)
    verdict_path = data_dir / "replay-fixture-verdict.json"
    out = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch", "replay",
         str(REPO / "tests" / "data" / "replay-workload"), "--index",
         str(idx_fx), "--verify", "always", "--verdict-out",
         str(verdict_path)], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    if out.returncode != 0:
        fail(f"replay CLI exited {out.returncode}: {out.stderr[-2000:]}")
    verdict = json.loads(verdict_path.read_text())
    m, ver = verdict["measured"], verdict["verify"]
    if m["ok"] != 120 or m["errors"]:
        fail(f"fixture replay: {json.dumps(verdict)[:2000]}")
    fwl = load_workload(REPO / "tests" / "data" / "replay-workload")
    fmodel = artifact.load_index(idx_fx)
    mismatched = {"predict": 0, "kneighbors": 0}
    for ev in fwl.read_events:
        q = fwl.rows_for(ev)
        ds = Dataset(q, np.zeros(len(q), np.int32))
        if ev["kind"] == "predict":
            if answer_digest("predict", fmodel.predict(ds)) != ev["digest"]:
                mismatched["predict"] += 1
            continue
        kd, ki = fmodel.kneighbors(ds)
        if answer_digest("kneighbors", (kd, ki)) == ev["digest"]:
            continue
        mismatched["kneighbors"] += 1
        od, oi = oracle_kneighbors(fx, q, 3)
        if not (np.array_equal(ki, oi) and np.allclose(
                kd, od, rtol=8 * 2.0 ** -24, atol=0)):
            fail(f"fixture event {ev['id']}: the card's neighbors differ "
                 f"from the oracle's beyond the ulp rule")
    if mismatched["predict"] or ver["divergences"] != mismatched["kneighbors"]:
        fail(f"fixture replay digests: {mismatched}, verdict {ver}")
    res["fixture_replay"] = {
        key: m[key] for key in ("requests", "ok", "errors", "p50_ms",
                                "p99_ms", "qps", "late_fires")}
    res["fixture_replay"].update(
        verified=ver["verified"], divergences=ver["divergences"],
        kneighbors_digests_differing=mismatched["kneighbors"],
        captured=verdict["captured"])
    print(f"replay tests/data/replay-workload through the CLI on the card: "
          f"{json.dumps(res['fixture_replay'])} (each differing kneighbors "
          f"digest: indices equal to the host oracle's, distances within "
          f"rtol 8 * 2^-24)")
    obs.disable()
    print("quality: " + json.dumps(res))
    return res


MUTABLE_CAP = 4096       # serve --delta-cap
MUTABLE_THRESHOLD = 16384  # --compact-threshold: only step 5's call folds
MUTABLE_INSERTS = 1024   # step 2's inserted rows, in bodies of 64
MUTABLE_BODY = 64
MUTABLE_BASE_DELETES = 256
MUTABLE_DELTA_DELETES = 64
MUTABLE_HELD = 256       # queries held to the merged oracle
MUTABLE_LEVELS = (("predict", 1, 1, 200), ("predict", 1, 8, 800))


def _view_near_tie_ok(x, view, queries, ki, oi, d: int) -> bool:
    """:func:`_near_tie_ok` in a mutable view's id space (base rows and
    delta slots)."""
    from knn_tpu_torch.mutable.state import lookup_rows

    for r in np.nonzero((np.asarray(ki) != np.asarray(oi)).any(axis=1))[0]:
        q = queries[r].astype(np.float64)
        dk = ((lookup_rows(view, x, ki[r]).astype(np.float64) - q) ** 2
              ).sum(axis=1)
        do = ((lookup_rows(view, x, oi[r]).astype(np.float64) - q) ** 2
              ).sum(axis=1)
        if not np.allclose(np.sort(dk), np.sort(do), rtol=d * 2.0 ** -24,
                           atol=0):
            return False
    return True


def _stable_ids(eng, view, idx):
    """Positional ids of ``view`` (base rows, then delta slots) as the
    stable ids that survive a compaction."""
    idx = np.asarray(idx, np.int64)
    base = eng._base_stable[np.minimum(idx, view.base_n - 1)]
    if view.count == 0:
        return base
    delta = view.stable[np.clip(idx - view.base_n, 0, view.count - 1)]
    return np.where(idx >= view.base_n, delta, base)


def phase_mutable(torch, cuda_knn, tile_knn, xl_x, xl_y, q_all, train,
                  smi, dev=None) -> dict:
    """The mutable tier on the card (ROADMAP A10/B4), after ``ivf``: xl
    (k = 10) under ``serve --mutable on`` — the empty view against
    ``--mutable off``, inserts and deletes read back at their sequence
    points, 256 queries held to the merged oracle, shadow scoring, the
    rate with the delta empty, after the writes and full; the delta tail on
    the card (the torch-scan route on the large fixture, the fused segment
    scorer on the ivf phase's xl partition), B4's programs timed;
    compaction of both, a rolled-back compaction and a restart over a torn
    epoch record. ``dev`` (default the card) is where every model of the
    phase runs."""
    import contextlib
    import shutil

    from knn_tpu_torch import obs
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.models.knn import (
        DEFAULT_BATCH_BUCKETS,
        KNNClassifier,
        candidate_padded_rows,
    )
    from knn_tpu_torch.mutable import device_tail as dtail
    from knn_tpu_torch.mutable.engine import MutableEngine
    from knn_tpu_torch.mutable.state import (
        merged_oracle_kneighbors,
        view_true_distances,
    )
    from knn_tpu_torch.obs.quality import recall_at_k
    from knn_tpu_torch.ops import segment_score as seg
    from knn_tpu_torch.resilience import faults
    from knn_tpu_torch.serve import artifact
    from knn_tpu_torch.serve.batcher import MicroBatcher
    from knn_tpu_torch.serve.server import ServeApp

    t_phase = time.perf_counter()
    dev = dev if dev is not None else torch.device("cuda")
    data_dir = REPO / "build" / "chip_smoke"
    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    tile_scan = tile_knn.knn_tile_scan
    n, d = xl_x.shape
    k = 10
    ncls = int(xl_y.max()) + 1
    buckets = tuple(sorted({b for b in DEFAULT_BATCH_BUCKETS if b < 256}
                           | {256}))
    res = {"shape": f"n={n} d={d} k={k} delta_cap={MUTABLE_CAP}",
           "smi": smi}

    def fail(msg):
        raise SystemExit(f"mutable: {msg}")

    def reset_counts():
        scan.launches = merge.launches = 0
        for form in tile_scan.launches:
            tile_scan.launches[form] = 0

    def counts():
        return {"stripe_scan": scan.launches, "stripe_merge": merge.launches,
                "tile_scan": sum(tile_scan.launches.values())}

    def fresh(src, name):
        dst = data_dir / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
        return dst

    def boot(idx, mutable=False, **kw):
        base_dir, cur = (artifact.resolve_mutable_base(idx) if mutable
                         else (idx, None))
        app = ServeApp(
            artifact.load_index(base_dir, device=dev.type), max_batch=256,
            max_wait_ms=2.0,
            batch_buckets=buckets, index_path=str(idx),
            index_version=artifact.index_version(
                artifact.read_manifest(base_dir)),
            mutable=mutable, delta_cap=MUTABLE_CAP,
            compact_threshold=MUTABLE_THRESHOLD, compact_interval_s=0.0,
            mutable_current=cur,
            mutable_base_dir=base_dir if mutable else None, **kw)
        app.warm()
        return (app, *_start_server(app))

    def post(client, path, payload):
        st, _, body = client.call("POST", path, payload)
        return st, json.loads(body)

    def level(base, name, kind, blocks, clients):
        """One closed-loop level: answers, p50/p99/q/s, launches per batch
        and the dispatch's breakdown (the host merge's share)."""
        registry = obs.registry()
        n_spans = len(obs.tracer().spans())
        b0 = _hist(registry, "knn_serve_batch_size")[0]
        reset_counts()
        answers, lat, wall = _closed_loop(base, kind, blocks, clients)
        got = counts()
        batches = _hist(registry, "knn_serve_batch_size")[0] - b0
        if got["stripe_scan"] < batches or got["stripe_merge"] < batches:
            fail(f"{name}: {batches} batches but launches {got}")
        lat.sort()
        br = _dispatch_breakdown(obs.tracer().spans()[n_spans:])
        lv = {
            "requests": len(blocks), "clients": clients,
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "qps": len(blocks) / wall, "batches": batches,
            "launches_per_batch": {key: v / batches
                                   for key, v in got.items()},
            "dispatch_breakdown_ms": br,
            "host_merge_share": (br.get("mutable.merge", 0.0)
                                 / br["serve.dispatch"]
                                 if br.get("serve.dispatch") else None),
        }
        print(f"mutable {name}: {json.dumps(lv)}")
        return answers, lv

    obs.enable()
    obs.reset()
    dtail._append_core.launches = seg.delta_columns.launches = 0
    rng = np.random.default_rng(12)
    singles = q_all[np.arange(200) % len(q_all)][:, None, :]
    eights = q_all[np.arange(800) % len(q_all)][:, None, :]
    kn_blocks = np.ascontiguousarray(q_all[200:264]).reshape(16, 4, d)
    held = np.ascontiguousarray(q_all[1024:1024 + MUTABLE_HELD])

    # 1. The empty view: --mutable on against --mutable off.
    idx_off = data_dir / "idx-xl"
    off = boot(idx_off)
    want_p, lv_off1 = level(off[3], "off_c1", "predict", singles, 1)
    _, lv_off8 = level(off[3], "off_c8", "predict", eights, 8)
    want_k, _, _ = _closed_loop(off[3], "kneighbors", kn_blocks, 4)
    _stop_server(off[1], off[2], off[0])
    idx_mut = fresh(idx_off, "mut-xl")
    app, server, th, base = boot(idx_mut, mutable=True, shadow_rate=1.0,
                                 quality_queue=256)
    scorer, app.batcher.quality = app.batcher.quality, None
    got_p, lv_e1 = level(base, "empty_c1", "predict", singles, 1)
    _, lv_e8 = level(base, "empty_c8", "predict", eights, 8)
    got_k, _, _ = _closed_loop(base, "kneighbors", kn_blocks, 4)
    for want, got, fields in ((want_p, got_p, ("predictions",)),
                              (want_k, got_k, ("distances", "indices"))):
        for j, doc in want.items():
            for f in fields:
                if json.dumps(doc[f]) != json.dumps(got[j][f]):
                    fail(f"empty view: request {j} {f} differ from "
                         f"--mutable off")
            if got[j].get("mutation_seq") != 0:
                fail(f"empty view: mutation_seq {got[j].get('mutation_seq')}")
    for lv in (lv_e1, lv_e8):
        if (lv["launches_per_batch"]["stripe_scan"] != 1
                or lv["launches_per_batch"]["stripe_merge"] != 1
                or lv["launches_per_batch"]["tile_scan"] != 0):
            fail(f"empty view: launches per batch {lv['launches_per_batch']}")
    res["empty_view"] = {"byte_equal": True, "requests": 200 + 16,
                         "launches_per_batch": lv_e1["launches_per_batch"]}
    res["rate"] = {"off": {"c1": lv_off1, "c8": lv_off8},
                   "empty": {"c1": lv_e1, "c8": lv_e8}}
    print("empty view: 200 /predict and 16 /kneighbors answers byte-equal "
          "to --mutable off, 1 stripe scan and 1 merge per batch")

    # 2. Writes, each read back at its sequence point, shadow scored.
    app.batcher.quality = scorer
    client = _Client(base)
    ins = (q_all[np.arange(MUTABLE_INSERTS) % len(q_all)]
           + rng.normal(0, 1e-3, (MUTABLE_INSERTS, d))).astype(np.float32)
    ins_y = rng.integers(0, ncls, MUTABLE_INSERTS)
    t0 = time.perf_counter()
    acks = []
    for j in range(0, MUTABLE_INSERTS, MUTABLE_BODY):
        rows = ins[j:j + MUTABLE_BODY]
        st, ack = post(client, "/insert", {
            "rows": rows.tolist(),
            "labels": ins_y[j:j + MUTABLE_BODY].tolist()})
        if st != 200 or ack["ids"] != list(range(n + j, n + j + len(rows))):
            fail(f"insert at slot {j}: {st} {ack}")
        st, doc = post(client, "/kneighbors",
                       {"instances": rows[:1].tolist()})
        if (st != 200 or doc["mutation_seq"] < ack["seq"]
                or doc["indices"][0][0] != n + j
                or doc["distances"][0][0] != 0.0):
            fail(f"read after insert seq {ack['seq']}: {doc}")
        acks.append(ack["seq"])
    _, hb_i = app.model.kneighbors(Dataset(held, np.zeros(len(held),
                                                          np.int32)))
    victims, owner = [], []
    for col in range(k):
        for r in range(len(held)):
            v = int(hb_i[r, col])
            if len(victims) < MUTABLE_BASE_DELETES and v not in victims:
                victims.append(v)
                owner.append(r)
    for j in range(0, MUTABLE_BASE_DELETES, MUTABLE_BODY):
        ids = victims[j:j + MUTABLE_BODY]
        st, ack = post(client, "/delete", {"ids": ids})
        if st != 200:
            fail(f"delete of base rows: {st} {ack}")
        st, doc = post(client, "/kneighbors",
                       {"instances": held[owner[j]:owner[j] + 1].tolist()})
        if (st != 200 or doc["mutation_seq"] < ack["seq"]
                or set(doc["indices"][0]) & set(ids)):
            fail(f"read after delete seq {ack['seq']}: {doc}")
        acks.append(ack["seq"])
    dead_delta = [n + 16 * j for j in range(MUTABLE_DELTA_DELETES)]
    st, ack = post(client, "/delete", {"ids": dead_delta})
    st2, doc = post(client, "/kneighbors", {"instances": ins[:1].tolist()})
    if (st != 200 or st2 != 200 or doc["mutation_seq"] < ack["seq"]
            or n in doc["indices"][0]):
        fail(f"delete of delta rows / read: {st} {ack} {doc}")
    acks.append(ack["seq"])
    writes_s = time.perf_counter() - t0
    # The 256 held queries against the merged oracle.
    answers, _, _ = _closed_loop(base, "kneighbors",
                                 held.reshape(16, 16, d), 4)
    kd = np.concatenate([np.asarray(answers[j]["distances"], np.float32)
                         for j in range(16)])
    ki = np.concatenate([np.asarray(answers[j]["indices"], np.int64)
                         for j in range(16)])
    view = app.mutable.snapshot()
    if {answers[j]["mutation_seq"] for j in range(16)} != {view.seq}:
        fail("the held reads are not at the last write's sequence point")
    t0 = time.perf_counter()
    od, oi = merged_oracle_kneighbors(app.model, view, held)
    oracle_s = time.perf_counter() - t0
    differ = int((ki != oi).any(axis=1).sum())
    if not _view_near_tie_ok(xl_x, view, held, ki, oi, d):
        fail("held queries differ from the merged oracle beyond near ties")
    if not np.allclose(kd, od, rtol=d * 2.0 ** -24, atol=0):
        fail("held distances differ from the merged oracle's beyond "
             "rtol = d * 2^-24")
    if np.isin(ki, victims + dead_delta).any():
        fail("a deleted row was served")
    recall = recall_at_k(ki, oi, od.astype(np.float64), view_true_distances(
        app.model, view, held, ki, "euclidean"))
    if not scorer.drain(300):
        fail("the shadow scorer did not drain")
    app.batcher.quality = None
    sq = scorer.export()["rungs"].get("fast", {})
    div = sq.get("divergence", {})
    near_ties = int((recall < 1.0).sum())
    if (div.get("distance", 0) or div.get("neighbors", 0) > near_ties
            or div.get("vote", 0) > near_ties):
        fail(f"shadow divergences beyond the {near_ties} near ties: {div}")
    res["writes"] = {
        "acks": len(acks), "seqs": [acks[0], acks[-1]], "wall_s": writes_s,
        "live_delta": view.live_delta, "base_tombstones":
        int(view.tomb_base.size), "held": MUTABLE_HELD,
        "held_rows_differing_near_ties": differ,
        "held_recall_lt1_near_ties": near_ties,
        "merged_oracle_s": oracle_s,
        "shadow": {"scored": sq.get("scored"), "recall": sq.get("recall"),
                   "divergence": div, "shed": scorer.shed},
    }
    print(f"writes: {json.dumps(res['writes'])}")

    # 3. The rate after the writes, then with the delta full.
    _, lv_w1 = level(base, "writes_c1", "predict", singles, 1)
    _, lv_w8 = level(base, "writes_c8", "predict", eights, 8)
    fill = MUTABLE_CAP - view.count
    more = (q_all[(MUTABLE_INSERTS + np.arange(fill)) % len(q_all)]
            + rng.normal(0, 1e-3, (fill, d))).astype(np.float32)
    for j in range(0, fill, MUTABLE_BODY):
        st, ack = post(client, "/insert", {
            "rows": more[j:j + MUTABLE_BODY].tolist(),
            "labels": [0] * len(more[j:j + MUTABLE_BODY])})
        if st != 200:
            fail(f"filling the delta: {st} {ack}")
    _, lv_f1 = level(base, "full_c1", "predict", singles, 1)
    _, lv_f8 = level(base, "full_c8", "predict", eights, 8)
    st, body = post(client, "/insert", {"rows": more[:1].tolist(),
                                        "labels": [0]})
    if st != 429 or "delta tier full" not in body["error"]:
        fail(f"the insert past delta_cap answered {st}: {body}")
    res["rate"].update(writes={"c1": lv_w1, "c8": lv_w8},
                       full={"c1": lv_f1, "c8": lv_f8})
    res["full_insert_status"] = st

    # 4a. The delta tail on the card: the torch-scan route (large, k = 5).
    large = KNNClassifier(k=5, engine="xla", device=dev.type).fit(
        Dataset(train.features, train.labels))
    on_dir = data_dir / "mut-large-on"
    shutil.rmtree(on_dir, ignore_errors=True)
    artifact.save_index(large, on_dir)
    off_dir = fresh(on_dir, "mut-large-off")
    e_on = MutableEngine(large, on_dir, delta_cap=MUTABLE_CAP,
                         device_tail="on")
    e_off = MutableEngine(large, off_dir, delta_cap=MUTABLE_CAP,
                          device_tail="off")
    nl = train.num_instances
    for e in (e_on, e_off):
        e.apply_insert(ins, ins_y, 0)
        e.apply_delete([nl + 3 * j for j in range(32)], 0)
    with MicroBatcher(large, max_batch=256, max_wait_ms=0.0,
                      mutable=e_on) as b_on, \
            MicroBatcher(large, max_batch=256, max_wait_ms=0.0,
                         mutable=e_off) as b_off:
        reset_counts()
        m0 = dtail._delta_merge_core.launches
        gd, gi = b_on.kneighbors(q_all, timeout=120)
        gp = b_on.predict(q_all, timeout=120)
        tail_launches = dtail._delta_merge_core.launches - m0
        hand = counts()
        wd, wi = b_off.kneighbors(q_all, timeout=120)
        wp = b_off.predict(q_all, timeout=120)
    e_on.close()
    e_off.close()
    if any(hand.values()) or tail_launches < 2:
        fail(f"device tail: hand kernels {hand}, merges {tail_launches}")
    if not (np.array_equal(gi, wi)
            and np.array_equal(gd.view(np.uint32), wd.view(np.uint32))
            and np.array_equal(gp, wp)):
        fail("the device tail's merge differs from the host merge")
    res["device_tail"] = {"queries": len(q_all), "delta_slots": len(ins),
                          "merge_launches": tail_launches,
                          "hand_kernel_launches": hand, "bit_equal": True}
    print(f"device tail (large, k=5, engine xla): {len(q_all)} queries "
          f"bit-equal to the host merge, {tail_launches} merges, hand "
          f"kernels {hand}")

    # 4b. The fused delta segment scorer on the ivf phase's xl partition.
    os.environ["KNN_TPU_DEVICE_TAIL"] = "on"
    try:
        iv = boot(fresh(data_dir / "idx-xl-ivf", "mut-xl-ivf"),
                  mutable=True, ivf_probes=IVF_SERVE_PROBES)
    finally:
        os.environ.pop("KNN_TPU_DEVICE_TAIL", None)
    iapp = iv[0]
    for j in range(0, MUTABLE_INSERTS, MUTABLE_BODY):
        iapp.batcher.submit_mutation("insert", {
            "rows": ins[j:j + MUTABLE_BODY],
            "values": ins_y[j:j + MUTABLE_BODY]}).result(timeout=60)
    # One 64-row request: one batch, so the probe widening (batch-wide)
    # is the host path's below.
    q64 = np.ascontiguousarray(q_all[:64])
    s0 = seg.segment_topk_delta_core.launches
    h = iapp.batcher.submit(q64, "kneighbors")
    fd, fi = h.result(timeout=60)
    fused_launches = seg.segment_topk_delta_core.launches - s0
    if fused_launches < 1 or h.meta["rung"] != "ivf":
        fail(f"ivf: {fused_launches} fused scorer launches, rung "
             f"{h.meta['rung']}")
    iview = iapp.mutable.snapshot()
    index, ix = iapp.model.ivf_, iapp.model.train_.features
    hd, hi, _ = index.search_merged(ix, q64, k, IVF_SERVE_PROBES,
                                    iview._replace(device=None),
                                    device=dev.type)
    if not (np.array_equal(fi, hi)
            and np.array_equal(fd.view(np.uint32), hd.view(np.uint32))):
        fail("the fused delta scorer differs from the host merge")
    md, mi = merged_oracle_kneighbors(iapp.model, iview, q64)
    ivf_recall = float(recall_at_k(
        fi, mi, md.astype(np.float64),
        view_true_distances(iapp.model, iview, q64, fi, "euclidean")).mean())
    res["ivf_fused"] = {"queries": 64, "nprobe": IVF_SERVE_PROBES,
                        "delta_slots": iview.count,
                        "fused_launches": fused_launches,
                        "equal_to_host_merge": True,
                        "recall_at_10": ivf_recall}
    print(f"ivf fused: {json.dumps(res['ivf_fused'])}")

    # 4c. B4's programs, CUDA events, at the serving shapes; the launches
    # are those of steps 2-4b (the xl engine's appends from its 256th
    # delta row on; the merges of 4a and 4b, each scoring the delta once).
    append_launches = dtail._append_core.launches
    cols_launches = seg.delta_columns.launches
    tview = app.mutable.snapshot().device
    if tview is None or tview.features.device.type != dev.type:
        fail(f"the xl engine's delta tail is not on {dev}")
    qb = [torch.from_numpy(np.ascontiguousarray(
        q_all[256 * i % 1024:256 * i % 1024 + 256])).to(dev)
        for i in range(4)]
    bd = torch.rand((256, k), device=dev) * 10
    bi = torch.randint(0, n, (256, k), dtype=torch.int32, device=dev)
    kk = min(k + seg.RERANK_PAD, k + tview.features.shape[0])
    args = [(bd, bi, q, tview.features, tview.dead, tview.base_n,
             tview.count, kk) for q in qb]
    merge_ms = cuda_ms(dtail._delta_merge_core, args, reps=12)
    cap = tview.features.shape[0]
    merge_bound = bound_ms(256 * cap * 3 * d,
                           cap * (d * 4 + 1) + 256 * (k * 8 + d * 4
                                                      + kk * 8))
    lib_ms = cuda_ms(lambda q: torch.topk(
        torch.cdist(q, tview.features[:tview.count]), kk, dim=1,
        largest=False), [(q,) for q in qb], reps=12)
    cols_ms = cuda_ms(seg.delta_columns, [
        (q, tview.features, tview.dead, tview.base_n, tview.count)
        for q in qb], reps=12)
    cols_bound = bound_ms(256 * cap * 3 * d,
                          cap * (d * 4 + 1) + 256 * d * 4 + 256 * cap * 8)
    rows64 = tview.features[-64:].flip(0).contiguous()
    append_ms = cuda_ms(dtail._append_core,
                        [(tview.features, rows64, cap - 64)], reps=12)
    append_lib_ms = cuda_ms(
        lambda b, r, at: b.index_copy(0, torch.arange(
            at, at + r.shape[0], device=b.device), r),
        [(tview.features, rows64, cap - 64)], reps=12)
    append_bound = bound_ms(0, 2 * cap * d * 4 + 64 * d * 4)
    itail = iview.device
    perm_rows, perm_ids = index._device_operands(ix, dev)
    sel, counts_c, *_ = index._coverage(q64[:16], k, IVF_SERVE_PROBES, None,
                                        dev)
    starts = torch.from_numpy(
        index.cell_offsets[:-1][sel].astype(np.int32)).to(dev)
    lens = torch.from_numpy(index.cell_sizes[sel].astype(np.int32)).to(dev)
    m_pad = candidate_padded_rows(int(counts_c.max()))
    kk2 = min(k + seg.RERANK_PAD, m_pad + itail.features.shape[0])
    q16 = torch.from_numpy(q64[:16].copy()).to(dev)
    seg_ms = cuda_ms(seg.segment_topk_delta_core, [
        (perm_rows, perm_ids, q16, starts, lens, None, itail.features,
         itail.dead, itail.base_n, itail.count, m_pad, kk2)], reps=12)
    icap = itail.features.shape[0]
    cand = int(counts_c.sum())
    seg_bound = bound_ms(16 * (m_pad + icap) * 3 * d,
                         cand * (d * 4 + 4) + icap * (d * 4 + 1)
                         + 16 * (d * 4 + kk2 * 8))
    res["b4"] = {
        "append_core": {
            "ms": append_ms, "bound_ms": append_bound[0],
            "bound_by": append_bound[1], "library_ms": append_lib_ms,
            "launches": append_launches,
            "shape": f"cap={cap} d={d}, 64 rows at slot {cap - 64}"},
        "delta_columns": {
            "ms": cols_ms, "bound_ms": cols_bound[0],
            "bound_by": cols_bound[1], "library_ms": None,
            "launches": cols_launches,
            "shape": f"B=256 cap={cap} count={tview.count} d={d}"},
        "delta_merge_core": {
            "ms": merge_ms, "bound_ms": merge_bound[0],
            "bound_by": merge_bound[1], "library_ms": None,
            "cdist_topk_ms": lib_ms, "launches": tail_launches,
            "shape": f"B=256 k={k} cap={cap} count={tview.count} d={d}"},
        "segment_topk_delta_core": {
            "ms": seg_ms, "bound_ms": seg_bound[0],
            "bound_by": seg_bound[1], "library_ms": None,
            "launches": fused_launches,
            "shape": f"B=16 nprobe={IVF_SERVE_PROBES} m_pad={m_pad} "
                     f"cap={icap} count={itail.count} d={d}"},
    }
    print(f"B4 programs: {json.dumps(res['b4'])}")

    # 5. Compaction of everything pending: the exact index, then the ivf.
    before = [np.asarray(v) for v in _held_answers(base, held, d)]
    bview = app.mutable.snapshot()
    before_sid = _stable_ids(app.mutable, bview, before[1])
    st, comp = post(client, "/admin/compact", {})
    if st != 200 or not comp.get("compacted"):
        fail(f"/admin/compact answered {st}: {comp}")
    after = [np.asarray(v) for v in _held_answers(base, held, d)]
    aview = app.mutable.snapshot()
    after_sid = _stable_ids(app.mutable, aview, after[1])
    # A row may reorder a near tie (the delta rows' distances came from
    # the host merge before, from the kernels after): the distances hold
    # to the ulp rule, the predictions exactly.
    moved = np.nonzero((before_sid != after_sid).any(axis=1))[0]
    if not (np.allclose(before[0], after[0], rtol=d * 2.0 ** -24, atol=0)
            and np.array_equal(before[2], after[2])):
        fail("held distances or predictions moved in the compaction")
    if not ((idx_mut / "CURRENT.json").exists()
            and artifact.generation_path(idx_mut, 1).is_dir()
            and aview.count == 0 and aview.generation == 1):
        fail(f"compaction left {list(idx_mut.iterdir())}")
    st, icomp = post(_Client(iv[3]), "/admin/compact", {})
    if st != 200 or icomp.get("ivf_compaction") != "incremental":
        fail(f"ivf /admin/compact answered {st}: {icomp}")
    _stop_server(iv[1], iv[2], iapp)
    res["compaction"] = {
        "exact": {key: comp[key] for key in (
            "ms", "split_ms", "rows", "base_dropped", "delta_folded",
            "delta_dropped", "generation")},
        "exact_held_same": True, "held_rows_reordered_near_ties":
        int(moved.size),
        "ivf": {key: icomp[key] for key in (
            "ms", "split_ms", "rows", "ivf_compaction",
            "ivf_cell_imbalance")},
    }
    print(f"compaction: {json.dumps(res['compaction'])}")

    # 6. A compaction rolled back by an injected fault.
    far = (1e3 + np.arange(8 * d, dtype=np.float32)).reshape(8, d)
    st, _ = post(client, "/insert", {"rows": far.tolist(),
                                     "labels": [0] * 8})
    version = app.index_version
    held_before = _held_answers(base, held, d)
    with faults.inject("mutable.compact=once") as plan:
        st, body = post(client, "/admin/compact", {})
    rolled = sum(i.value for i in obs.registry().instruments()
                 if i.name == "knn_mutable_compactions_total"
                 and dict(i.labels).get("outcome") == "rolled_back")
    held_after = _held_answers(base, held, d)
    if (st != 500 or body.get("rolled_back") is not True
            or plan.stats()["mutable.compact"]["fired"] != 1
            or app.index_version != version or rolled != 1
            or any(not np.array_equal(a, b)
                   for a, b in zip(held_before, held_after))):
        fail(f"rollback: {st} {body}, rolled_back counter {rolled}")
    res["rollback"] = {"status": st, "rolled_back_total": rolled,
                       "old_generation_answers": True}
    print(f"rollback: {json.dumps(res['rollback'])}")

    # 7. Restart over a torn final epoch record: one more far row lands in
    # the epoch the rolled-back seal opened, and its line is cut in half.
    st, _ = post(client, "/insert", {"rows": (far[:1] + 1.0).tolist(),
                                     "labels": [0]})
    if st != 200:
        fail(f"insert before the restart answered {st}")
    _stop_server(server, th, app)
    last = artifact.list_epochs(idx_mut)[-1][1]
    text = last.read_text()
    cut = text.rstrip("\n").rfind("\n") + 1
    tail_line = text[cut:]
    last.write_text(text[:cut] + tail_line[:len(tail_line) // 2])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        app, server, th, base = boot(idx_mut, mutable=True)
    warned = "torn final record" in out.getvalue()
    repaired = not artifact.read_epoch_records(last)[1]
    held_restart = _held_answers(base, held, d)
    same = all(np.array_equal(a, b)
               for a, b in zip(held_after, held_restart))
    seq_after = app.mutable.seq
    _stop_server(server, th, app)
    if not (warned and repaired and same):
        fail(f"restart: warned {warned}, repaired {repaired}, same {same}")
    res["restart"] = {"torn_dropped_with_warning": True, "repaired": True,
                      "held_same": True, "seq": seq_after}
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"restart: {json.dumps(res['restart'])}")
    return res


SHARD_COUNTS = (2, 4)       # logical shards of one card in the sharded phase
SHARDED_SERVE_LEVELS = (("predict", 1, 1, 200), ("predict", 1, 8, 800))


def phase_sharded(torch, cuda_knn, tile_knn, train_path, test_path, xl_x,
                  xl_y, q_all, serve_levels, smi, dev=None) -> dict:
    """Multi-device on the card (ROADMAP A11, B7): the mesh engines, the
    launcher and sharded serving, on logical shards of one card (and across
    cards where more than one is visible). Every sharded answer is held to
    the single-device one, every call's launches read around it, the
    collectives' bytes audited against the byte model. ``dev`` (default
    the first card) is where every model and engine of the phase runs."""
    import gc
    import re
    import shutil

    from knn_tpu_torch import cli, obs
    from knn_tpu_torch.backends import get_backend
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.index.ivf import IVFServing
    from knn_tpu_torch.models.knn import DEFAULT_BATCH_BUCKETS
    from knn_tpu_torch.parallel import comm_audit
    from knn_tpu_torch.parallel.mesh import make_mesh
    from knn_tpu_torch.parallel.query_sharded import predict_query_sharded
    from knn_tpu_torch.parallel.ring import predict_ring, ring_layout
    from knn_tpu_torch.parallel.train_sharded import predict_train_sharded
    from knn_tpu_torch.serve import artifact
    from knn_tpu_torch.serve.server import ServeApp

    t_phase = time.perf_counter()
    data_dir = REPO / "build" / "chip_smoke"
    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    tile_scan = tile_knn.knn_tile_scan
    card = dev if dev is not None else torch.device("cuda", 0)
    on_card = card.type == "cuda"
    n, d = xl_x.shape
    k = 10
    ncls = int(xl_y.max()) + 1
    q = q_all.shape[0]
    res = {"shape": f"xl n={n} d={d} q={q} k={k}", "smi": smi,
           "cards": torch.cuda.device_count() if on_card else 0,
           "bodies": {}}
    where = [] if on_card else ["--device", "cpu"]
    mask = re.compile(r"required \d+ ms")

    def fail(msg):
        raise SystemExit(f"sharded: {msg}")

    def reset_counts():
        scan.launches = merge.launches = 0
        for form in tile_scan.launches:
            tile_scan.launches[form] = 0

    def counts():
        return {"stripe_scan": scan.launches, "stripe_merge": merge.launches,
                "tile_exact": tile_scan.launches["exact"]}

    def run_cli(argv):
        out = io.StringIO()
        rc = cli.run(argv, stdout=out)
        if rc != 0:
            fail(f"cli.run {argv[3:]} exited {rc}")
        return out.getvalue().splitlines()

    # 1. The CLI at xl: the mpi persona and the two other mesh backends on
    # the visible cards, each equal to --backend cuda.
    xl_path = data_dir / "xl-train.arff"
    t0 = time.perf_counter()
    write_arff(xl_path, xl_x, xl_y, "xl-train")
    print(f"wrote {xl_path} ({time.perf_counter() - t0:.1f} s, set-up)")
    dumps = {}
    for name, extra in (("cuda", []), ("mpi", ["--persona", "mpi"]),
                        ("cuda-train-sharded",
                         ["--backend", "cuda-train-sharded"]),
                        ("cuda-ring", ["--backend", "cuda-ring", "--engine",
                                       "stripe"])):
        dump = data_dir / f"sharded-{name}.npy"
        reset_counts()
        lines = run_cli([str(xl_path), str(test_path), str(k), *extra,
                         *where, "--json", "--dump-predictions", str(dump)])
        got = counts()
        if on_card and (got["stripe_scan"] < 1 or got["stripe_merge"] < 1):
            fail(f"cli {name}: the stripe kernels never launched: {got}")
        dumps[name] = np.load(dump)
        js = json.loads(lines[1])
        print(f"cli {name}: {lines[0]} backend={js['backend']} "
              f"launches {got}")
        if not np.array_equal(dumps[name], dumps["cuda"]):
            fail(f"cli {name}: predictions differ from --backend cuda")
    res["cli"] = "mpi, cuda-train-sharded, cuda-ring equal to cuda at xl"
    want = dumps["cuda"]
    xl_train = load_arff(str(xl_path))
    tx, ty = xl_train.features, xl_train.labels
    cache = xl_train.device_cache

    # 2. The engines on 2 and 4 logical shards of the card: predictions
    # equal to the single-card answer, launches per shard, the audit.
    def engine_run(label, fn, mesh, reps, **kw):
        log = []
        reset_counts()
        got = fn(tx, ty, q_all, k, ncls, devices=mesh, cache=cache, log=log,
                 **kw)
        launches = counts()
        if not np.array_equal(got, want):
            fail(f"{label}: predictions differ from the single-card answer")
        ms, _ = wall_ms(lambda: fn(tx, ty, q_all, k, ncls, devices=mesh,
                                   cache=cache, **kw), reps)
        return log, launches, ms

    test_ds = load_arff(str(test_path))
    cuda = get_backend("cuda")
    single_ms, _ = wall_ms(lambda: cuda(xl_train, test_ds, k,
                                        device=card.type), 3)
    b_ms, b_by = stripe_bound_ms(q, n, d, k)
    for s in SHARD_COUNTS:
        mesh = (card,) * s
        rows = -(-n // s)
        runs = {
            "query_sharded_stripe": engine_run(
                f"cuda-sharded x{s}", predict_query_sharded, mesh, 3,
                engine="stripe"),
            "train_sharded_stripe": engine_run(
                f"cuda-train-sharded x{s}", predict_train_sharded, mesh, 3,
                engine="stripe", mesh_shape=(1, s)),
            "ring_stripe": engine_run(
                f"cuda-ring x{s}", predict_ring, mesh, 3, engine="stripe"),
        }
        if s == 4:
            runs["train_sharded_stripe_2x2"] = engine_run(
                "cuda-train-sharded 2x2", predict_train_sharded, mesh, 1,
                engine="stripe", mesh_shape=(2, 2))
            runs["query_sharded_xla"] = engine_run(
                "cuda-sharded xla x4", predict_query_sharded, mesh, 1,
                engine="xla")
            runs["train_sharded_xla"] = engine_run(
                "cuda-train-sharded xla x4", predict_train_sharded, mesh, 1,
                engine="xla", mesh_shape=(1, 4))
        for name, (log, launches, ms) in runs.items():
            if on_card and name.endswith("stripe") and (
                    launches["stripe_scan"] < s
                    or launches["stripe_merge"] < s):
                fail(f"{name} x{s}: fewer than one scan and merge per shard: "
                     f"{launches}")
            if name.endswith("xla") and any(launches.values()):
                fail(f"{name}: a hand kernel launched on the torch scan: "
                     f"{launches}")
            if name.startswith("train_sharded"):
                n_q = 2 if name.endswith("2x2") else 1
                n_t = s // n_q
                audit = comm_audit.audit_train_sharded(
                    log, -(-q // n_q) if "stripe" in name
                    else -(-q // (n_q * 128)) * 128, k, n_t)
            elif name == "ring_stripe":
                audit = comm_audit.audit_ring(log, rows * d * 4, rows * 4, s)
            else:
                q_pad = sum(o.nbytes for o in log if o.op == "gather") // 4
                audit = (sum(o.nbytes for o in log),
                         comm_audit.model_query_sharded_bytes(q_pad, d))
                if audit[0] != audit[1]:
                    fail(f"{name} x{s}: scatter+gather {audit[0]} B != model "
                         f"{audit[1]} B")
            body = {"shards": s, "ms": ms, "single_card_ms": single_ms,
                    "launches": launches, "collective_bytes": audit[0],
                    "model_bytes": audit[1], "bound_ms": b_ms,
                    "bound_by": b_by}
            res["bodies"][f"{name}_x{s}"] = body
            print(f"{name} x{s} at xl: {json.dumps(body)}")

    # 3. The large fixture: the ring's full and tiled engines, and k = 32
    # through the tile kernel on every engine.
    large, large_test = load_arff(str(train_path)), load_arff(str(test_path))
    lx, ly = large.features, large.labels
    mesh4 = (card,) * 4
    for kk, extra in ((5, ("full", "tiled")), (32, ("stripe",))):
        lwant = cuda(large, large_test, kk, device=card.type)
        for engine in extra:
            log = []
            reset_counts()
            got = predict_ring(lx, ly, large_test.features, kk,
                               large.num_classes, engine=engine,
                               devices=mesh4, cache=large.device_cache,
                               log=log)
            launches = counts()
            if not np.array_equal(got, lwant):
                fail(f"ring {engine} k={kk} on large differs from cuda")
            rows = ring_layout(large_test.num_instances, lx.shape[0], 4,
                               engine, 128, 1024)[1]
            comm_audit.audit_ring(log, rows * lx.shape[1] * 4, rows * 4, 4)
            ms, _ = wall_ms(lambda: predict_ring(
                lx, ly, large_test.features, kk, large.num_classes,
                engine=engine, devices=mesh4, cache=large.device_cache), 1)
            res["bodies"][f"ring_{engine}_large_k{kk}_x4"] = {
                "ms": ms, "launches": launches,
                "collective_bytes": comm_audit.device_bytes(
                    log, "collective_permute")}
            if on_card and engine == "stripe" and launches["tile_exact"] < 4:
                fail(f"ring k=32: the tile kernel did not launch per shard: "
                     f"{launches}")
            print(f"ring {engine} k={kk} on large x4: equal to cuda, "
                  f"{ms} ms, launches {launches}")
        if kk == 32:
            for fn, kw in ((predict_query_sharded, {}),
                           (predict_train_sharded, {"mesh_shape": (1, 4)})):
                reset_counts()
                got = fn(lx, ly, large_test.features, kk, large.num_classes,
                         devices=mesh4, cache=large.device_cache, **kw)
                launches = counts()
                if not np.array_equal(got, lwant) or (
                        on_card and launches["tile_exact"] < 1):
                    fail(f"{fn.__name__} k=32: {launches}")
                print(f"{fn.__name__} k=32 on large x4: equal to cuda, "
                      f"launches {launches}")

    # 4. The launcher: two ranks on the large fixture. One card: the two
    # share it, on gloo; more cards: one rank per card, on NCCL.
    single = run_cli([str(train_path), str(test_path), "5", *where])[0]
    nprocs = [2] + ([min(4, res["cards"])] if res["cards"] >= 2 else [])
    res["launcher"] = {}
    for np_ in nprocs:
        dump = data_dir / f"launch-{np_}.npy"
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "knn_tpu_torch.parallel.launch", "-np",
             str(np_), "--device", card.type, "--timeout", "240",
             str(train_path), str(test_path),
             "5", "--json", "--dump-predictions", str(dump)],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"launch -np {np_} exited {out.returncode}: "
                 f"{out.stderr[-2000:]}")
        line, js = out.stdout.splitlines()[:2]
        js = json.loads(js)
        want_backend = "gloo" if np_ > res["cards"] else "nccl"
        if (mask.sub("", line) != mask.sub("", single)
                or js["dist_backend"] != want_backend
                or not np.array_equal(np.load(dump), cuda(
                    large, large_test, 5, device=card.type))):
            fail(f"launch -np {np_}: {line!r} vs {single!r}, {js}")
        res["launcher"][np_] = {"dist_backend": js["dist_backend"],
                                "ms": js["ms"], "wall_s": wall}
        print(f"launch -np {np_}: {out.stderr.strip().splitlines()[0]}; "
              f"{line}; {json.dumps(js)}; wall {wall:.1f} s (process "
              f"start-up included)")
    if res["cards"] >= 2:
        mesh = make_mesh(min(4, res["cards"]))
        for fn in (predict_query_sharded, predict_train_sharded,
                   predict_ring):
            got = fn(tx, ty, q_all, k, ncls, devices=mesh, cache=cache)
            if not np.array_equal(got, want):
                fail(f"{fn.__name__} across {len(mesh)} cards differs")
        print(f"the three engines across {len(mesh)} cards equal the "
              f"single-card answer at xl")
    else:
        print("one card visible: the mesh across cards and the launcher on "
              "NCCL are not run (logical shards of this card only)")

    # 5. ServeApp(shards=4) on the xl index: answers byte-equal to the
    # unsharded ones, launches = shards x batches, levels, memory.
    obs.enable()
    obs.reset()
    registry = obs.registry()
    buckets = tuple(sorted({b for b in DEFAULT_BATCH_BUCKETS if b < 256}
                           | {256}))
    idx_xl = data_dir / "idx-xl"
    plain = artifact.load_index(idx_xl, device=card.type)
    sync_d, sync_i = plain.kneighbors(Dataset(q_all, np.zeros(q, np.int32)))
    sync_p = plain.predict_from_candidates(sync_d, sync_i)
    del plain
    mem = {}

    def allocated():
        return torch.cuda.memory_allocated() if on_card else 0

    for label, shards in (("unsharded", None), ("shards4", 4)):
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        m0 = allocated()
        app = ServeApp(artifact.load_index(idx_xl, device=card.type),
                       max_batch=256, max_wait_ms=2.0, batch_buckets=buckets,
                       shards=shards)
        app.warm()
        mem[label] = allocated() - m0
        if shards is None:
            app.close()
            del app
    res["memory_bytes"] = mem
    print(f"card memory of the xl index, warmed: {json.dumps(mem)}")
    server, th, base = _start_server(app)
    res["levels"] = {}
    for kind, rows, clients, total in SHARDED_SERVE_LEVELS:
        name = f"{kind}_r{rows}_c{clients}"
        starts = [(j * rows) % (q - rows) for j in range(total)]
        blocks = np.stack([q_all[s:s + rows] for s in starts])
        b0 = _hist(registry, "knn_serve_batch_size")
        reset_counts()
        answers, lat, wall = _closed_loop(base, kind, blocks, clients)
        got = counts()
        batches = _hist(registry, "knn_serve_batch_size")[0] - b0[0]
        if on_card and (got["stripe_scan"] != 4 * batches
                        or got["stripe_merge"] != 4 * batches):
            fail(f"shards=4 {name}: {batches} batches but launches {got}")
        for j, doc in answers.items():
            if doc["predictions"] != sync_p[starts[j]:starts[j] + rows
                                            ].tolist():
                fail(f"shards=4 {name}: request {j} differs from unsharded")
        lat.sort()
        lv = {"p50_ms": lat[len(lat) // 2],
              "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
              "qps": total / wall, "batches": batches, "launches": got,
              "unsharded": {key: serve_levels.get(name, {}).get(key)
                            for key in ("p50_ms", "p99_ms", "qps")}}
        res["levels"][name] = lv
        print(f"xl shards=4 {name}: {json.dumps(lv)}")
    reset_counts()
    answers, _, _ = _closed_loop(base, "kneighbors",
                                 q_all[:64].reshape(16, 4, -1), 4)
    for j, doc in answers.items():
        kd = np.asarray(doc["distances"], np.float32)
        if not (np.array_equal(np.asarray(doc["indices"]),
                               sync_i[4 * j:4 * j + 4])
                and kd.tobytes() == sync_d[4 * j:4 * j + 4].tobytes()):
            fail(f"shards=4 /kneighbors request {j} differs from unsharded")
    st, _, body = _Client(base).call("GET", "/healthz")
    shard_block = json.loads(body)["shard"]
    if shard_block["num_shards"] != 4 or sum(
            shard_block["rows_per_shard"]) != n:
        fail(f"/healthz shard block {shard_block}")
    res["shard_block"] = {k2: shard_block[k2]
                          for k2 in ("num_shards", "rows_per_shard")}
    print(f"/kneighbors through 4 shards byte-equal to unsharded; /healthz "
          f"shard block {json.dumps(res['shard_block'])}")
    _stop_server(server, th, app)

    # 6. The ivf rung with shards (the ivf phase's partition, nprobe 32).
    idx_ivf = data_dir / "idx-xl-ivf"
    plain = artifact.load_index(idx_ivf, device=card.type)
    sample = q_all[:128]
    want_d, want_i = IVFServing(IVF_SERVE_PROBES, plain.ivf_.num_cells
                                ).kneighbors(plain, sample)
    app = ServeApp(artifact.load_index(idx_ivf, device=card.type),
                   max_batch=256, max_wait_ms=2.0,
                   ivf_probes=IVF_SERVE_PROBES, shards=4)
    app.warm((1, 16))
    handles = [app.batcher.submit(sample[16 * i:16 * i + 16], "kneighbors")
               for i in range(8)]
    got = [h.result(timeout=120) for h in handles]
    rungs = {h.meta["rung"] for h in handles}
    got_d = np.concatenate([g[0] for g in got])
    got_i = np.concatenate([g[1] for g in got])
    if rungs != {"ivf"} or not (np.array_equal(got_i, want_i)
                                and got_d.tobytes() == want_d.tobytes()):
        fail(f"ivf shards=4: rungs {rungs}, answers differ from unsharded")
    ivf_block = app.health()["shard"]["ivf"]
    res["ivf"] = {"num_shards": ivf_block["num_shards"],
                  "rows_per_shard": ivf_block["rows_per_shard"]}
    print(f"ivf_probes={IVF_SERVE_PROBES} with shards=4: 128 queries "
          f"byte-equal to the unsharded ivf rung; cells over "
          f"{ivf_block['num_shards']} shards, rows {ivf_block['rows_per_shard']}")
    app.close()
    del plain

    # 7. --mutable on with shards: 256 inserts and 64 deletes, then the
    # merged answers of the sharded app against the unsharded app's.
    prev_tail = os.environ.get("KNN_TPU_DEVICE_TAIL")
    os.environ["KNN_TPU_DEVICE_TAIL"] = "on"
    try:
        apps = {}
        for label, shards in (("unsharded", None), ("shards4", 4)):
            root = data_dir / f"sharded-mut-{label}"
            shutil.rmtree(root, ignore_errors=True)
            shutil.copytree(idx_xl, root)
            apps[label] = ServeApp(
                artifact.load_index(root, device=card.type), max_batch=256,
                max_wait_ms=2.0,
                index_path=str(root), mutable=True, delta_cap=4096,
                compact_threshold=1 << 20, compact_interval_s=0.0,
                shards=shards)
        rng = np.random.default_rng(13)
        rows = (xl_x[rng.choice(n, 256, replace=False)]
                + rng.normal(0, 1e-3, (256, d))).astype(np.float32)
        labels = rng.integers(0, ncls, 256)
        for label, app in apps.items():
            ids = []
            for i in range(0, 256, 64):
                ack = app.batcher.submit_mutation("insert", {
                    "rows": rows[i:i + 64],
                    "values": labels[i:i + 64].tolist()}).result(timeout=60)
                ids.extend(ack["ids"])
            app.batcher.submit_mutation(
                "delete", {"ids": ids[::4]}).result(timeout=60)
        merged = {}
        for label, app in apps.items():
            reset_counts()
            out = [app.batcher.kneighbors(q_all[64 * i:64 * i + 64],
                                          timeout=120) for i in range(4)]
            merged[label] = (np.concatenate([o[0] for o in out]),
                             np.concatenate([o[1] for o in out]), counts())
        (ud, ui, ul), (sd, si, sl) = merged["unsharded"], merged["shards4"]
        if not (np.array_equal(ui, si) and ud.tobytes() == sd.tobytes()):
            fail("mutable shards=4: merged answers differ from unsharded")
        res["mutable"] = {"inserts": 256, "deletes": 64,
                          "launches_unsharded": ul, "launches_sharded": sl}
        print(f"--mutable on with shards=4: 256 inserts, 64 deletes, 256 "
              f"queries byte-equal to the unsharded merged answers; "
              f"launches unsharded {ul}, sharded {sl} (the fused merge runs "
              f"each shard on the torch scan)")
        for app in apps.values():
            app.close()
    finally:
        if prev_tail is None:
            os.environ.pop("KNN_TPU_DEVICE_TAIL", None)
        else:
            os.environ["KNN_TPU_DEVICE_TAIL"] = prev_tail
    obs.disable()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"sharded phase: {res['phase_s']:.1f} s")
    return res


def _held_answers(base, held, d):
    """The held queries through ``/kneighbors`` (16 requests of 16 rows,
    one client) and ``/predict``: ``(distances, indices, predictions)``."""
    client = _Client(base)
    parts = {"distances": [], "indices": [], "predictions": []}
    for j in range(0, len(held), 16):
        rows = held[j:j + 16].tolist()
        _, _, body = client.call("POST", "/kneighbors", {"instances": rows})
        doc = json.loads(body)
        parts["distances"].append(np.asarray(doc["distances"], np.float32))
        parts["indices"].append(np.asarray(doc["indices"], np.int64))
        _, _, body = client.call("POST", "/predict", {"instances": rows})
        parts["predictions"].append(np.asarray(json.loads(body)
                                               ["predictions"]))
    client.close()
    return tuple(np.concatenate(parts[key]) for key in
                 ("distances", "indices", "predictions"))


CONTROL_WAIT_MS = 2.0
CONTROL_PRIORITY = {"interactive": 0, "batch": 1}
CONTROL_ROWS = 64          # rows of a `batch` request
# The layers' cost: single-row /predict at c = 8, every flag off against
# every flag on, alternated off, on, off, on; each level this many requests
# (several seconds at the c = 8 rates of PRs 9-13).
CONTROL_COST_REQUESTS = 2400
CONTROL_COST_ROUNDS = 2
# The top tier's largest share of 504s (its deadline ran out) by part. W
# overloads the batcher by design before the policy sheds, so its 504s are
# reported without a limit. In A the policy sheds `batch`, but the brownout
# halves the 50 ms deadline and every shed request is still read and parsed
# on the host (the interpreter lock), so the top tier's slowest answers
# expire: the bound holds A to a top tier the policy protects, not to none.
# B is quiet.
CONTROL_TOP_TIER_504_MAX = {"A": 0.20, "B": 0.01}
# The load's phases: (name, seconds, batch, interactive clients). W sends
# `batch` closed loop at c = 8, below the knee: it fills the capacity
# window with a batch-heavy served mix (headroom is priced in requests of
# the SERVED mix, so a window of single-row traffic reads a 64-row
# overload as light) and measures the rows it is served. A sends `batch`
# open loop at 1.5x the larger of those rows and the model's sustainable
# rows, raised 1.5x every 4 s while headroom has not fallen below 1. B is
# quiet, and ends once the brownout, the shed tiers and the alert are back
# to rest (at least CONTROL_B_MIN_S, at most its seconds).
CONTROL_LOAD = (("W", 4.0, "closed", 4), ("A", 20.0, "open", 4),
                ("B", 40.0, None, 1))
CONTROL_BATCH_CLIENTS = 8    # W's closed loop
CONTROL_OVERLOAD = 1.5       # A's offered rows over the measured rows
CONTROL_B_MIN_S = 8.0

# The control phase's load generator, its own process (another interpreter
# lock): argv[1] is a JSON spec. `batch` 64-row /predict goes open loop (a
# due time per request from the offered rate, on a pool of keep-alive
# connections) or closed loop, `interactive` single-row /predict closed
# loop; a poller reads /debug/capacity, /debug/control and /debug/alerts
# every 0.25 s. Every 200 is compared with the expected predictions.
# Prints one JSON object.
_CONTROL_CLIENT = r"""
import http.client, json, sys, threading, time
from urllib.parse import urlparse
import numpy as np
spec = json.loads(sys.argv[1])
u = urlparse(spec["base"])
blocks, rows = np.load(spec["blocks"]), np.load(spec["rows"])
want_b, want_r = np.load(spec["want_blocks"]), np.load(spec["want_rows"])
body_b = [json.dumps({"instances": b.tolist(), "class": "batch"}).encode()
          for b in blocks]
body_r = [json.dumps({"instances": [r.tolist()], "class": "interactive"})
          .encode() for r in rows]
lock = threading.Lock()
stats, samples = {}, []
state = {"sustainable": spec["sustainable_rows_per_s"], "rates": {},
         "min_headroom": {}}
def conn():
    return http.client.HTTPConnection(u.hostname, u.port, timeout=120)
def record(key, status, ms, data, want, retry, t_rel):
    with lock:
        s = stats.setdefault(key, {"offered": 0, "ok": 0, "policy_shed": 0,
                                   "policy_shed_without_retry_after": 0,
                                   "statuses": {}, "mismatches": 0,
                                   "first_policy_shed_s": None,
                                   "expired_at_s": [], "lat": []})
        s["offered"] += 1
        s["statuses"][str(status)] = s["statuses"].get(str(status), 0) + 1
        if status == 200:
            s["ok"] += 1
            s["lat"].append(ms)
            if json.loads(data)["predictions"] != want:
                s["mismatches"] += 1
        elif status == 504:
            s["expired_at_s"].append(round(t_rel, 2))
        elif status == 429 and b"shed by admission policy" in data:
            s["policy_shed"] += 1
            if retry is None:
                s["policy_shed_without_retry_after"] += 1
            if s["first_policy_shed_s"] is None:
                s["first_policy_shed_s"] = t_rel
def send(c, key, body, want, t0):
    t = time.perf_counter()
    try:
        c.request("POST", "/predict", body=body,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        status, retry, data = r.status, r.getheader("Retry-After"), r.read()
    except (OSError, http.client.HTTPException):
        c.close()
        status, retry, data = "conn_error", None, b""
    record(key, status, (time.perf_counter() - t) * 1e3, data, want, retry,
           t - t0)
def closed_loop(phase, stop, offset, step, t0, cls="interactive"):
    c, j = conn(), offset
    while not stop.is_set():
        if cls == "batch":
            i = j % len(body_b)
            send(c, f"{phase}/batch", body_b[i], want_b[i].tolist(), t0)
        else:
            i = j % len(body_r)
            send(c, f"{phase}/interactive", body_r[i], [int(want_r[i])], t0)
        j += step
    c.close()
def open_loop(phase, stop, t0, sched):
    c = conn()
    while True:
        with lock:
            due, j = sched["due"], sched["j"]
            sched["due"] += 1.0 / sched["rate"]
            sched["j"] += 1
        wait = due - time.perf_counter()
        if wait > 0:
            stop.wait(wait)
        if stop.is_set():
            break
        i = j % len(body_b)
        send(c, f"{phase}/batch", body_b[i], want_b[i].tolist(), t0)
    c.close()
def get(c, path):
    c.request("GET", path)
    return json.loads(c.getresponse().read())
def poller(phase, stop, t0, sched, min_s, max_s):
    c, last_ramp = conn(), time.perf_counter()
    while not stop.is_set():
        now = time.perf_counter()
        cap = get(c, "/debug/capacity")["capacity"] or {}
        ctl = get(c, "/debug/control")
        firing = get(c, "/debug/alerts")["firing"]
        h = cap.get("headroom_ratio")
        level = ctl["brownout"]["level"]
        tiers = ctl["admission"]["shed_tiers"]
        with lock:
            samples.append([phase, round(now - t0, 3), h,
                            cap.get("arrival_qps"),
                            cap.get("arrival_rows_per_s"),
                            cap.get("sustainable_rows_per_s"), level, tiers,
                            firing, (ctl.get("autotune") or {}).get(
                                "live_max_wait_ms")])
            low = state["min_headroom"].get(phase)
            if h is not None and (low is None or h < low):
                state["min_headroom"][phase] = low = h
            if phase == "W" and cap.get("sustainable_rows_per_s"):
                state["sustainable"] = cap["sustainable_rows_per_s"]
            if (phase == "A" and now - last_ramp >= 4.0
                    and (low is None or low >= 1.0)):
                sched["rate"] *= 1.5
                state["rates"][phase].append(sched["rate"])
                last_ramp = now
        el = now - t0
        if el >= max_s or (phase == "B" and el >= min_s and level == 0
                           and tiers == 0 and not firing):
            stop.set()
        stop.wait(0.25)
    c.close()
walls = {}
for phase, seconds, batch, clients in spec["load"]:
    stop = threading.Event()
    t0 = time.perf_counter()
    served = 0.0
    if "W/batch" in stats:
        served = (stats["W/batch"]["ok"] * spec["rows_per_batch"]
                  / walls["W"])
    rows_per_s = max(served, state["sustainable"])
    sched = {"due": t0, "j": 0, "rate": (
        spec["overload"] * rows_per_s / spec["rows_per_batch"])}
    state["rates"][phase] = [sched["rate"]] if batch == "open" else []
    ths = [threading.Thread(target=closed_loop,
                            args=(phase, stop, k, clients, t0))
           for k in range(clients)]
    if batch == "closed":
        ths += [threading.Thread(target=closed_loop, args=(
                    phase, stop, k, spec["batch_clients"], t0, "batch"))
                for k in range(spec["batch_clients"])]
    elif batch == "open":
        ths += [threading.Thread(target=open_loop,
                                 args=(phase, stop, t0, sched))
                for _ in range(spec["batch_connections"])]
    ths.append(threading.Thread(target=poller, args=(
        phase, stop, t0, sched, spec["b_min_s"], seconds)))
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    walls[phase] = time.perf_counter() - t0
for key, s in stats.items():
    lat = sorted(s.pop("lat"))
    s["p50_ms"] = lat[len(lat) // 2] if lat else None
    s["p99_ms"] = lat[min(len(lat) - 1, int(len(lat) * 0.99))] if lat else None
    s["qps"] = s["ok"] / walls[key.split("/")[0]]
    s["offered_per_s"] = s["offered"] / walls[key.split("/")[0]]
print(json.dumps({"stats": stats, "walls": walls, "rates": state["rates"],
                  "min_headroom": state["min_headroom"],
                  "samples": samples}))
"""


def phase_control(torch, cuda_knn, tile_knn, q_all, smi) -> dict:
    """The serving process's control plane and durable history on the card
    (ROADMAP A12a): the serve phase's xl index served with every layer of
    the slice on (priority admission, brownout, autotune, history, alerts,
    beside cost accounting, shadow and drift sampling, capture and a
    deadline), under overload then quiet, with the clients in another
    process; first the layers' host cost, single-row /predict at c = 8
    with every flag off against every flag on, alternated over two
    rounds."""
    import shutil

    from knn_tpu_torch import obs
    from knn_tpu_torch.data.dataset import Dataset
    from knn_tpu_torch.models.knn import DEFAULT_BATCH_BUCKETS
    from knn_tpu_torch.obs.alerts import parse_rules
    from knn_tpu_torch.obs.slo import SLOTracker
    from knn_tpu_torch.serve import artifact
    from knn_tpu_torch.serve.server import ServeApp

    t_phase = time.perf_counter()
    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge
    tile_scan = tile_knn.knn_tile_scan
    data_dir = REPO / "build" / "chip_smoke"
    work = data_dir / "control"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    idx_xl = data_dir / "idx-xl"
    buckets = tuple(sorted({b for b in DEFAULT_BATCH_BUCKETS if b < 256}
                           | {256}))
    res = {"smi": smi, "cost_c8": {}}

    def fail(msg):
        raise SystemExit(f"control: {msg}")

    def reset_counts():
        scan.launches = merge.launches = 0
        for form in tile_scan.launches:
            tile_scan.launches[form] = 0

    def batches():
        return _hist(obs.registry(), "knn_serve_batch_size")[0]

    def check_launches(what, b0):
        n = batches() - b0
        got = {"stripe_scan": scan.launches, "stripe_merge": merge.launches,
               "tile": sum(tile_scan.launches.values())}
        if (n < 1 or got["stripe_scan"] != n or got["stripe_merge"] != n
                or got["tile"]):
            fail(f"{what}: {n} batches but launches {got}")
        return n

    obs.enable()
    obs.reset()
    model = artifact.load_index(idx_xl)
    manifest = artifact.read_manifest(idx_xl)
    sync_p = model.predict_from_candidates(
        *model.kneighbors(Dataset(q_all, np.zeros(len(q_all), np.int32))))

    # 1. The layers' host cost: single-row /predict at c = 8 on the xl
    # index, every flag off against every flag of the slice on (with the
    # sample queues, capture and the deadline) but no overload, alternated
    # off, on, off, on on two servers up at once. Rates and latencies are
    # of the 200 answers; the 504s (the deadline, flags on) stand apart.
    cost_blocks = np.stack([q_all[j % len(q_all)][None]
                            for j in range(CONTROL_COST_REQUESTS)])

    def cost_level(base_url, name):
        b0 = batches()
        answers, lat, wall = _closed_loop(base_url, "predict", cost_blocks,
                                          8, tolerate=(504,))
        n = batches() - b0
        expired = 0
        for j, doc in answers.items():
            if "predictions" not in doc:
                expired += 1  # a 504: the deadline (flags on) ran out
            elif doc["predictions"] != sync_p[j % len(q_all):][:1].tolist():
                fail(f"cost {name}: request {j} differs from the "
                     f"synchronous answer")
        lat.sort()
        lv = {"requests": len(answers), "ok": len(lat),
              "expired_504": expired, "p50_ms": lat[len(lat) // 2],
              "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
              "qps": len(lat) / wall, "wall_s": wall, "batches": n}
        res["cost_c8"].setdefault(name, []).append(lv)
        print(f"control cost c=8 {name}: {json.dumps(lv)}")

    off = ServeApp(model, max_batch=256, max_wait_ms=CONTROL_WAIT_MS,
                   batch_buckets=buckets, cost_accounting=True,
                   index_version="xl")
    off.warm()
    off_server = _start_server(off)

    rules_path = work / "rules.json"
    rules_path.write_text(json.dumps([{
        "name": "batch_shed", "type": "threshold",
        "metric": "knn_control_admission_shed_tiers", "op": ">",
        "value": 0, "for_s": 0, "resolve_for_s": 2,
        "actions": [{"do": "command", "cmd": f"{sys.executable} -c pass"},
                    {"do": "capture", "window_s": 2}]}]))
    saved_env = os.environ.get("KNN_TPU_CONTROL_COOLDOWN_MS")
    # One step per second (2 s by default) so the ladder walks down and back
    # within the phase; every other knob at its default.
    os.environ["KNN_TPU_CONTROL_COOLDOWN_MS"] = "1000"
    t_app = time.perf_counter()
    try:
        app = ServeApp(
            model, max_batch=256, max_wait_ms=CONTROL_WAIT_MS,
            batch_buckets=buckets, index_version="xl",
            cost_accounting=True, capacity_window_s=5,
            slo=SLOTracker(windows_s=(5, 60)),
            priority_map=CONTROL_PRIORITY, brownout=True,
            shadow_rate=0.1, drift_rate=0.1, quality_queue=64,
            reference_sketch=artifact.reference_sketch(manifest),
            deadline_ms=50.0, capture_dir=str(work / "cap"),
            autotune_interval_s=3.0, history_dir=str(work / "hist"),
            history_interval_s=1.0,
            alert_rules=parse_rules(json.loads(rules_path.read_text())))
    finally:
        if saved_env is None:
            os.environ.pop("KNN_TPU_CONTROL_COOLDOWN_MS", None)
        else:
            os.environ["KNN_TPU_CONTROL_COOLDOWN_MS"] = saved_env
    app.warm()
    # The launch counters are read around the cost levels and the load
    # together: from here until the app closes, every batch of either app
    # (the autotuner's replays among them) launches one scan and one merge.
    reset_counts()
    b0 = batches()
    server, th, base = _start_server(app)
    for _ in range(CONTROL_COST_ROUNDS):
        cost_level(off_server[2], "flags_off")
        cost_level(base, "flags_on_no_overload")
    _stop_server(*off_server[:2], off)
    qps = {name: [lv["qps"] for lv in levels]
           for name, levels in res["cost_c8"].items()}
    lo_on, hi_on = min(qps["flags_on_no_overload"]), max(
        qps["flags_on_no_overload"])
    lo_off, hi_off = min(qps["flags_off"]), max(qps["flags_off"])
    # Resolved: the two levels' ranges over the rounds do not overlap.
    res["cost_c8_resolved"] = hi_on < lo_off or hi_off < lo_on
    print(f"control cost c=8 q/s: flags off {qps['flags_off']}, flags on "
          f"{qps['flags_on_no_overload']}; the levels' ranges "
          f"{'do not overlap' if res['cost_c8_resolved'] else 'overlap'}")
    st, _, body = _Client(base).call("GET", "/debug/capacity")
    cap = json.loads(body)["capacity"]
    sustainable = cap["sustainable_rows_per_s"]
    res["warmup_capacity"] = {k: cap[k] for k in (
        "sustainable_qps", "sustainable_rows_per_s", "headroom_ratio",
        "dispatch_model")}
    print(f"control warm-up: sustainable {cap['sustainable_qps']} q/s "
          f"({sustainable} rows/s, model {cap['dispatch_model']}) at the "
          f"single-row mix; load phases {CONTROL_LOAD}")

    # 2. The load (W, A, B), clients in another process.
    starts = [(j * 37) % (len(q_all) - CONTROL_ROWS) for j in range(256)]
    blocks = np.stack([q_all[s:s + CONTROL_ROWS] for s in starts])
    files = {"blocks": blocks, "want_blocks": np.stack(
                 [sync_p[s:s + CONTROL_ROWS] for s in starts]),
             "rows": q_all, "want_rows": sync_p}
    spec = {"base": base, "sustainable_rows_per_s": sustainable,
            "rows_per_batch": CONTROL_ROWS, "batch_connections": 64,
            "batch_clients": CONTROL_BATCH_CLIENTS,
            "overload": CONTROL_OVERLOAD, "load": CONTROL_LOAD,
            "b_min_s": CONTROL_B_MIN_S}
    for key, arr in files.items():
        spec[key] = str(work / f"{key}.npy")
        np.save(spec[key], arr)
    out = subprocess.run([sys.executable, "-c", _CONTROL_CLIENT,
                          json.dumps(spec)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        fail(f"the load client exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    load = json.loads(out.stdout)
    st, _, body = _Client(base).call("GET", "/debug/control")
    control = json.loads(body)
    server.shutdown()
    server.server_close()
    th.join(timeout=30)
    autotune = app.autotune.export()
    # The app's serving life, which the history sampled once a second
    # (close adds one final snapshot).
    app_s = time.perf_counter() - t_app
    app.close()  # the history's final snapshot; the alert actions drained
    n_batches = check_launches("cost levels, overload and quiet", b0)

    # 3. The checks: everything is printed first, then the phase fails on
    # the first problem, with the poller's timeline beside it.
    stats = load["stats"]
    for key, s in sorted(stats.items()):
        print(f"control {key}: {json.dumps(s)}")
    print(f"control offered batch rates by phase {load['rates']} "
          f"requests/s, lowest headroom_ratio by phase "
          f"{load['min_headroom']}, phase walls {load['walls']}")
    res.update(load=stats, rates=load["rates"], walls=load["walls"],
               min_headroom=load["min_headroom"], batches=n_batches,
               samples=load["samples"])
    expired = {key: s["statuses"].get("504", 0)
               for key, s in sorted(stats.items())}
    top_share = {part: expired.get(f"{part}/interactive", 0)
                 / max(1, stats.get(f"{part}/interactive",
                                    {"offered": 0})["offered"])
                 for part in ("W", "A", "B")}
    res["expired_504"], res["top_tier_504_share"] = expired, top_share
    print(f"control 504s by part and class {expired}; the top tier's share "
          f"of 504s by part {top_share} (at most "
          f"{CONTROL_TOP_TIER_504_MAX} in A and B; W unbounded)")
    brown = control["brownout"]
    applied = [e for e in brown["audit"] if e["action"] == "apply"]
    reverted = [e for e in brown["audit"] if e["action"] == "revert"]
    print(f"control brownout audit: {json.dumps(brown['audit'])}")
    print(f"control admission: moves {control['admission']['moves']}, "
          f"audit {json.dumps(control['admission']['audit'])}")
    outcomes = [(e["outcome"], {k: e.get(k) for k in (
        "reason", "current_max_wait_ms", "candidate_max_wait_ms",
        "predicted_p99_ms", "deadline_ms", "replay_divergences",
        "replay_verified", "error") if k in e})
        for e in autotune["audit"]]
    print(f"control autotune: {autotune['cycles']} cycles "
          f"{autotune['outcomes']}; {json.dumps(outcomes)}")
    entries = [json.loads(ln) for ln in
               (work / "hist" / "alerts.jsonl").read_text().splitlines()]
    events = [(e["event"], e.get("on"), e.get("action"), e.get("outcome"))
              for e in entries if e.get("alert") == "batch_shed"]
    print(f"control alerts.jsonl: {events}")
    res["alerts"] = events

    problems = []
    low = min(load["min_headroom"].values(), default=None)
    if low is None or low >= 1.0:
        problems.append(f"headroom never fell below 1 (lowest {low}): the "
                        f"overload was not real")
    for key, s in stats.items():
        if s["mismatches"]:
            problems.append(f"{key}: {s['mismatches']} answers differ from "
                            f"the synchronous ones")
        if s["policy_shed_without_retry_after"]:
            problems.append(f"{key}: policy sheds without Retry-After")
        # An answer is a 200, a 504 (the deadline) or, for `batch` alone, a
        # policy shed; a plain overload 429, a 5xx or a lost connection fails.
        other = {st: n for st, n in s["statuses"].items()
                 if st not in ("200", "504")}
        if key.endswith("/batch"):
            other["429"] = other.get("429", 0) - s["policy_shed"]
        other = {st: n for st, n in other.items() if n}
        if other:
            problems.append(f"{key}: answers other than 200, a policy shed "
                            f"of batch and 504: {other}")
    for part, limit in CONTROL_TOP_TIER_504_MAX.items():
        if f"{part}/interactive" not in stats:
            problems.append(f"part {part} sent no interactive request")
        elif top_share[part] > limit:
            problems.append(f"interactive, the top tier, lost "
                            f"{top_share[part]:.2%} of its requests in part "
                            f"{part} to 504s (at most {limit:.0%})")
    if not sum(s["policy_shed"] for k, s in stats.items()
               if k.endswith("/batch")):
        problems.append("batch was never shed by policy")
    shed_interactive = sum(s["policy_shed"] for k, s in stats.items()
                           if k.endswith("/interactive"))
    if shed_interactive:
        problems.append(f"interactive, the top tier, was shed by policy "
                        f"{shed_interactive} times")
    if not applied or brown["level"] != 0 or len(reverted) != len(applied):
        problems.append(f"brownout: level {brown['level']}, {len(applied)} "
                        f"applied, {len(reverted)} reverted")
    if autotune["cycles"] < 1:
        problems.append("no autotune cycle ran")
    for outcome, detail in outcomes:
        if outcome == "applied" and (detail.get("replay_divergences") != 0
                                     or not detail.get("replay_verified")):
            problems.append(f"an applied autotune cycle was not "
                            f"replay-verified: {detail}")
    fires = [i for i, e in enumerate(events) if e[0] == "fire"]
    resolves = [i for i, e in enumerate(events) if e[0] == "resolve"]
    if not fires or not resolves or resolves[0] < fires[0]:
        problems.append(f"alert batch_shed: want fire before resolve, got "
                        f"{events}")
    # Event order: each action entry names its event by (ts, on); their
    # positions among the rule's fire/resolve events never go back, and
    # every event has all its actions audited.
    want_actions = {"fire": {"forensics", "command", "capture"},
                    "resolve": {"command"}}
    keyed = [(e["ts"], e["event"]) for e in entries
             if e.get("alert") == "batch_shed"
             and e["event"] in ("fire", "resolve")]
    pos = {k: i for i, k in enumerate(keyed)}
    acts = [(pos.get((e["ts"], e["on"])), e["action"]) for e in entries
            if e.get("alert") == "batch_shed" and e["event"] == "action"]
    if (any(p is None for p, _ in acts)
            or [p for p, _ in acts] != sorted(p for p, _ in acts)
            or any({a for p, a in acts if p == i} != want_actions[ev]
                   for i, (_, ev) in enumerate(keyed))):
        problems.append(f"alert actions not audited in event order: "
                        f"{events}")
    if problems:
        print(f"control timeline [part, s, headroom_ratio, arrival q/s, "
              f"arrival rows/s, sustainable rows/s, brownout level, shed "
              f"tiers, firing, live max_wait_ms]: "
              f"{json.dumps(load['samples'])}")
        fail("; ".join(problems))

    # 4. The post-mortem subcommands over the directories.
    n_min = int(app_s) - 2
    hist_out = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch", "history",
         str(work / "hist"), "--json"], capture_output=True, text=True,
        timeout=120, cwd=REPO)
    if hist_out.returncode != 0:
        fail(f"history exited {hist_out.returncode}: {hist_out.stderr}")
    samples = json.loads(hist_out.stdout)["samples"]
    from knn_tpu_torch.obs.history import load_history

    ts = [t for t, _ in load_history(str(work / "hist")).samples]
    gaps = np.diff(ts)
    res["history_gaps_s"] = {"min": float(gaps.min()),
                             "median": float(np.median(gaps)),
                             "max": float(gaps.max())}
    print(f"control history: {samples} samples, gaps between them "
          f"{json.dumps(res['history_gaps_s'])} s (at most 2 intervals)")
    if samples < n_min:
        fail(f"history: {samples} samples, want at least {n_min}")
    # A sampler that stalls (the interpreter lock under load) skips ticks:
    # it shows as a gap wider than the count alone would reveal.
    if gaps.max() > 2.0:
        fail(f"history: a gap of {gaps.max():.3f} s between samples "
             f"(interval 1 s)")
    rep = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch", "report", "--history",
         str(work / "hist"), "--captures", str(work / "cap"), "--out",
         str(work / "R.md"), "--json-out", str(work / "R.json")],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    if rep.returncode != 0:
        fail(f"report exited {rep.returncode}: {rep.stderr}")
    doc = json.loads((work / "R.json").read_text())
    if not any(e["kind"] == "alert-fire" and e.get("alert") == "batch_shed"
               for e in doc["timeline"]):
        fail("report: the timeline lacks the alert")
    res["history"] = {"samples": samples, "app_s": app_s,
                      "segments": doc["history"]["segments"],
                      "timeline": len(doc["timeline"]),
                      "captures": len(doc["captures"])}
    print(f"control history: {samples} samples over the app's {app_s:.1f} s "
          f"(want "
          f">= {n_min}); report: {len(doc['timeline'])} timeline entries, "
          f"{len(doc['captures'])} captures, the alert's fire and resolve "
          f"on it")
    obs.disable()
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"control phase wall {res['wall_s']:.1f} s")
    return res


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: "
              "this script needs a CUDA card", file=sys.stderr)
        return 1
    from knn_tpu_torch import cli
    from knn_tpu_torch.backends import get_backend
    from knn_tpu_torch.backends.oracle import knn_oracle
    from knn_tpu_torch.data.arff import load_arff
    from knn_tpu_torch.ops import _build, cuda_knn, probe_matmul, tile_knn
    from knn_tpu_torch.ops.vote import vote, vote_neighbors

    dev = torch.device("cuda")
    wrapper = cuda_knn.knn_stripe_candidates
    scan, merge = cuda_knn.knn_stripe_scan, cuda_knn.knn_stripe_merge

    def plain_predict(tx, ty, qx, n_valid, k, num_classes):
        _, idx = cuda_knn.knn_stripe_candidates_reference(tx, qx, n_valid, k)
        return idx, vote(ty[idx.clamp(max=ty.shape[0] - 1).long()], num_classes)

    phase("env")
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")

    phase("build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {[p.name for p in libs]} in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")

    phase("kernel_parity")
    rng = np.random.default_rng(0)
    err = {"scan": 0.0, "merge": 0.0, "candidates": 0.0}
    n_cases = 0
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, tx, qx, n_valid, k in parity_cases(rng):
        t = torch.from_numpy(tx).to(dev)
        qt = torch.from_numpy(qx).to(dev)
        plan = cuda_knn.split_plan(n_valid, qt.shape[0], sm_count)
        partial = scan(t, qt, n_valid, k, *plan)
        want = cuda_knn.knn_stripe_scan_reference(t, qt, n_valid, k, *plan)
        check_equal(f"kernel_parity {name} scan keys", torch, partial, want)
        err["scan"] = max(err["scan"], max_err(torch, *(
            cuda_knn._unpack_keys(x)[0] for x in (partial, want))))
        md, mi = merge(partial)
        rd, ri = cuda_knn.knn_stripe_merge_reference(partial)
        check_equal(f"kernel_parity {name} merge indices", torch, mi, ri)
        check_equal(f"kernel_parity {name} merge distances", torch, md, rd)
        err["merge"] = max(err["merge"], max_err(torch, md, rd))
        kd, ki = wrapper(t, qt, n_valid, k)
        rd, ri = cuda_knn.knn_stripe_candidates_reference(t, qt, n_valid, k)
        check_equal(f"kernel_parity {name} indices", torch, ki, ri)
        check_equal(f"kernel_parity {name} distances", torch, kd, rd)
        err["candidates"] = max(err["candidates"], max_err(torch, kd, rd))
        n_cases += 1
    print(f"{n_cases} cases (tolerance: bit-equal): scan keys equal; merge and "
          f"scan+merge indices equal, distances bit-equal; max_abs_err {err}")

    phase("kernel_parity_tile")
    tile_err = phase_kernel_parity_tile(torch, dev, tile_knn, cuda_knn)

    phase("kernel_parity_select")
    select_err = phase_kernel_parity_select(torch, dev, cuda_knn)

    phase("kernel_parity_matmul")
    matmul_err = phase_kernel_parity_matmul(torch, dev, probe_matmul)

    phase("kernel_parity_bigk")
    bigk_err = phase_kernel_parity_bigk(torch, dev, cuda_knn, tile_knn)

    phase("classify_large")
    train_x, train_y, test_x, test_y = large_fixture(seed=0)
    data_dir = REPO / "build" / "chip_smoke"
    data_dir.mkdir(parents=True, exist_ok=True)
    train_path, test_path = data_dir / "large-train.arff", data_dir / "large-test.arff"
    write_arff(train_path, train_x, train_y, "large-train")
    write_arff(test_path, test_x, test_y, "large-test")
    out = io.StringIO()
    scan.launches = merge.launches = 0
    rc = cli.run([str(train_path), str(test_path), "5", "--warmup", "--json"],
                 stdout=out)
    launches = {"scan": scan.launches, "merge": merge.launches}
    if rc != 0:
        raise SystemExit(f"classify_large: cli.run exited {rc}")
    line, js = out.getvalue().splitlines()
    print(line)
    print(js)
    if min(launches.values()) < 1:
        raise SystemExit(f"classify_large: a kernel was never launched: {launches}")
    print(f"launches on the main path: {launches} (--warmup run + timed run)")
    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    preds = get_backend("cuda")(train, test, 5)
    tx = torch.from_numpy(train.features.copy()).to(dev)
    ty = torch.from_numpy(train.labels.copy()).to(dev)
    qx = torch.from_numpy(test.features.copy()).to(dev)
    n, d, q = train.num_instances, train.num_features, test.num_instances
    ri, plain = plain_predict(tx, ty, qx, n, 5, train.num_classes)
    check_equal("classify_large predictions", torch,
                torch.from_numpy(preds), plain.cpu())
    kd, ki = wrapper(tx, qx, n, 5)
    rd, _ = cuda_knn.knn_stripe_candidates_reference(tx, qx, n, 5)
    check_equal("classify_large indices", torch, ki, ri)
    check_equal("classify_large distances", torch, kd, rd)
    acc = float((preds == test.labels).mean())
    if f"Accuracy was {acc:.4f}" not in line or preds.shape != (q,):
        raise SystemExit(f"classify_large: accuracy {acc:.4f} not in {line!r}")
    # The numpy oracle on a slice of the queries: the host truth rung.
    oracle = knn_oracle(train.features, train.labels, test.features[:128], 5,
                        train.num_classes)
    if not np.array_equal(oracle, preds[:128]):
        raise SystemExit("classify_large: kernel disagrees with the oracle")
    queries = [qx.clone() for _ in range(12)]
    large_ms = cuda_ms(wrapper, [(tx, qb, n, 5) for qb in queries], reps=12)
    large_bound, _ = stripe_bound_ms(q, n, d, 5)
    print(f"predictions, indices and distances equal to the plain version on "
          f"the card (bit-equal), predictions equal to the oracle on 128 "
          f"queries; scan+merge at {n}x{d}, {q} queries, k=5, "
          f"{cuda_knn.stripe_split_plan(n, q, dev, d, 5)[0]} splits: "
          f"{large_ms} ms (bound {large_bound} ms)")

    phase("classify_xl")
    xl_x, xl_y = tiled_large(train.features, train.labels, reps=33)
    n, d = xl_x.shape
    q, k = test.num_instances, 10
    tx = torch.from_numpy(xl_x).to(dev)
    ty = torch.from_numpy(xl_y).to(dev)
    queries = [qx.clone() for _ in range(12)]
    kd, ki = wrapper(tx, queries[0], n, k)
    preds = cuda_knn.stripe_classify_arrays(xl_x, xl_y, test.features, k,
                                            train.num_classes)
    ri, plain = plain_predict(tx, ty, queries[0], n, k, train.num_classes)
    check_equal("classify_xl indices", torch, ki, ri)
    check_equal("classify_xl predictions", torch, torch.from_numpy(preds),
                plain.cpu())
    ms = cuda_ms(wrapper, [(tx, qb, n, k) for qb in queries], reps=12)
    plain_ms = cuda_ms(cuda_knn.knn_stripe_candidates_reference,
                       [(tx, qb, n, k) for qb in queries[:3]], reps=3)
    b_ms, b_by = stripe_bound_ms(q, n, d, k)
    print(f"xl {n}x{d}, {q} queries, k={k}: indices and predictions equal to "
          f"the plain version; scan+merge {ms} ms (median of 12, CUDA events), "
          f"plain {plain_ms} ms (median of 3), bound {b_ms} ms ({b_by})")

    plan = cuda_knn.stripe_split_plan(n, q, dev, d, k)
    partials = [scan(tx, qb, n, k, *plan) for qb in queries]
    check_equal("classify_xl scan keys", torch, partials[0],
                cuda_knn.knn_stripe_scan_reference(tx, queries[0], n, k, *plan))
    times = {
        "scan": cuda_ms(scan, [(tx, qb, n, k, *plan) for qb in queries],
                        reps=12),
        "merge": cuda_ms(merge, [(pb,) for pb in partials], reps=12),
    }
    plain_t = {
        "scan": cuda_ms(cuda_knn.knn_stripe_scan_reference,
                        [(tx, qb, n, k, *plan) for qb in queries[:3]], reps=3),
        "merge": cuda_ms(cuda_knn.knn_stripe_merge_reference,
                         [(pb,) for pb in partials], reps=12),
    }
    # The merge's library call: one torch.topk over a query's packed keys
    # gives its k best keys, sorted (the unpacking is a bit-cast).
    library = cuda_ms(lambda pb: torch.topk(
        pb.view(q, -1), k, dim=1, largest=False, sorted=True),
        [(pb,) for pb in partials], reps=12)
    bounds = {"scan": scan_bound_ms(q, n, d, k, plan[0]),
              "merge": merge_bound_ms(q, k, plan[0])}
    for name in ("scan", "merge"):
        print(f"xl {name} ({plan[0]} splits of {plan[1]} rows): "
              f"{times[name]} ms (median of 12), plain {plain_t[name]} ms, "
              f"bound {bounds[name][0]} ms ({bounds[name][1]})")
    print(f"xl merge library call (torch.topk on the packed keys): {library} "
          "ms; the scan has none: no single PyTorch call computes it with "
          "its (distance, index) tie rule")

    phase("classify_wide")
    wide = phase_classify_wide(torch, dev, tile_knn, cuda_knn, vote_neighbors)

    phase("classify_bigk")
    bigk = phase_classify_bigk(torch, dev, cuda_knn, tile_knn, vote_neighbors,
                               train_path, test_path)

    phase("classify_xla")
    phase_classify_xla(torch, dev, cuda_knn, tile_knn, vote_neighbors,
                       train_path, test_path)

    phase("models")
    phase_models(torch, dev, cuda_knn, tile_knn, train_path, test_path, xl_x,
                 xl_y)

    phase("cli_ladder")
    phase_cli_ladder(torch, cuda_knn, tile_knn, train_path, test_path, smi)

    phase("serve")
    srv = phase_serve(torch, cuda_knn, tile_knn, train_path, test_path, xl_x,
                      xl_y, smi)

    phase("ivf")
    phase_ivf(torch, cuda_knn, xl_x, xl_y, test.features, smi)

    phase("quality")
    phase_quality(torch, cuda_knn, train_path, test_path, xl_x, smi)

    phase("mutable")
    mut = phase_mutable(torch, cuda_knn, tile_knn, xl_x, xl_y, test.features,
                        train, smi)
    print(f"mutable: {json.dumps(mut)}")

    phase("probe_selection")
    sel = phase_probe_selection(torch, dev, cuda_knn)

    phase("probe_wide")
    p1 = phase_probe_wide(torch, dev, probe_matmul)

    phase("sharded")
    shd = phase_sharded(torch, cuda_knn, tile_knn, train_path, test_path,
                        xl_x, xl_y, test.features, srv["levels"], smi)
    print(f"sharded: {json.dumps(shd)}")

    phase("control")
    ctl = phase_control(torch, cuda_knn, tile_knn, test.features, smi)
    print(f"control: {json.dumps(ctl)}")

    phase("kernels")
    replaces = {"scan": "knn_tpu/ops/pallas_knn.py:279",
                "merge": "knn_tpu/ops/pallas_knn.py:105"}
    # exact: the tile-merge kernel; fast and bf16: the stripe kernel's
    # matmul forms, which the wide auto path takes (the tile-merge kernel's
    # are ported by the same entry).
    tile_replaces = {"exact": "knn_tpu/ops/pallas_knn.py:127",
                     "fast": "knn_tpu/ops/pallas_knn.py:279",
                     "bf16": "knn_tpu/ops/pallas_knn.py:279"}
    tile_entries = [{
        "name": f"tile_knn_{form}",
        "route": "cuda",
        "source": "knn_tpu_torch/csrc/tile_knn.cu",
        "replaces": tile_replaces[form],
        "launches": wide["launches"][form],
        "max_abs_err": tile_err[form],
        "ms": wide["ms"][form],
        "plain_ms": wide["plain_ms"][form],
        "bound_ms": wide["bound"][form][0],
        "bound_by": wide["bound"][form][1],
        "library_ms": None,
        "matmul_ms": wide["matmul_ms"]["bfloat16" if form == "bf16"
                                       else "float32"],
        "shape": wide["shape"][form],
    } for form in tile_knn.FORMS]
    extra_entries = [{
        "name": f"stripe_knn_select_{mode}",
        "route": "cuda",
        "source": "knn_tpu_torch/csrc/stripe_knn.cu",
        "replaces": "scripts/tune_stripe_selection.py:44",
        "launches": sel["launches"][mode],
        "max_abs_err": max(select_err[mode], sel["max_abs_err"][mode]),
        "ms": sel["ms"][mode],
        "plain_ms": sel["plain_ms"][mode],
        "bound_ms": sel["bound"][0],
        "bound_by": sel["bound"][1],
        "library_ms": None,
        "shape": sel["shape"],
    } for mode in cuda_knn.SELECT_MODES] + [{
        "name": "probe_matmul",
        "route": "cuda",
        "source": "knn_tpu_torch/csrc/probe_matmul.cu",
        "replaces": "scripts/probe_mnist_r3.py:43",
        "launches": p1["launches"],
        "max_abs_err": max(matmul_err, p1["max_abs_err"]),
        "ms": p1["ms"],
        "plain_ms": p1["plain_ms"],
        "bound_ms": p1["bound"][0],
        "bound_by": p1["bound"][1],
        "library_ms": p1["library_ms"],
        "shape": p1["shape"],
    }] + [{
        "name": f"{name}_k{k}",
        "route": "cuda",
        "source": f"knn_tpu_torch/csrc/{src}",
        "replaces": rep,
        "launches": bigk["launches"][k][key],
        "max_abs_err": bigk_err[key],
        "ms": bigk["ms"][k][part],
        "plain_ms": bigk["plain_ms"][k][part],
        "bound_ms": bigk["bound"][k][part][0],
        "bound_by": bigk["bound"][k][part][1],
        "library_ms": bigk["library_ms"][k] if part == "merge" else None,
        "shape": bigk["shape"][k],
    } for k in BIGK_TIMED for name, src, rep, key, part in (
        ("tile_knn_exact", "tile_knn.cu", "knn_tpu/ops/pallas_knn.py:127",
         "exact", "scan"),
        ("stripe_knn_merge", "stripe_knn.cu",
         "knn_tpu/ops/pallas_knn.py:105", "merge", "merge"))] + [{
        "name": f"tile_knn_bf16_k{k}",
        "route": "cuda",
        "source": "knn_tpu_torch/csrc/tile_knn.cu",
        "replaces": "knn_tpu/ops/pallas_knn.py:127",
        "launches": e["launches"]["bf16"],
        "max_abs_err": max(bigk_err["bf16"], e["max_abs_err"]),
        "ms": e["ms"],
        "plain_ms": e["plain_ms"],
        "bound_ms": e["bound"][0],
        "bound_by": e["bound"][1],
        "library_ms": None,
        "shape": e["shape"],
    } for k, e in bigk["bf16"].items()]
    print(json.dumps({"kernels": [{
        "name": f"stripe_knn_{name}",
        "route": "cuda",
        "source": "knn_tpu_torch/csrc/stripe_knn.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": err[name],
        "ms": times[name],
        "plain_ms": plain_t[name],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "library_ms": library if name == "merge" else None,
        "shape": f"q={q} n={n} d={d} k={k} splits={plan[0]}",
    } for name in ("scan", "merge")] + tile_entries + extra_entries}))
    print(f"script wall {time.perf_counter() - t_script:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
