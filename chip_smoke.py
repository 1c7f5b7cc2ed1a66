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
                        k = 32 (the tiled scan) in the euclidean and cosine
                        metrics, ``--engine xla`` at k = 5; predictions against the
                        oracle and ``cuda-tile``; the route timed beside
                        ``cuda-tile``.
13. ``probe_selection`` — P2's entry point
                        (``knn_tpu_torch.probes.tune_stripe_selection``) on
                        the large shape, counters read around it; each
                        selection's kernel, at that shape's layout, held
                        bit-equal to its plain version and timed beside it.
14. ``probe_wide``    — P1's entry point (``knn_tpu_torch.probes.
                        probe_mnist_r3``) at 65,536 x 784 with 2,048 queries,
                        the counter read around it; P1 held to its plain
                        version at block_n 8, 256 and 1,024, and timed
                        beside it and the library's bfloat16 matmul with
                        float32 output.
15. ``kernels``       — one JSON line describing every kernel.

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


def tiled_large(x: np.ndarray, y: np.ndarray, reps: int):
    """The xl train set (bench.py::_tiled_large): ``x`` tiled ``reps`` times
    with 1e-3 float32 noise so the copies are not duplicates."""
    rng = np.random.default_rng(0)
    feats = np.tile(x, (reps, 1))
    feats += 1e-3 * rng.standard_normal(feats.shape, dtype=np.float32)
    return feats, np.tile(y, reps)


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
    kernel) on the large shape: ``cli.run`` at k = 32 (the tiled scan:
    1,718 x 30,803 cells are past the 16 Mi full-matrix limit), with
    ``--metric cosine``, and with ``--engine xla`` at k = 5, the kernels'
    counters read around each (they stay 0). Predictions against the
    oracle's (cosine: equal wherever the neighbor lists agree, the lists
    differing only at near ties) and ``cuda-tile``'s; the route's device
    time beside ``cuda-tile``'s on the same problem (CUDA events)."""
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

    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    n, d, q = train.num_instances, train.num_features, test.num_instances
    res = {"lines": {}}
    for name, k, flags in (("k32", 32, []), ("cosine", 32, ["--metric", "cosine"]),
                           ("engine-xla", 5, ["--engine", "xla"])):
        for c in counters:
            c.launches = 0
        for form in tile_scan.launches:
            tile_scan.launches[form] = 0
        out = io.StringIO()
        rc = cli.run([str(train_path), str(test_path), str(k), "--backend",
                      "cuda", *flags, "--warmup", "--json"], stdout=out)
        if rc != 0:
            raise SystemExit(f"classify_xla {name}: cli.run exited {rc}")
        line, js = out.getvalue().splitlines()
        print(line)
        print(js)
        if launched():
            raise SystemExit(f"classify_xla {name}: a hand kernel launched on "
                             "the XLA route")
        res["lines"][name] = line
        metric = "cosine" if name == "cosine" else "euclidean"
        preds = get_backend("cuda")(train, test, k, metric=metric,
                                    engine="xla" if name == "engine-xla"
                                    else "auto")
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
    print(f"XLA route (forward_tiled_core, query_tile 256, train_tile "
          f"{tile_rows}; torch ops, no hand kernel) at {res['shape']}: "
          f"{res['ms']} ms (median of 6, CUDA events); cuda-tile (tile scan, "
          f"merge, vote) {res['tile_ms']} ms; result lines "
          f"{[_ms_of(x) for x in res['lines'].values()]} ms "
          f"(k32, cosine, engine-xla)")
    return res


def _ms_of(line: str) -> int:
    """The ms field of a result line."""
    return int(line.split(" required ")[1].split(" ms")[0])


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
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cuda_knn.split_plan(n, q, sm_count)
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
    print(f"at the shipped plan ({plan[0]} splits of {plan[1]} rows, each "
          f"{plan[1] // cuda_knn._TILE_ROWS} tiles): insert and every "
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


def main() -> int:
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
          f"{cuda_knn.split_plan(n, q, sm_count)[0]} splits: "
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

    plan = cuda_knn.split_plan(n, q, sm_count)
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

    phase("probe_selection")
    sel = phase_probe_selection(torch, dev, cuda_knn)

    phase("probe_wide")
    p1 = phase_probe_wide(torch, dev, probe_matmul)

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
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
