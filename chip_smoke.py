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
4. ``kernel_parity_tile`` — the tile kernel in its three forms against its
                        plain version: bit-equal keys on integer grids (and
                        in the exact form on float rows), the stated
                        tolerance on float rows in the matmul forms.
5. ``kernel_parity_select`` — the stripe scan's selection variants (rounds,
                        lite, nosel) against their plain versions, bit-equal
                        keys, at split_plan's layout and at splits of
                        several 64-row tiles; rounds and lite merged,
                        bit-equal to the shipped knn_stripe_candidates.
6. ``kernel_parity_matmul`` — the bf16 tensor-core matmul (P1) against its
                        plain version: bit-equal on integer grids, the
                        stated bound on float rows.
7. ``kernel_parity_bigk`` — the stripe scan, the merge and the tile scan at
                        k in (17, 32, 100, 256) against their plain versions.
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
                        plain version and the oracle; scan and merge timed
                        at k = 32 and 256.
12. ``probe_selection`` — P2's entry point
                        (``knn_tpu_torch.probes.tune_stripe_selection``) on
                        the large shape, counters read around it; each
                        selection's kernel, at that shape's layout, held
                        bit-equal to its plain version and timed beside it.
13. ``probe_wide``    — P1's entry point (``knn_tpu_torch.probes.
                        probe_mnist_r3``) at 65,536 x 784 with 2,048 queries,
                        the counter read around it; P1 timed beside its
                        plain version and the library's bfloat16 matmul with
                        float32 output.
14. ``kernels``       — one JSON line describing every kernel.

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
    """The merge: the [Q, splits, k] keys read once, [Q, k] float32
    distances and int32 indices written once; at least one compare per
    (query, split) list."""
    return bound_ms(q * splits, q * splits * k * 8 + q * k * 8)


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


def tile_parity_cases(rng):
    """(name, form, train, queries, n_valid, k) for each form x d in {1, 11,
    128, 129, 784, 1000} x k in {1, 5, 16}: an integer grid with duplicated
    rows, NaN rows and n_valid < N, and float rows. The bf16 form takes a
    float32 train up to 128 features and a bfloat16 one above (the stripe
    route's store), so both of its kernel variants run."""
    for form in ("exact", "fast", "bf16"):
        for d in (1, 11, 128, 129, 784, 1000):
            for k in (1, 5, 16):
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
    """Returns the largest |kernel - plain| distance per form."""
    rng = np.random.default_rng(1)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    err = dict.fromkeys(tile_knn.FORMS, 0.0)
    n_cases = swaps = 0
    for name, form, tx, qx, n_valid, k in tile_parity_cases(rng):
        t = torch.from_numpy(tx).to(dev)
        if form == "bf16" and tx.shape[1] > 128:
            t = t.to(torch.bfloat16)
        qt = torch.from_numpy(qx).to(dev)
        plan = cuda_knn.split_plan(n_valid, qt.shape[0], sm_count,
                                   tile_rows=tile_knn._TILE_ROWS,
                                   blocks_per_sm=tile_knn._BLOCKS_PER_SM)
        partial = tile_knn.knn_tile_scan(t, qt, n_valid, k, form, *plan)
        want = tile_knn.knn_tile_scan_reference(t, qt, n_valid, k, form, *plan)
        kd, ki = tile_knn.knn_tile_candidates(t, qt, n_valid, k, form)
        rd, ri = tile_knn.knn_tile_candidates_reference(t, qt, n_valid, k, form)
        if "grid" in name or form == "exact":
            check_equal(f"kernel_parity_tile {name} scan keys", torch,
                        partial, want)
            check_equal(f"kernel_parity_tile {name} indices", torch, ki, ri)
            check_equal(f"kernel_parity_tile {name} distances", torch, kd, rd)
        else:
            swaps += check_near(f"kernel_parity_tile {name}", torch, form,
                                t, qt, kd, ki, rd, ri)
        err[form] = max(err[form], max_err(torch, kd, rd))
        n_cases += 1
    print(f"{n_cases} cases: integer grids (all forms) and float rows (exact "
          "form) bit-equal keys, indices and distances; float rows in the "
          "fast and bf16 forms within atol = 4*(d+2)*2^-24*(q2 + max t2), "
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
    plan = cuda_knn.split_plan(n, q, sm_count, tile_rows=tile_knn._TILE_ROWS,
                               blocks_per_sm=tile_knn._BLOCKS_PER_SM)
    queries = [qx.clone() for _ in range(12)]
    res = {"launches": launches, "ms": {}, "plain_ms": {}, "bound": {},
           "shape": f"q={q} n={n} d={d} k={k} splits={plan[0]}"}
    for form in tile_knn.FORMS:
        t = stored[form]
        res["ms"][form] = cuda_ms(scan, [(t, qb, n, k, form, *plan)
                                                for qb in queries], reps=12)
        res["plain_ms"][form] = cuda_ms(
            tile_knn.knn_tile_scan_reference,
            [(t, qb, n, k, form, *plan) for qb in queries[:3]], reps=3)
        both = cuda_ms(tile_knn.knn_tile_candidates,
                       [(t, qb, n, k, form) for qb in queries], reps=12)
        res["bound"][form] = tile_bound_ms(form, q, n, d, k, plan[0],
                                           t.element_size())
        print(f"wide {form} ({plan[0]} splits of {plan[1]} rows): tile scan "
              f"{res['ms'][form]} ms (median of 12, CUDA events), scan+merge "
              f"{both} ms, plain {res['plain_ms'][form]} ms (median of 3), "
              f"bound {res['bound'][form][0]} ms ({res['bound'][form][1]})")
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
    cases = ((700, 100, 128, 200), (1000, 37, 8, 300), (3001, 129, 256, 77),
             (8192, 784, 1024, 512))
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


def phase_kernel_parity_bigk(torch, dev, cuda_knn, tile_knn) -> dict:
    """The bucketed lists (16 < k <= 256): the stripe scan and merge, and
    the tile scan in its three forms, against their plain versions on an
    integer grid (duplicated rows, NaN rows, n_valid < N) and on float rows:
    bit-equal keys, except the tile scan's fast and bf16 forms on float
    rows, held by check_near after the merge. Returns the largest
    |kernel - plain| distance per kernel."""
    rng = np.random.default_rng(4)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    err = {"scan": 0.0, "merge": 0.0, **dict.fromkeys(tile_knn.FORMS, 0.0)}
    n_cases = swaps = 0
    n, q = 3001, 300
    for k in (17, 32, 100, 256):
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
                name = f"{kind} d={d} k={k}"
                t = torch.from_numpy(tx).to(dev)
                qt = torch.from_numpy(qx).to(dev)
                for plan in ([cuda_knn.split_plan(n_valid, q, sm_count),
                              *forced_plans(n_valid)] if d <= 128 else []):
                    partial = cuda_knn.knn_stripe_scan(t, qt, n_valid, k, *plan)
                    want = cuda_knn.knn_stripe_scan_reference(t, qt, n_valid,
                                                              k, *plan)
                    check_equal(f"kernel_parity_bigk {name} plan={plan} "
                                "stripe scan keys", torch, partial, want)
                    err["scan"] = max(err["scan"], max_err(torch, *(
                        cuda_knn._unpack_keys(x)[0] for x in (partial, want))))
                    n_cases += 1
                plan = cuda_knn.split_plan(n_valid, q, sm_count,
                                           tile_rows=tile_knn._TILE_ROWS,
                                           blocks_per_sm=tile_knn._BLOCKS_PER_SM)
                for form in tile_knn.FORMS:
                    tt = t.to(torch.bfloat16) if form == "bf16" and d > 128 else t
                    partial = tile_knn.knn_tile_scan(tt, qt, n_valid, k, form,
                                                     *plan)
                    want = tile_knn.knn_tile_scan_reference(tt, qt, n_valid, k,
                                                            form, *plan)
                    md, mi = cuda_knn.knn_stripe_merge(partial)
                    rd, ri = cuda_knn.knn_stripe_merge_reference(partial)
                    check_equal(f"kernel_parity_bigk {name} merge indices",
                                torch, mi, ri)
                    check_equal(f"kernel_parity_bigk {name} merge distances",
                                torch, md, rd)
                    err["merge"] = max(err["merge"], max_err(torch, md, rd))
                    wd, wi = cuda_knn.knn_stripe_merge_reference(want)
                    if kind == "grid" or form == "exact":
                        check_equal(f"kernel_parity_bigk {name} {form} tile "
                                    "scan keys", torch, partial, want)
                    else:
                        swaps += check_near(f"kernel_parity_bigk {name} {form}",
                                            torch, form, tt, qt, md, mi, wd, wi)
                    err[form] = max(err[form], max_err(torch, md, wd))
                    n_cases += 1
    print(f"{n_cases} cases at k in (17, 32, 100, 256): stripe scan (at the "
          "split_plan, 256- and 200-row layouts), merge and "
          "tile scan (all forms on integer grids, exact on float rows) "
          "bit-equal to the plain versions; fast and bf16 on float rows within "
          f"the tile tolerance, {swaps} near-tie index swaps; max_abs_err {err}")
    return err


def phase_classify_bigk(torch, dev, cuda_knn, tile_knn, vote_neighbors,
                        train_path, test_path) -> dict:
    """``cli.run --backend cuda-tile`` at k = 32 on the large shape (the
    merge route: k > 16 leaves the stripe route, as in predict_pallas),
    with the counters read around it; predictions against the plain
    version and the oracle; the tile scan and merge timed at k = 32 and
    k = 256. Returns launches, times and bounds."""
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
    launches = {"exact": scan.launches["exact"], "merge": merge.launches}
    if rc != 0:
        raise SystemExit(f"classify_bigk: cli.run exited {rc}")
    line, js = out.getvalue().splitlines()
    print(line)
    print(js)
    print(f"launches on the path: {launches} (--warmup run + timed run), all "
          f"tile forms {dict(scan.launches)}")
    if min(launches.values()) < 1:
        raise SystemExit(f"classify_bigk: a kernel was never launched: {launches}")
    train, test = load_arff(str(train_path)), load_arff(str(test_path))
    n, d, q = train.num_instances, train.num_features, test.num_instances
    tx = torch.from_numpy(train.features.copy()).to(dev)
    ty = torch.from_numpy(train.labels.copy()).to(dev)
    qx = torch.from_numpy(test.features.copy()).to(dev)
    res = {"launches": launches, "ms": {}, "plain_ms": {}, "bound": {},
           "library_ms": {}, "shape": {}}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cuda_knn.split_plan(n, q, sm_count, tile_rows=tile_knn._TILE_ROWS,
                               blocks_per_sm=tile_knn._BLOCKS_PER_SM)
    queries = [qx.clone() for _ in range(12)]
    for k in (32, 256):
        reset()
        preds = get_backend("cuda-tile")(train, test, k)
        if k == 256:
            res["launches_256"] = {"exact": scan.launches["exact"],
                                   "merge": merge.launches}
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
        res["library_ms"][k] = cuda_ms(lambda pb: torch.topk(
            pb.view(q, -1), k, dim=1, largest=False, sorted=True),
            [(pb,) for pb in partials], reps=12)
        res["bound"][k] = {"scan": tile_bound_ms("exact", q, n, d, k, plan[0], 4),
                           "merge": merge_bound_ms(q, k, plan[0])}
        res["shape"][k] = f"q={q} n={n} d={d} k={k} splits={plan[0]}"
        print(f"k={k}: predictions equal to the plain version's and, on 128 "
              f"queries, the oracle's; keys, indices and distances bit-equal. "
              f"Tile scan (exact, {plan[0]} splits of {plan[1]} rows) "
              f"{res['ms'][k]['scan']} ms, plain {res['plain_ms'][k]['scan']} "
              f"ms, bound {res['bound'][k]['scan'][0]} ms "
              f"({res['bound'][k]['scan'][1]}); merge {res['ms'][k]['merge']} "
              f"ms, plain {res['plain_ms'][k]['merge']} ms, torch.topk on the "
              f"keys {res['library_ms'][k]} ms, bound "
              f"{res['bound'][k]['merge'][0]} ms ({res['bound'][k]['merge'][1]})")
    print(f"launches of one get_backend('cuda-tile') call at k=256: "
          f"{res['launches_256']}")
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

    res = {"launches": launches, "max_abs_err": err,
           "ms": cuda_ms(pm, [(txb, qb, block_n) for qb in bufs], reps=12),
           "plain_ms": cuda_ms(probe_matmul.pure_matmul_reference,
                               [(txb, qb, block_n) for qb in bufs[:3]], reps=3),
           "library_ms": cuda_ms(library, [(qb,) for qb in bufs], reps=12),
           "bound": matmul_bound_ms(q, n, d),
           "shape": f"q={q} n={n} d={d} block_n={block_n}"}
    print(f"P1 at {res['shape']}: {res['ms']} ms (median of 12, CUDA events), "
          f"plain {res['plain_ms']} ms (median of 3), library call "
          f"(torch.mm bf16, float32 out, + reshape-sum) {res['library_ms']} "
          "ms, bound "
          f"{res['bound'][0]} ms ({res['bound'][1]}); max |kernel - plain| "
          f"{err} within atol = 2*(D+m)*2^-23*S")
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
        "shape": wide["shape"],
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
        "name": name,
        "route": "cuda",
        "source": f"knn_tpu_torch/csrc/{src}",
        "replaces": rep,
        "launches": bigk["launches"][key],
        "max_abs_err": bigk_err[key if key == "merge" else "exact"],
        "ms": bigk["ms"][32][part],
        "plain_ms": bigk["plain_ms"][32][part],
        "bound_ms": bigk["bound"][32][part][0],
        "bound_by": bigk["bound"][32][part][1],
        "library_ms": bigk["library_ms"][32] if part == "merge" else None,
        "shape": bigk["shape"][32],
    } for name, src, rep, key, part in (
        ("tile_knn_exact_k32", "tile_knn.cu", "knn_tpu/ops/pallas_knn.py:127",
         "exact", "scan"),
        ("stripe_knn_merge_k32", "stripe_knn.cu",
         "knn_tpu/ops/pallas_knn.py:105", "merge", "merge"))]
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
