"""The tile kernel's plain version and the ``cuda-tile`` backend against the
JAX package's wide-feature rung.

On CPU tensors ``knn_tile_candidates`` runs ``knn_tile_candidates_
reference``. It is held against ``knn_tpu``'s two Pallas kernels in
interpret mode, at the small blocks of tests/test_pallas.py: the tile-merge
kernel ``knn_pallas_candidates`` (exact, fast, bf16; a bf16 train stored as
bfloat16, as ``predict_pallas`` stores it) and the matmul forms of the stripe
kernel ``knn_pallas_stripe_candidates`` (a bf16 train stored as bfloat16
only past 128 features, as ``_cached_stripe_train`` does). ``predict_tile``
is held against ``predict_pallas`` route by route, and the port's CLI
against the JAX CLI.

Each JAX kernel runs once per (route, form, d, data) at k = 16; a smaller
k is compared with the prefix of that answer, which is sorted by
(distance, index).

Tolerances. On integer grids every distance of every form is exact in
float32 (the bf16 rounding too), so distances are bit-equal and indices
equal. On float data the exact form differs by the product roundings that
XLA:CPU contracts into FMAs: ``rtol = d * 2**-24``. The matmul forms sum the
norms and the cross term in other orders than XLA:CPU; each of the two sides
is off the exact value of its formula by at most ``(d + 2) * 2**-24 *
(q2 + t2)``, so the two differ by at most twice that: ``atol = 4 * (d + 2)
* 2**-24 * (q2 + max t2)`` per query. Indices are equal, except that two
candidates whose float64 distances lie within that bound may swap.
"""

import functools
import io
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from knn_tpu import cli as jcli  # noqa: E402
from knn_tpu.ops import pallas_knn  # noqa: E402
from knn_tpu.utils.padding import pad_axis_to_multiple  # noqa: E402
from knn_tpu_torch import cli  # noqa: E402
from knn_tpu_torch.backends import get_backend  # noqa: E402
from knn_tpu_torch.data.arff import load_arff  # noqa: E402
from knn_tpu_torch.ops import cuda_knn, tile_knn  # noqa: E402
from knn_tpu_torch.ops.distance import (  # noqa: E402
    pairwise_sq_dists_bf16,
    pairwise_sq_dists_dot,
)

INT_MAX = np.iinfo(np.int32).max
N, Q = 300, 13  # N is not a multiple of 128
FORMS = ("exact", "fast", "bf16")
DS = (7, 64, 129, 300, 784)
KS = (1, 5, 16)


def problem(kind, d, seed):
    """(train, test) float32: an integer grid with duplicated rows (dist == 0
    ties straddling 128-row tiles) and queries that repeat train rows, or
    standard normal floats."""
    rng = np.random.default_rng(seed)
    if kind == "float":
        return (rng.standard_normal((N, d)).astype(np.float32),
                rng.standard_normal((Q, d)).astype(np.float32))
    train = rng.integers(0, 3, (N, d)).astype(np.float32)
    train[150:200] = train[:50]
    test = np.concatenate([train[rng.choice(N, Q // 2, replace=False)],
                           rng.integers(0, 3, (Q - Q // 2, d)).astype(np.float32)])
    return train, test


def merge_store(form):
    return jnp.bfloat16 if form == "bf16" else jnp.float32


def stripe_store(form, d):
    return jnp.bfloat16 if form == "bf16" and d > 128 else jnp.float32


def jax_merge(train, test, n_valid, k, form, block_q=8, block_n=128):
    """``knn_pallas_candidates`` interpreted, features padded to 128 lanes
    and the train stored as ``predict_pallas`` stores it."""
    tx, _ = pad_axis_to_multiple(train, block_n, axis=0)
    tx, _ = pad_axis_to_multiple(tx, 128, axis=1)
    qx, _ = pad_axis_to_multiple(test, block_q, axis=0)
    qx, _ = pad_axis_to_multiple(qx, 128, axis=1)
    dist, idx = pallas_knn.knn_pallas_candidates(
        jnp.asarray(tx, merge_store(form)), jnp.asarray(qx), n_valid, k,
        block_q=block_q, block_n=block_n, interpret=True,
        d_true=train.shape[1], precision=form,
    )
    q = test.shape[0]
    return np.asarray(dist)[:q], np.asarray(idx)[:q]


def jax_stripe(train, test, n_valid, k, form, block_q=8, block_n=128):
    """``knn_pallas_stripe_candidates`` interpreted, in a matmul form, the
    train stored as ``_cached_stripe_train`` stores it."""
    d = train.shape[1]
    txT, d_pad = pallas_knn.stripe_prepare_train(train, block_n)
    qx = pallas_knn.stripe_prepare_queries(test, block_q, d_pad)
    dist, idx = pallas_knn.knn_pallas_stripe_candidates(
        jnp.asarray(txT, stripe_store(form, d)), jnp.asarray(qx), n_valid, k,
        block_q=block_q, block_n=block_n, interpret=True, d_true=d,
        precision=form,
    )
    q = test.shape[0]
    return np.asarray(dist)[:q], np.asarray(idx)[:q]


@functools.lru_cache(maxsize=None)
def jax_answer(route, form, d, kind):
    train, test = problem(kind, d, seed=d * 7 + FORMS.index(form))
    run = jax_merge if route == "merge" else jax_stripe
    return run(train, test, N, 16, form)


def port(train, test, n_valid, k, form, dtype):
    dist, idx = tile_knn.knn_tile_candidates(
        torch.from_numpy(train).to(dtype), torch.from_numpy(test), n_valid, k,
        form)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    return dist.numpy(), idx.numpy()


def dist64(train, test, form, dtype):
    """[Q, N] float64 values of the form's formula on its operands: the
    train as stored, the bf16 cross term from rounded operands."""
    t = torch.from_numpy(train).to(dtype).double()
    q = torch.from_numpy(test).double()
    if form == "bf16":
        cross = (torch.from_numpy(test).to(torch.bfloat16).double()
                 @ t.to(torch.bfloat16).double().T)
        return ((q * q).sum(1)[:, None] + (t * t).sum(1)[None, :]
                - 2 * cross).numpy()
    return ((q[:, None, :] - t[None, :, :]) ** 2).sum(-1).numpy()


def assert_agree(train, test, form, dtype, d_got, i_got, d_want, i_want):
    """Bit-equal on integer grids is checked by the caller; here the float
    tolerance of the module docstring, and index swaps only at near ties."""
    d = train.shape[1]
    exact = dist64(train, test, form, dtype)
    if form == "exact":
        rel = d * 2.0**-24
        np.testing.assert_allclose(d_got, d_want, rtol=rel, atol=0)
        tol = 2 * rel * np.maximum(exact.max(axis=1), 1e-30)
    else:
        t = torch.from_numpy(train).to(dtype).double()
        scale = (test.astype(np.float64) ** 2).sum(1) + float((t * t).sum(1).max())
        tol = 4 * (d + 2) * 2.0**-24 * scale
        assert (np.abs(d_got - d_want) <= tol[:, None]).all()
    for r, c in zip(*np.nonzero(i_got != i_want)):
        a, b = i_got[r, c], i_want[r, c]
        assert abs(exact[r, a] - exact[r, b]) <= 2 * tol[r], (r, c, a, b)


def check(route, form, d, k, kind):
    dtype = torch.bfloat16 if (
        merge_store(form) if route == "merge" else stripe_store(form, d)
    ) == jnp.bfloat16 else torch.float32
    train, test = problem(kind, d, seed=d * 7 + FORMS.index(form))
    d_want, i_want = (a[:, :k] for a in jax_answer(route, form, d, kind))
    d_got, i_got = port(train, test, N, k, form, dtype)
    if kind == "grid":
        np.testing.assert_array_equal(i_got, i_want)
        assert d_got.tobytes() == d_want.tobytes()
    else:
        assert_agree(train, test, form, dtype, d_got, i_got, d_want, i_want)


@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("form", FORMS)
def test_plain_version_matches_the_merge_kernel(form, d, k, kind):
    check("merge", form, d, k, kind)


@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("form", ["fast", "bf16"])
def test_plain_version_matches_the_stripe_matmul_forms(form, d, k, kind):
    # bf16 at d = 7 and 64 keeps a float32 train (unrounded norms); at
    # d >= 129 the train is stored as bfloat16.
    check("stripe", form, d, k, kind)


@pytest.mark.parametrize("route", ["merge", "stripe"])
@pytest.mark.parametrize("form", ["fast", "bf16"])
@pytest.mark.parametrize("k", KS)
def test_nan_rows_in_the_matmul_forms(route, form, k):
    # NaN rows are (+inf, their own index) and beat the rows past n_valid,
    # which are (+inf, INT32_MAX); a NaN query sees every row at +inf. The
    # clamp at 0 must not turn NaN into 0.
    rng = np.random.default_rng(k)
    train = rng.integers(0, 3, (N, 9)).astype(np.float32)
    train[rng.choice(N, 40, replace=False), 3] = np.nan
    test = rng.integers(0, 3, (Q, 9)).astype(np.float32)
    test[0, 0] = np.nan
    few = train[:20].copy()
    few[3:, 1] = np.nan  # 3 finite rows
    dtype = torch.bfloat16 if route == "merge" and form == "bf16" else torch.float32
    run = jax_merge if route == "merge" else jax_stripe
    for tr, n_valid in ((train, N - 45), (few, 20)):
        d_got, i_got = port(tr, test, n_valid, k, form, dtype)
        d_want, i_want = run(tr, test, n_valid, k, form)
        np.testing.assert_array_equal(i_got, i_want)
        assert d_got.tobytes() == d_want.tobytes()
    np.testing.assert_array_equal(i_got[0], np.arange(k))
    assert np.isinf(d_got[0]).all()
    finite = np.flatnonzero(~np.isnan(few).any(axis=1))
    m = min(k, finite.size)  # the finite rows come first, then the NaN rows
    assert set(i_got[1, :m]) <= set(finite) and np.isfinite(d_got[1, :m]).all()
    assert np.isinf(d_got[1, m:]).all() and (i_got[1, m:] < 20).all()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k", KS + (17, 100, 257, 1000, N))
def test_tile_scan_then_merge_equals_the_whole_scan(form, k):
    # The kernel's two steps, as their wrappers run them on CPU tensors:
    # per-split lists hold only their own rows, and the stripe merge of them
    # gives what one plain scan over all rows gives.
    train, test = problem("grid", 150, seed=k)
    train[::17, 4] = np.nan
    t = torch.from_numpy(train).to(
        torch.bfloat16 if form == "bf16" else torch.float32)
    q = torch.from_numpy(test)
    partial = tile_knn.knn_tile_scan(t, q, N - 20, k, form, 3, 128)
    assert partial.shape == (Q, 3, k) and partial.dtype == torch.int64
    idx = (partial & 0xFFFFFFFF).numpy()
    for s in range(3):
        own = idx[:, s]
        assert ((own == INT_MAX) | ((own >= 128 * s)
                                    & (own < min(128 * (s + 1), N - 20)))).all()
    d_got, i_got = cuda_knn.knn_stripe_merge(partial)
    d_want, i_want = tile_knn.knn_tile_candidates_reference(t, q, N - 20, k, form)
    assert torch.equal(i_got, i_want)
    assert d_got.numpy().tobytes() == d_want.numpy().tobytes()


@pytest.mark.parametrize("n_valid", [1, 3001, 30_803, 1_016_499])
@pytest.mark.parametrize("k", [5, 16, 17, 256, 1000, 40_000])
def test_tile_split_plan_makes_splits_of_2k_rows(n_valid, k):
    # Whole 128-row tiles that cover every row; past k = 16 a split holds
    # at least 2k rows where there are that many; the merge takes the count.
    n_splits, rows = tile_knn.tile_split_plan(n_valid, 1718, 132, k)
    assert rows % 128 == 0 and 1 <= n_splits <= cuda_knn.MERGE_MAX_SPLITS
    assert n_splits * rows >= n_valid > (n_splits - 1) * rows
    if k > 16:
        assert rows >= 2 * k or n_splits == 1


def test_matmul_forms_follow_the_jax_formulas():
    # The plain distances of the two matmul forms against knn_tpu's XLA
    # functions on an integer grid (exact) and on floats (the tolerance).
    from knn_tpu.ops import distance as jdistance

    for kind in ("grid", "float"):
        train, test = problem(kind, 129, seed=3)
        train[5, 2] = np.nan
        for port_fn, jax_fn in (
                (pairwise_sq_dists_dot, jdistance.pairwise_sq_dists_dot),
                (pairwise_sq_dists_bf16, jdistance.pairwise_sq_dists_bf16)):
            got = port_fn(torch.from_numpy(test), torch.from_numpy(train)).numpy()
            want = np.asarray(jax_fn(jnp.asarray(test), jnp.asarray(train)))
            assert np.isinf(got[:, 5]).all() and np.isinf(want[:, 5]).all()
            if kind == "grid":
                assert got.tobytes() == want.tobytes()
            else:
                scale = (test**2).sum(1)[:, None] + np.nanmax((train**2).sum(1))
                rows = np.arange(N) != 5
                assert (np.abs(got[:, rows] - want[:, rows])
                        <= 4 * (129 + 2) * 2.0**-24 * scale).all()


@pytest.mark.parametrize("precision", ["exact", "fast", "bf16", "auto"])
def test_stripe_route_ok_and_precision_match_jax(precision):
    for d in (1, 7, 64, 127, 128, 129, 200, 784, 1000, 4096, 16_000):
        form = cuda_knn._resolve_stripe_precision(precision, d)
        assert form == pallas_knn._resolve_stripe_precision(precision, d)
        for k in (1, 5, 16, 17):
            assert cuda_knn.stripe_route_ok(form, d, k) == \
                pallas_knn.stripe_route_ok(form, d, k), (form, d, k)


def labelled(d, seed=4):
    rng = np.random.default_rng(seed)
    train = rng.integers(0, 4, (260, d)).astype(np.float32)
    train[100:140] = train[:40]
    labels = rng.integers(0, 6, 260).astype(np.int32)
    test = np.concatenate([train[rng.choice(260, 12, replace=False)],
                           rng.integers(0, 4, (12, d)).astype(np.float32)])
    return train, labels, test


@pytest.mark.parametrize("engine", ["auto", "stripe", "merge"])
@pytest.mark.parametrize("precision", ["exact", "fast", "bf16", "auto"])
def test_predict_tile_matches_predict_pallas(precision, engine):
    train, labels, test = labelled(200)
    want = pallas_knn.predict_pallas(
        train, labels, test, 5, 6, block_q=8, block_n=128, interpret=True,
        precision=precision, engine=engine)
    got = tile_knn.predict_tile(train, labels, test, 5, 6, precision=precision,
                                engine=engine, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("precision", ["exact", "fast", "bf16", "auto"])
def test_predict_tile_narrow_matches_predict_pallas(precision):
    train, labels, test = labelled(9)
    want = pallas_knn.predict_pallas(
        train, labels, test, 16, 6, block_q=8, block_n=128, interpret=True,
        precision=precision)
    got = tile_knn.predict_tile(train, labels, test, 16, 6,
                                precision=precision, device="cpu")
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def pallas_big_k(d, k):
    """``predict_pallas`` interpreted at k > 16 (its merge route, which
    takes any k): (want, oracle) predictions."""
    from knn_tpu.backends.oracle import knn_oracle

    train, labels, test = labelled(d)
    want = pallas_knn.predict_pallas(
        train, labels, test, k, 6, block_q=8, block_n=128, interpret=True,
        precision="exact")
    return want, knn_oracle(train, labels, test, k, 6)


@pytest.mark.parametrize("engine", ["auto", "merge", "stripe"])
@pytest.mark.parametrize("k", [17, 32, 100, 256])
@pytest.mark.parametrize("d", [9, 200])
def test_predict_tile_big_k_matches_predict_pallas(d, k, engine):
    # auto sends k > 16 to the merge route, as predict_pallas does; a forced
    # stripe route runs the stripe kernel (d = 9) or the tile kernel's exact
    # form (d = 200) with bucketed lists. All compute the same function.
    train, labels, test = labelled(d)
    want, oracle = pallas_big_k(d, k)
    np.testing.assert_array_equal(want, oracle)
    got = tile_knn.predict_tile(train, labels, test, k, 6, precision="exact",
                                engine=engine, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_cli_medium_k20_matches_jax_tpu_pallas():
    # The JAX tile-merge kernel takes any k: at k = 20 the port's cuda-tile
    # prints the line of tpu-pallas (it raised for k > 16 before).
    from tests import fixtures

    d = fixtures.datasets_dir()
    tr, te = str(d / "medium-train.arff"), str(d / "medium-test.arff")
    want = _line(jcli.run, [tr, te, "20", "--backend", "tpu-pallas",
                            "--platform", "cpu"])
    assert want.startswith("The 20-NN classifier for 370 test instances on "
                           "7354 train instances")
    got = _line(cli.run, [tr, te, "20", "--backend", "cuda-tile", "--device",
                          "cpu"])
    assert got == want


def test_predict_tile_rejects_what_it_does_not_take():
    train, labels, test = labelled(9)
    with pytest.raises(ValueError, match="k must be >= 1"):
        tile_knn.predict_tile(train, labels, test, 0, 6, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tile_knn.predict_tile(train, labels, test, 3, 6, engine="xla",
                              device="cpu")
    with pytest.raises(ValueError, match="precision"):
        tile_knn.predict_tile(train, labels, test, 3, 6, precision="tf32",
                              device="cpu")


def test_tile_backend_caches_the_stored_train(tmp_path):
    train_p, test_p = write_wide_arff(tmp_path)
    train, test = load_arff(train_p), load_arff(test_p)
    predict = get_backend("cuda-tile")
    first = predict(train, test, 5, precision="bf16", device="cpu")
    assert set(train.device_cache) == {("train", "cpu", "torch.bfloat16"),
                                       ("labels", "cpu")}
    predict(train, test, 5, precision="bf16", engine="merge", device="cpu")
    assert len(train.device_cache) == 2  # d > 128: both routes store bf16
    predict(train, test, 5, device="cpu")  # auto: fast, feature-major
    assert ("train_operand", "cpu") in train.device_cache
    np.testing.assert_array_equal(
        first, get_backend("oracle")(train, test, 5))


def write_wide_arff(tmp_path, n=300, q=24, d=200):
    """A small wide ARFF pair on an integer grid (every form exact)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (n, d))
    y = rng.integers(0, 5, n)
    x[150:170] = x[:20]
    qx = np.concatenate([x[rng.choice(n, q // 2, replace=False)],
                         rng.integers(0, 4, (q - q // 2, d))])
    qy = rng.integers(0, 5, q)
    paths = []
    for name, xs, ys in (("train", x, y), ("test", qx, qy)):
        head = [f"@relation wide-{name}", ""]
        head += [f"@attribute a{i} NUMERIC" for i in range(d)]
        head += ["@attribute class NUMERIC", "", "@data"]
        rows = [",".join(map(str, r)) + f",{c}" for r, c in zip(xs.tolist(), ys)]
        path = tmp_path / f"wide-{name}.arff"
        path.write_text("\n".join(head + rows) + "\n")
        paths.append(str(path))
    return paths


_MS = re.compile(r"required \d+ ms")


def _line(runner, argv):
    out = io.StringIO()
    assert runner(argv, stdout=out) == 0
    return _MS.sub("required <ms> ms", out.getvalue())


@pytest.mark.parametrize("precision", ["exact", "fast", "bf16", "auto"])
def test_cli_result_line_matches_jax_tpu_pallas(tmp_path, precision):
    tr, te = write_wide_arff(tmp_path)
    want = _line(jcli.run, [tr, te, "5", "--backend", "tpu-pallas",
                            "--platform", "cpu", "--precision", precision])
    assert want.startswith("The 5-NN classifier for 24 test instances on 300")
    got = _line(cli.run, [tr, te, "5", "--backend", "cuda-tile",
                          "--device", "cpu", "--precision", precision])
    assert got == want


@pytest.mark.parametrize("shape,d", [("large", 11), ("sift128", 128)])
def test_bigk_probe_main_at_a_reduced_size(shape, d):
    from knn_tpu_torch.probes import tile_bigk
    out = io.StringIO()
    assert tile_bigk.main(["--device", "cpu", "--shape", shape, "--seed",
                           "2147483651", "--rows", "700", "--queries", "9",
                           "--ks", "17,300", "--factors", "1,2", "--reps",
                           "1"], stdout=out) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == ("device: cpu (plain versions); 9 queries x 700 train "
                        f"x {d} feats, exact form")
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["k"] for r in rows] == [17, 300]
    for r in rows:
        assert r["plan"] == list(tile_knn.tile_split_plan(700, 9, 132, r["k"]))
        assert sorted(r["factors"]) == ["1", "2"]
        assert all(ok is True for _, _, ok in r["factors"].values())
        assert r["ref_parity"] is True
        # The plain version keeps no counters.
        assert r["selection"] == dict.fromkeys(tile_knn.SELECTION_COUNTERS, 0)


def test_bigk_probe_sift_shape_is_drawn_from_the_seed():
    from knn_tpu_torch.probes import tile_bigk
    x, q = tile_bigk.sift128(7, rows=50, queries=3)
    assert x.shape == (50, 128) and q.shape == (3, 128)
    assert x.dtype == q.dtype == np.float32
    assert np.array_equal(np.unique(np.round(x * 255)), np.unique(x * 255))
    assert 0 <= x.min() and x.max() <= 1
    assert np.array_equal(x, tile_bigk.sift128(7, rows=50, queries=3)[0])
    assert not np.array_equal(x, tile_bigk.sift128(8, rows=50, queries=3)[0])


# The bf16 kernel's host-side operands: bfloat16 copies rounded once and
# zero-padded to a multiple of 64 features, the train's kept with it, the
# norms those of the stored values.

OPERAND_DS = (1, 11, 64, 129)


def operand_keys(t, q, n_valid, k, n_splits, rows):
    """``[Q, n_splits, k]`` keys computed from what the bf16 kernel is
    given: the padded bfloat16 copies for the cross term and the norms of
    the stored train and the float32 queries."""
    from knn_tpu_torch.ops.distance import _expand, sq_norms

    tb, qb = tile_knn.bf16_operand(t, cache=True), tile_knn.bf16_operand(q)
    dist = _expand(sq_norms(q), sq_norms(t),
                   qb.float() @ tb[: t.shape[0]].float().T)
    out = torch.full((q.shape[0], n_splits, k), cuda_knn._SENTINEL_KEY,
                     dtype=torch.int64)
    for s in range(n_splits):
        lo, hi = s * rows, min((s + 1) * rows, n_valid)
        if hi <= lo:
            continue
        keys = cuda_knn._pack_keys(dist[:, lo:hi],
                                   torch.arange(lo, hi, dtype=torch.int64))
        top = torch.topk(keys, min(k, hi - lo), dim=1, largest=False).values
        out[:, s, : top.shape[1]] = torch.sort(top, dim=1).values
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", OPERAND_DS + (784,))
def test_bf16_operand_pads_and_rounds_once(d, dtype):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((37, d)).astype(np.float32)
                         ).to(dtype)
    op = tile_knn.bf16_operand(x)
    assert op.dtype == torch.bfloat16 and op.is_contiguous()
    assert op.shape == (37, -(-d // 64) * 64)
    assert torch.equal(op[:, :d], x.to(torch.bfloat16))
    assert not op[:, d:].any()


def test_bf16_operand_of_an_empty_matrix_is_one_zero_row():
    op = tile_knn.bf16_operand(torch.zeros((0, 5)))
    assert op.shape == (1, 64) and not op.any()


def test_bf16_operand_is_kept_with_its_tensor():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (20, 70)).astype(np.float32))
    first = tile_knn.bf16_operand(x, cache=True)
    assert tile_knn.bf16_operand(x, cache=True) is first
    assert tile_knn.bf16_operand(x) is not first  # uncached: a new copy
    x.mul_(2)  # an in-place change makes a new copy
    again = tile_knn.bf16_operand(x, cache=True)
    assert again is not first
    assert torch.equal(again[:, :70], x.to(torch.bfloat16))
    assert torch.equal(tile_knn.bf16_operand(x.clone(), cache=True), again)


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("d", OPERAND_DS)
def test_bf16_operands_give_the_plain_versions_keys(d, kind, store):
    # Bit for bit, at the split layout of the bf16 kernel's plan and at
    # splits ending inside a tile; the norms are those of the stored values.
    train, test = problem(kind, d, seed=d + 11)
    train[7, 0] = np.nan
    t, q = torch.from_numpy(train).to(store), torch.from_numpy(test)
    for k in (1, 5, 17):
        for plan in (tile_knn.tile_split_plan(N - 9, Q, 132, k, "bf16"),
                     (3, 100)):
            got = operand_keys(t, q, N - 9, k, *plan)
            want = tile_knn.knn_tile_scan_reference(t, q, N - 9, k, "bf16",
                                                    *plan)
            assert torch.equal(got, want), (k, plan)


@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("d", OPERAND_DS)
@pytest.mark.parametrize("route", ["merge", "stripe"])
def test_bf16_operands_match_the_jax_bf16_kernels(route, d, kind):
    # The keys from the kernel's operands against knn_tpu's interpreted bf16
    # kernels, each fed its route's store: equal indices and bit-equal
    # distances on integer grids, the module's tolerance on float rows.
    train, test = problem(kind, d, seed=d * 7 + FORMS.index("bf16"))
    store = torch.bfloat16 if (merge_store("bf16") if route == "merge"
                               else stripe_store("bf16", d)) == jnp.bfloat16 \
        else torch.float32
    d_want, i_want = jax_answer(route, "bf16", d, kind)
    t, q = torch.from_numpy(train).to(store), torch.from_numpy(test)
    d_got, i_got = cuda_knn.knn_stripe_merge(operand_keys(t, q, N, 16, 1, N))
    d_got, i_got = d_got.numpy(), i_got.numpy()
    if kind == "grid":
        np.testing.assert_array_equal(i_got, i_want)
        assert d_got.tobytes() == d_want.tobytes()
    else:
        assert_agree(train, test, "bf16", store, d_got, i_got, d_want, i_want)


@pytest.mark.parametrize("n_valid", [1, 3001, 65_536])
@pytest.mark.parametrize("k", [5, 17, 256])
def test_bf16_split_plan_is_one_wave(n_valid, k):
    # The bf16 kernel runs one block per SM: its plan aims at one block per
    # SM, keeps k > 16's 2k-row minimum, and covers every row.
    n_splits, rows = tile_knn.tile_split_plan(n_valid, 2048, 132, k, "bf16")
    assert rows % 128 == 0 and n_splits * rows >= n_valid > (n_splits - 1) * rows
    assert n_splits * 16 <= 132 or rows == 128
    if k > 16:
        assert rows >= 2 * k or n_splits == 1


def test_tile_forms_probe_main_at_a_reduced_size():
    from knn_tpu_torch.probes import tile_forms
    out = io.StringIO()
    assert tile_forms.main(["--device", "cpu", "--rows", "300", "--queries",
                            "7", "--reps", "1", "--tag", "t"], stdout=out) == 0
    line = json.loads(out.getvalue())
    assert line["device"] == "cpu (plain versions)" and line["tag"] == "t"
    assert sorted(line["ms"]) == sorted(line["digest"]) == sorted([
        "wide exact k=5 f32 store", "wide fast k=5 f32 store",
        "wide bf16 k=5 bf16 store", "wide bf16 k=32 bf16 store",
        "wide bf16 k=256 bf16 store", "wide bf16 k=5 f32 store",
        "wide P1 block_n=1024", "large bf16 k=5 f32 store",
        "large bf16 k=32 bf16 store", "large bf16 k=256 bf16 store",
        "large exact k=32 f32 store", "large exact k=256 f32 store",
        "large stripe k=5", "xl stripe k=10"])
    assert all(ms > 0 for ms in line["ms"].values())
    # The profiled device times are the card's only.
    assert line["kernel_ms"] == line["device_ms"] == {}
    # A digest is the int64 sum of the packed keys of the first run.
    from knn_tpu_torch.probes.data import large_fixture
    lx, _, lq, _ = large_fixture(seed=0)
    dist, idx = cuda_knn.knn_stripe_candidates_reference(
        torch.from_numpy(lx[:300]), torch.from_numpy(lq[:7]), 300, 5)
    assert line["digest"]["large stripe k=5"] == int(
        cuda_knn._pack_keys(dist, idx).sum())


def test_selection_counters_exist_and_start_at_zero():
    # The k > 16 selection's obs counters: on the wrapper, by name, 0 until
    # a card's kernel counts; no card has counted in this process.
    assert tile_knn.SELECTION_COUNTERS == ("candidates", "folds",
                                           "overflow_rounds")
    assert tile_knn.selection_counters() == dict.fromkeys(
        tile_knn.SELECTION_COUNTERS, 0)
    for name in tile_knn.SELECTION_COUNTERS:
        assert getattr(tile_knn.knn_tile_scan, name) == 0


@pytest.mark.parametrize("rows", [1, 127, 128, 300])
@pytest.mark.parametrize("d", [1, 11, 128, 129, 784])
def test_feature_major_transposes_and_pads_the_rows(d, rows):
    # Each feature's values over the rows are one contiguous run, the rows
    # rounded up to the kernels' 128-row granule (so every run starts
    # 16-byte aligned), zeros past the matrix's own rows.
    x = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (rows, d)).astype(np.float32))
    op = cuda_knn.feature_major(x)
    assert op.dtype == torch.float32 and op.is_contiguous()
    assert op.shape == (d, -(-rows // 128) * 128)
    assert op.shape[1] % cuda_knn.ROW_GRANULE == 0
    assert torch.equal(op[:, :rows], x.T)
    assert not op[:, rows:].any()


def test_feature_major_of_an_empty_matrix_is_zeros():
    assert cuda_knn.feature_major(torch.zeros((0, 5))).shape == (5, 128)
    op = cuda_knn.feature_major(torch.ones((7, 0)))
    assert op.shape == (1, 128) and not op.any()


def test_feature_major_is_kept_with_its_tensor():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (200, 11)).astype(np.float32))
    first = cuda_knn.feature_major(x, cache=True)
    assert cuda_knn.feature_major(x, cache=True) is first
    assert cuda_knn.feature_major(x) is not first  # uncached: a new copy
    assert tile_knn._kept_with is cuda_knn._kept_with  # one store for both
    x[3, 4] = 7.0  # an in-place change makes a new copy
    again = cuda_knn.feature_major(x, cache=True)
    assert again is not first and again[4, 3] == 7.0
    assert torch.equal(again, cuda_knn.feature_major(x.clone(), cache=True))
    # The bf16 operand is kept with the same tensor, under its own name.
    assert tile_knn.bf16_operand(x, cache=True) is tile_knn.bf16_operand(
        x, cache=True)
    assert cuda_knn.feature_major(x, cache=True) is again


def test_tile_kernel_constants_match_the_source():
    # The host's plans and operands assume the kernel's tile, chunk and
    # granules; each is read back from csrc/.
    src = (cuda_knn._build.CSRC / "tile_knn.cu").read_text()
    head = (cuda_knn._build.CSRC / "stripe_knn.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const(src, "kTile") == tile_knn._TILE_ROWS == 128
    assert const(src, "kChunk") == 16 and const(src, "kStages") == 2
    # The k > 16 path of the CUDA-core forms: the ring, then per query a
    # buffer of kBufKeys keys, a threshold key, a count, a fill and a bit,
    # and the block's two totals; two blocks, each with the 1 KB the card reserves
    # per block, fit an SM's 228 KB, as at k <= 16.
    tile, chunk, stages = const(src, "kTile"), const(src, "kChunk"), 2
    buf_keys, fold_at = const(src, "kBufKeys"), const(src, "kFoldAt")
    ring = stages * 2 * chunk * tile * 4
    smem = ring + tile * buf_keys * 8 + tile * (8 + 4 + 4) + 2 * 8 + tile // 8
    assert 2 * (smem + 1024) <= 228 * 1024
    assert buf_keys & (buf_keys - 1) == 0 and 1 <= fold_at <= buf_keys
    assert const(head, "kRowGranule") == cuda_knn.ROW_GRANULE == 128
    assert const(head, "kSplitAlign") == cuda_knn.SPLIT_ALIGN == 4
    assert tile_knn._TILE_ROWS % cuda_knn.SPLIT_ALIGN == 0
