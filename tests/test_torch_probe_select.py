"""P2: the stripe scan's selection variants against the JAX probe's kernel.

``cuda_knn.knn_stripe_scan_variant`` on CPU tensors runs its plain version,
which replays the kernel's passes. ``rounds`` and ``lite``, each followed by
the port's merge (``knn_stripe_merge``), are held against the body of
``scripts/tune_stripe_selection.py::make_variant_kernel`` (``current`` and
``lite``), loaded from the script's file and run in this file's own
``pl.pallas_call(..., interpret=True)`` with the script's grid spec, then
the JAX package's ``_merge_topk_rounds``. The script itself is not edited.

Tolerances. Indices are equal. Distances are bit-equal on integer grids,
where every distance is exact in float32; on float rows they agree within
``rtol = d * 2**-24``, because XLA:CPU contracts ``d + diff*diff`` into a
fused multiply-add and the port rounds twice. ``lite`` is compared only
where the JAX gate admits it: ``stripe_inputs_finite`` holds and
k <= n_valid. ``nosel`` depends on the split layout by design, so it is held
to a numpy statement of its definition, not to JAX.
"""

import functools
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from knn_tpu.ops import pallas_knn  # noqa: E402
from knn_tpu_torch.ops import cuda_knn  # noqa: E402
from knn_tpu_torch.probes import tune_stripe_selection as probe  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
INT_MAX = np.iinfo(np.int32).max
N, Q = 300, 13  # N is not a multiple of 128
KS = (1, 5, 16)
# (n_splits, rows_per_split) over N rows: one split; the card's plan of
# 64-row splits (split_plan at 132 SMs); splits that are not whole tiles.
PLANS = ((1, N), (5, 64), (3, 100))


@functools.lru_cache(maxsize=None)
def script():
    spec = importlib.util.spec_from_file_location(
        "tune_stripe_selection_script", REPO / "scripts" / "tune_stripe_selection.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.partial(jax.jit, static_argnames=("mode", "k", "block_q",
                                             "block_n", "d_true"))
def _jax_variant(n_valid, qx, txT, mode, k, block_q, block_n, d_true):
    """The script's ``stripe_variant`` with ``interpret=True``: one compile
    per (mode, k, shapes), reused across inputs and n_valid."""
    d_pad, n_pad = txT.shape
    q_pad = qx.shape[0]
    grid = (q_pad // block_q, n_pad // block_n)
    kernel = functools.partial(script().make_variant_kernel(mode), k=k,
                               block_n=block_n, d_true=d_true,
                               n_tiles=grid[1])
    cd, ci = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=grid,
            in_specs=[
                pl.BlockSpec((block_q, qx.shape[1]), lambda i, j, n_ref: (i, 0)),
                pl.BlockSpec((d_pad, block_n), lambda i, j, n_ref: (0, j)),
            ],
            out_specs=[
                pl.BlockSpec((block_q, k * 128), lambda i, j, n_ref: (i, 0)),
                pl.BlockSpec((block_q, k * 128), lambda i, j, n_ref: (i, 0)),
            ],
            scratch_shapes=[
                pltpu.VMEM((block_q, k * 128), jnp.float32),
                pltpu.VMEM((block_q, k * 128), jnp.int32),
            ],
        ),
        out_shape=[
            jax.ShapeDtypeStruct((q_pad, k * 128), jnp.float32),
            jax.ShapeDtypeStruct((q_pad, k * 128), jnp.int32),
        ],
        interpret=True,
    )(n_valid.reshape(1), qx, txT)
    return pallas_knn._merge_topk_rounds(cd, ci, k)


def jax_variant(train, test, n_valid, k, mode, block_q=8, block_n=256):
    """The JAX probe's kernel and merge on unpadded inputs: [Q, k]."""
    txT, d_pad = pallas_knn.stripe_prepare_train(train, block_n)
    qx = pallas_knn.stripe_prepare_queries(test, block_q, d_pad)
    md, mi = _jax_variant(jnp.asarray(n_valid, jnp.int32), jnp.asarray(qx),
                          jnp.asarray(txT), mode, k, block_q, block_n,
                          train.shape[1])
    q = test.shape[0]
    return np.asarray(md)[:q], np.asarray(mi)[:q]


@functools.lru_cache(maxsize=None)
def problem(kind, d=11, seed=0):
    """(train, test): an integer grid with duplicated rows (dist == 0 tie
    plateaus across 128-row tiles) and queries that repeat train rows;
    standard normal floats; or the grid with NaN rows."""
    rng = np.random.default_rng(seed)
    if kind == "float":
        return (rng.standard_normal((N, d)).astype(np.float32),
                rng.standard_normal((Q, d)).astype(np.float32))
    train = rng.integers(0, 3, (N, d)).astype(np.float32)
    train[150:200] = train[:50]
    test = np.concatenate([train[rng.choice(N, Q // 2, replace=False)],
                           rng.integers(0, 3, (Q - Q // 2, d)).astype(np.float32)])
    if kind == "nan":
        train[rng.choice(N, 30, replace=False), 4] = np.nan
        test[0, 0] = np.nan
    return train, test


@functools.lru_cache(maxsize=None)
def jax_answer(kind, mode, n_valid):
    """The JAX probe's ``mode`` (``current`` or ``lite``) at k = 16, merged;
    a smaller k is its sorted prefix."""
    train, test = problem(kind)
    return jax_variant(train, test, n_valid, 16, mode)


def port_merged(train, test, n_valid, k, mode, plan):
    t, q = torch.from_numpy(train), torch.from_numpy(test)
    partial = cuda_knn.knn_stripe_scan_variant(t, q, n_valid, k, mode, *plan)
    assert partial.shape == (Q, plan[0], k) and partial.dtype == torch.int64
    d, i = cuda_knn.knn_stripe_merge(partial)
    return d.numpy(), i.numpy()


def check(kind, mode, n_valid, k, plan):
    train, test = problem(kind)
    jmode = "current" if mode == "rounds" else mode
    d_want, i_want = (a[:, :k] for a in jax_answer(kind, jmode, n_valid))
    d_got, i_got = port_merged(train, test, n_valid, k, mode, plan)
    np.testing.assert_array_equal(i_got, i_want)
    if kind == "float":
        np.testing.assert_allclose(d_got, d_want,
                                   rtol=train.shape[1] * 2.0**-24, atol=0)
    else:
        assert d_got.tobytes() == d_want.tobytes()


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind,n_valid", [("grid", N), ("grid", N - 45),
                                          ("float", N), ("nan", N - 45)])
def test_rounds_then_merge_matches_the_jax_variant(kind, n_valid, k, plan):
    # rounds retires the index too, so NaN rows (+inf, own index) are fine.
    check(kind, "rounds", n_valid, k, plan)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind,n_valid", [("grid", N), ("grid", N - 45),
                                          ("float", N)])
def test_lite_then_merge_matches_the_jax_variant(kind, n_valid, k, plan):
    train, test = problem(kind)
    assert cuda_knn.stripe_inputs_finite(train, test) and k <= n_valid
    check(kind, "lite", n_valid, k, plan)


def as_tensors(train, test):
    return torch.from_numpy(train), torch.from_numpy(test)


@pytest.mark.parametrize("plan", PLANS + ((6, 52),))
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["grid", "nan"])
def test_rounds_scan_equals_the_insertion_scan(kind, k, plan):
    # Unique keys: k rounds of (min distance, min index) give the sorted
    # k best keys, which is what the insertion list keeps, split by split.
    t, q = as_tensors(*problem(kind))
    got = cuda_knn.knn_stripe_scan_variant(t, q, N - 45, k, "rounds", *plan)
    assert torch.equal(got, cuda_knn.knn_stripe_scan(t, q, N - 45, k, *plan))


@pytest.mark.parametrize("plan", PLANS + ((6, 52), (30, 10)))
@pytest.mark.parametrize("k", KS)
def test_lite_scan_differs_from_rounds_only_in_its_inf_tail(k, plan):
    # On finite inputs lite's list keeps rounds' finite prefix; a split with
    # fewer valid rows than k ends in (+inf, its first row) duplicates, the
    # smallest retired index, where rounds has (+inf, INT32_MAX).
    t, q = as_tensors(*problem("grid"))
    n_valid = N - 45
    lite = cuda_knn.knn_stripe_scan_variant(t, q, n_valid, k, "lite", *plan)
    rounds = cuda_knn.knn_stripe_scan_variant(t, q, n_valid, k, "rounds", *plan)
    for s in range(plan[0]):
        lo = s * plan[1]
        rows = max(0, min(plan[1], n_valid - lo))
        m = min(k, rows)
        assert torch.equal(lite[:, s, :m], rounds[:, s, :m])
        assert (rounds[:, s, m:] == cuda_knn._SENTINEL_KEY).all()
        tail = (0x7F800000 << 32) | lo if rows else cuda_knn._SENTINEL_KEY
        assert (lite[:, s, m:] == tail).all()


def numpy_nosel(train, test, n_valid, k, n_splits, rows):
    """nosel's definition: per split, slot 0 holds (the smallest distance of
    the split's rows below n_valid, a NaN distance counting as +inf,
    INT32_MAX); every other slot is (+inf, INT32_MAX). Distances as the
    sequential loop acc = acc + diff*diff in float32."""
    acc = np.zeros((test.shape[0], train.shape[0]), np.float32)
    for f in range(train.shape[1]):
        diff = test[:, f : f + 1] - train[None, :, f]
        acc = acc + diff * diff
    acc[np.isnan(acc)] = np.inf
    out = np.full((test.shape[0], n_splits, k), (0x7F800000 << 32) | INT_MAX,
                  np.int64)
    for s in range(n_splits):
        block = acc[:, s * rows : min((s + 1) * rows, n_valid)]
        best = block.min(axis=1) if block.shape[1] else np.full(len(acc), np.inf,
                                                                 np.float32)
        out[:, s, 0] = (best.view(np.int32).astype(np.int64) << 32) | INT_MAX
    return out


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["grid", "float", "nan"])
def test_nosel_is_the_split_minimum(kind, k, plan):
    train, test = problem(kind)
    got = cuda_knn.knn_stripe_scan_variant(*as_tensors(train, test), N - 45, k,
                                           "nosel", *plan)
    np.testing.assert_array_equal(
        got.numpy(), numpy_nosel(train, test, N - 45, k, *plan))


@pytest.mark.parametrize("mode,k", [("bogus", 5), ("rounds", 17),
                                    ("lite", 0), ("nosel", 32)])
def test_variant_rejects_what_it_does_not_take(mode, k):
    with pytest.raises(ValueError):
        cuda_knn.knn_stripe_scan_variant(*as_tensors(*problem("grid")), N, k,
                                         mode, 1, N)


def test_probe_main_at_a_reduced_size():
    out = io.StringIO()
    assert probe.main(["--device", "cpu", "--rows", "2000", "--queries", "24",
                       "--reps", "1,2"], stdout=out) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == ("device: cpu (plain versions); 24 queries x 2000 "
                        "train x 11 feats, k=5")
    shapes = probe.sweep_shapes(2000, 24, probe.H100_SMS)
    assert len(lines) == 1 + len(shapes) * len(probe.MODES)
    for line in lines[1:]:
        mode = line.split()[2]
        assert "ms/step" in line
        assert line.endswith("parity=-" if mode == "nosel" else "parity=True")


def test_probe_sweeps_the_shipped_plan():
    n, q, _ = 30803, 1718, 11
    shapes = probe.sweep_shapes(n, q, probe.H100_SMS)
    assert cuda_knn.split_plan(n, q, probe.H100_SMS) in shapes
    for n_splits, rows in shapes:
        cuda_knn.check_splits(n, n_splits, rows)
