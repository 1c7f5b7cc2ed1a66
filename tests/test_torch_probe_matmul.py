"""P1: the folded bf16 cross term against the JAX probe's kernel.

``ops/probe_matmul.py::pure_matmul`` on CPU tensors runs its plain version.
It is held against ``scripts/probe_mnist_r3.py::_matmul_kernel``, loaded
from the script's file and run in this file's own ``pl.pallas_call(...,
interpret=True)`` with the in and out specs of the script's
``pure_matmul``: queries in ``(block_q, D)`` blocks, train rows in
``(block_n, D)`` blocks, each train tile's products folded into 8 slots of
``block_n / 8`` rows and summed over the tiles into a ``(block_q, 8)``
block. The script itself is not edited.

Tolerances. On integer grids every product and every partial sum is an
integer below 2**24, so both sides are exact: bit-equal. On float rows both
sides sum the same exact products (a product of two bfloat16 values is
exact in float32) in other orders; each is off the exact sum by at most
``(D + m) * 2**-24 * S`` with m the rows in the slot and S the sum of the
products' magnitudes, so they differ by at most ``atol = 2 * (D + m) *
2**-24 * S`` per output.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from knn_tpu.utils.padding import pad_axis_to_multiple  # noqa: E402
from knn_tpu_torch.ops import probe_matmul  # noqa: E402
from knn_tpu_torch.probes import probe_mnist_r3 as probe  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
Q, D = 13, 100


@functools.lru_cache(maxsize=None)
def script():
    spec = importlib.util.spec_from_file_location(
        "probe_mnist_r3_script", REPO / "scripts" / "probe_mnist_r3.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_matmul(train, test, block_n, block_q=8):
    """The script's kernel, interpreted, over bfloat16 operands padded to
    whole blocks (zero rows): unpadded [Q, 8]."""
    tx, _ = pad_axis_to_multiple(train, block_n, axis=0)
    qx, _ = pad_axis_to_multiple(test, block_q, axis=0)
    d = train.shape[1]
    grid = (qx.shape[0] // block_q, tx.shape[0] // block_n)
    out = pl.pallas_call(
        script()._matmul_kernel,
        grid=grid,
        in_specs=[
            pl.BlockSpec((block_q, d), lambda i, j: (i, 0)),
            pl.BlockSpec((block_n, d), lambda i, j: (j, 0)),
        ],
        out_specs=pl.BlockSpec((block_q, 8), lambda i, j: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((qx.shape[0], 8), jnp.float32),
        interpret=True,
    )(jnp.asarray(qx, jnp.bfloat16), jnp.asarray(tx, jnp.bfloat16))
    return np.asarray(out)[: test.shape[0]]


def port(train, test, block_n):
    got = probe_matmul.pure_matmul(torch.from_numpy(train).to(torch.bfloat16),
                                   torch.from_numpy(test).to(torch.bfloat16),
                                   block_n)
    assert got.dtype == torch.float32 and got.shape == (test.shape[0], 8)
    return got.numpy()


def grid_problem(n, seed):
    """Small integers that differ by row and by feature, so a product that
    lands in the wrong slot changes the sum."""
    rng = np.random.default_rng(seed)
    r, f = np.arange(n)[:, None], np.arange(D)[None, :]
    train = ((r * 7 + f * 3 + rng.integers(0, 3, (n, D))) % 5).astype(np.float32)
    test = rng.integers(0, 4, (Q, D)).astype(np.float32)
    return train, test


@pytest.mark.parametrize("block_n", [128, 256])
@pytest.mark.parametrize("n", [700, 1024])
def test_integer_grid_bit_equal(n, block_n):
    train, test = grid_problem(n, seed=n + block_n)
    got, want = port(train, test, block_n), jax_matmul(train, test, block_n)
    assert got.tobytes() == want.tobytes()
    assert want.max() < 2**24


@pytest.mark.parametrize("block_n", [128, 256])
def test_float_rows_within_the_reordered_sum_bound(block_n):
    rng = np.random.default_rng(block_n)
    n = 700
    train = rng.standard_normal((n, D)).astype(np.float32)
    test = rng.standard_normal((Q, D)).astype(np.float32)
    got, want = port(train, test, block_n), jax_matmul(train, test, block_n)
    tb = torch.from_numpy(train).to(torch.bfloat16).double().abs()
    qb = torch.from_numpy(test).to(torch.bfloat16).double().abs()
    n_pad = -(-n // block_n) * block_n
    mags = torch.nn.functional.pad(qb @ tb.T, (0, n_pad - n)).reshape(
        Q, -1, 8, block_n // 8).sum(dim=(1, 3)).numpy()
    atol = 2 * (D + n_pad // 8) * 2.0**-24 * mags
    assert (np.abs(got - want) <= atol).all()


def test_plain_version_folds_by_row_position():
    # One train row at a time: its products land in slot
    # (row mod block_n) div (block_n / 8) and nowhere else.
    rng = np.random.default_rng(0)
    test = rng.integers(1, 4, (3, 16)).astype(np.float32)
    for block_n in (8, 64, 128):
        for row in (0, 5, block_n - 1, block_n + 3, 3 * block_n - 2):
            train = np.zeros((3 * block_n, 16), np.float32)
            train[row] = rng.integers(1, 4, 16)
            got = port(train, test, block_n)
            slot = (row % block_n) // (block_n // 8)
            np.testing.assert_array_equal(got[:, slot], test @ train[row])
            assert (np.delete(got, slot, axis=1) == 0).all()


@pytest.mark.parametrize("block_n", [0, 12, -8])
def test_rejects_a_block_n_that_is_not_a_multiple_of_8(block_n):
    train, test = grid_problem(64, seed=0)
    with pytest.raises(ValueError, match="block_n"):
        port(train, test, block_n)


def test_split_plan_covers_every_tile():
    # The split layout pure_matmul launches: whole 128-row tiles per split,
    # one block per SM.
    from knn_tpu_torch.ops import cuda_knn

    tile = probe_matmul._TILE_N
    for n in (1, 127, 128, 129, 65536, 1_000_000):
        for q in (1, 128, 2048, 100_000):
            splits, rows = cuda_knn.split_plan(
                n, q, 132, tile_rows=tile,
                blocks_per_sm=probe_matmul._BLOCKS_PER_SM,
                queries_per_block=probe_matmul._TILE_Q)
            per, tiles = rows // tile, -(-n // tile)
            assert rows % tile == 0
            assert 1 <= splits <= 65535 and (splits - 1) * per < tiles <= splits * per
            assert splits == 1 or splits * -(-q // probe_matmul._TILE_Q) <= 132


@pytest.mark.parametrize("kind", ["grid", "float"])
@pytest.mark.parametrize("d", [1, 11, 64, 100, 129])
def test_padded_operands_give_the_same_products(d, kind):
    # What the kernel reads: the operands' bf16_operand copies, zero past D.
    # A zero feature adds exactly 0, so the plain version over the padded
    # copies gives the plain version's sums (bit for bit on integer grids,
    # where every sum is exact; within one rounding per sum on floats).
    from knn_tpu_torch.ops import tile_knn

    rng = np.random.default_rng(d)
    if kind == "grid":
        train = rng.integers(0, 4, (300, d)).astype(np.float32)
        test = rng.integers(0, 4, (Q, d)).astype(np.float32)
    else:
        train = rng.standard_normal((300, d)).astype(np.float32)
        test = rng.standard_normal((Q, d)).astype(np.float32)
    t = torch.from_numpy(train).to(torch.bfloat16)
    q = torch.from_numpy(test).to(torch.bfloat16)
    tb, qb = tile_knn.bf16_operand(t, cache=True), tile_knn.bf16_operand(q)
    assert tb.shape == (300, -(-d // 64) * 64) and torch.equal(tb[:, :d], t)
    assert tile_knn.bf16_operand(t, cache=True) is tb
    for block_n in (8, 256, 1024):
        got = probe_matmul.pure_matmul_reference(tb, qb, block_n)
        want = probe_matmul.pure_matmul_reference(t, q, block_n)
        if kind == "grid":
            assert got.numpy().tobytes() == want.numpy().tobytes()
        else:
            mags = probe_matmul.pure_matmul_reference(t.abs(), q.abs(), block_n)
            assert ((got - want).abs() <= 2 * (d + 300) * 2.0**-24 * mags).all()


def test_probe_main_at_a_reduced_size():
    import io

    out = io.StringIO()
    assert probe.main(["--device", "cpu", "--n", "300", "--q", "16",
                       "--reps", "1,2"], stdout=out) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == ("device: cpu (plain versions); 16 queries x 300 train "
                        "x 784 feats, k=5")
    names = [line.split(":")[0] for line in lines[1:5]]
    assert names == ["A  pure matmul bf16 block_n=1024", "B  tile bf16, bf16 "
                     "store", "B2 tile fast, f32 store", "C  tile bf16, f32 store"]
    assert all("ms/step" in line and "TF eff" in line for line in lines[1:5])
    assert lines[5].startswith("C2 ") and lines[6].startswith("C3-C5, D: ")
