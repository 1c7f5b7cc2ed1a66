"""Collective-bytes audit on the port (``knn_tpu_torch/parallel/
comm_audit.py``), the twin of ``tests/test_comm_audit.py``: the sharded
engines move data only through ``parallel/collectives.py``, which records
every tensor it moves; the record must equal the JAX package's byte model
on the same problem — three gathers of ``[q_local, k*P]`` 4-byte triples
for train sharding, one (shard, labels) move per ring step — and the audit
must reject a record that does anything else.

The JAX side reads the same numbers from its lowered StableHLO
(``knn_tpu.parallel.comm_audit``), so each case holds the port's recorded
bytes, the JAX model and (where the layouts coincide) JAX's parsed
lowering equal. Tolerances: byte counts exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from knn_tpu.parallel import comm_audit as jaudit  # noqa: E402
from knn_tpu.parallel.mesh import make_mesh, make_mesh_2d  # noqa: E402
from knn_tpu.parallel.ring import build_ring_fn  # noqa: E402
from knn_tpu.parallel.train_sharded import build_train_sharded_fn  # noqa: E402
from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.parallel import collectives  # noqa: E402
from knn_tpu_torch.parallel.comm_audit import (  # noqa: E402
    CollectiveParseError,
    audit_ring,
    audit_train_sharded,
    model_ring_bytes,
    model_train_sharded_bytes,
)
from knn_tpu_torch.parallel.ring import predict_ring  # noqa: E402
from knn_tpu_torch.parallel.train_sharded import predict_train_sharded  # noqa: E402
from tests.test_torch_resilience import global_state  # noqa: E402,F401


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(0)
    train_x = rng.random((512, 8), np.float32)
    train_y = rng.integers(0, 10, 512).astype(np.int32)
    test_x = rng.random((64, 8), np.float32)
    return train_x, train_y, test_x


def _train_sharded_log(toy, n_q, n_t, k, engine="xla", qt=8, tt=32):
    train_x, train_y, test_x = toy
    log = []
    predict_train_sharded(train_x, train_y, test_x, k, 10,
                          mesh_shape=(n_q, n_t), query_tile=qt,
                          train_tile=tt, engine=engine, device="cpu",
                          num_devices=n_q * n_t, log=log)
    return log


@pytest.mark.parametrize("engine", ["xla", "stripe"])
def test_train_sharded_collectives_match_model(toy, engine):
    train_x, train_y, test_x = toy
    n_q, n_t, k, qt, tt = 2, 4, 5, 8, 32
    log = _train_sharded_log(toy, n_q, n_t, k, engine, qt, tt)
    q_local = test_x.shape[0] // n_q
    measured, expected = audit_train_sharded(log, q_local, k, n_t)
    assert measured == expected == q_local * k * n_t * 12
    assert expected == jaudit.model_train_sharded_bytes(q_local, k, n_t)
    # JAX's own lowering of the same problem moves the same bytes.
    fn = build_train_sharded_fn(make_mesh_2d(n_q, n_t), k, 10, "exact",
                                query_tile=qt, train_tile=tt)
    txt = fn.lower(jnp.asarray(train_x), jnp.asarray(train_y),
                   jnp.asarray(test_x), jnp.asarray(512, jnp.int32)).as_text()
    assert jaudit.audit_train_sharded(txt, q_local, k, n_t) == (
        measured, expected)


@pytest.mark.parametrize("engine", ["full", "tiled"])
def test_ring_collectives_match_model(toy, engine):
    train_x, train_y, test_x = toy
    n_dev = 8
    log = []
    predict_ring(train_x, train_y, test_x, 5, 10, engine=engine,
                 num_devices=n_dev, device="cpu", log=log)
    shard = train_x.shape[0] // n_dev
    measured, expected = audit_ring(log, shard * 8 * 4, shard * 4, n_dev)
    assert measured == expected == (shard * 8 * 4 + shard * 4) * (n_dev - 1)
    fn = build_ring_fn(make_mesh(n_dev, axis_names=("r",)), 5, 10, "exact",
                       engine="full")
    txt = fn.lower(jnp.asarray(train_x), jnp.asarray(train_y),
                   jnp.asarray(test_x), jnp.asarray(512, jnp.int32)).as_text()
    assert jaudit.audit_ring(txt, shard * 8 * 4, shard * 4, n_dev) == (
        measured, expected)


def test_ring_stripe_collectives(toy):
    # The stripe-engine ring rotates the shard's rows and labels as the
    # other engines do (the kernels' feature-major operand is built on the
    # receiving device): the same byte model, at the port's own layout.
    train_x, train_y, test_x = toy
    n_dev = 4
    log = []
    predict_ring(train_x, train_y, test_x, 5, 10, engine="stripe",
                 num_devices=n_dev, device="cpu", log=log)
    shard_rows = -(-train_x.shape[0] // n_dev)
    measured, expected = audit_ring(
        log, shard_rows * train_x.shape[1] * 4, shard_rows * 4, n_dev)
    assert measured == expected == jaudit.model_ring_bytes(
        shard_rows * 8 * 4, shard_rows * 4, n_dev)


def test_audit_rejects_wrong_model(toy):
    log = _train_sharded_log(toy, 2, 4, 5)
    with pytest.raises(AssertionError, match="shape"):
        audit_train_sharded(log, q_local=99, k=5, n_t=4)
    with pytest.raises(CollectiveParseError, match="unexpected collectives"):
        audit_ring(log, 1, 1, 4)  # gathers are not a ring program
    with pytest.raises(CollectiveParseError, match="no collectives"):
        audit_ring([], 1, 1, 4)
    ring_log = []
    predict_ring(*toy, 5, 10, engine="full", num_devices=4, device="cpu",
                 log=ring_log)
    with pytest.raises(CollectiveParseError, match="per-step payload"):
        audit_ring(ring_log, 1, 1, 4)
    with pytest.raises(CollectiveParseError, match="steps"):
        audit_ring(ring_log, 128 * 32, 128 * 4, 8)


def test_models_are_the_jax_models():
    for args in ((32, 5, 4), (1, 1, 1), (7, 16, 8)):
        assert model_train_sharded_bytes(*args) == \
            jaudit.model_train_sharded_bytes(*args)
    assert model_ring_bytes(4096, 512, 8) == jaudit.model_ring_bytes(
        4096, 512, 8)


def test_recording_is_per_thread_and_nested():
    with collectives.recording() as outer:
        with collectives.recording() as inner:
            collectives.gather_predictions(
                [torch.zeros(3, dtype=torch.int32)] * 2, torch.device("cpu"))
        collectives.all_gather_to([torch.zeros(2, 5)] * 4,
                                  torch.device("cpu"))
    assert [o.op for o in inner] == ["gather"]
    assert [o.op for o in outer] == ["gather", "all_gather"]
    assert outer[1].shape == (2, 20) and outer[1].nbytes == 160


def test_collective_counter_equals_the_model(toy):
    obs.reset()
    obs.enable()
    try:
        log = _train_sharded_log(toy, 2, 4, 5)
        snap = obs.registry().to_json()
    finally:
        obs.disable()
        obs.reset()
    got = [v for v in snap["knn_collective_bytes_total"]
           if v["labels"].get("path") == "train-sharded"]
    assert got[0]["value"] == model_train_sharded_bytes(32, 5, 4)
    assert audit_train_sharded(log, 32, 5, 4)[0] == got[0]["value"]
