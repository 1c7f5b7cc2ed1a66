"""The train's residency on the kernels' route, on the CPU: the feature-major
operand built from the host array in row blocks (``cuda_knn.
upload_feature_major``) and the train's view of it, its norms
(``train_sq_norms``), its record (``train_residency``), its memo in
``Dataset.device_cache``, and its spans and counters. Imports no JAX: the
benchmark's configuration and reference are the yardstick."""

import gc
import json
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu_torch import obs  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models.knn import KNNClassifier  # noqa: E402
from knn_tpu_torch.ops import cuda_knn, tile_knn  # noqa: E402
from knn_tpu_torch.ops.distance import sq_norms  # noqa: E402
from knnbench import manifest, reference  # noqa: E402

CPU = torch.device("cpu")
BIGANN = manifest.ROOT / "knnbench" / "configs" / "bigann-100m-128-euclidean.json"


@pytest.fixture
def obs_state():
    """Restore obs's switch and drop what a test recorded."""
    was = obs.enabled()
    obs.reset()
    yield
    obs.reset()
    (obs.enable if was else obs.disable)()


def blocks_of(monkeypatch, rows: int, d: int) -> None:
    """Upload blocks of ``rows`` rows of ``d`` float32 features."""
    monkeypatch.setattr(cuda_knn, "UPLOAD_BLOCK_BYTES", rows * 4 * max(d, 1))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def integer_train(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Rows drawn as the benchmark draws them: integers in [0, 255] / 255."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, d)) / 255).astype(np.float32)


@pytest.mark.parametrize("n,d,block", [
    (3000, 128, 512),  # six blocks, the last short; 3,000 = 23 x 128 + 56
    (1000, 7, 97),  # neither a multiple of the block nor of 128 rows
    (1, 5, 64),  # one row
    (130, 1, 64),  # one feature
    (256, 3, 256),  # exactly one block of whole granules
    (77, 0, 10),  # no features: one zero row of the granule's width
    (0, 4, 8),  # no rows
])
def test_blocked_operand_equals_feature_major(monkeypatch, n, d, block):
    x = np.random.default_rng(n + d).standard_normal((n, d)).astype(
        np.float32)
    blocks_of(monkeypatch, block, d)
    train = cuda_knn.upload_feature_major(x, CPU)
    want = cuda_knn.feature_major(torch.from_numpy(x))
    operand = cuda_knn.feature_major(train, cache=True)  # kept, not made
    assert operand.shape == want.shape
    assert torch.equal(bits(operand), bits(want))
    assert train.shape == (n, d) and train.dtype == torch.float32
    assert train.untyped_storage().data_ptr() == (
        operand.untyped_storage().data_ptr())  # a view: no second copy
    assert torch.equal(bits(train), bits(torch.from_numpy(x)))
    assert cuda_knn.train_residency()["blocks"] == -(-n // block)


@pytest.mark.parametrize("n,d,block", [(3000, 128, 512), (1000, 7, 97),
                                       (1, 5, 64), (130, 1, 64)])
def test_norms_equal_sq_norms_of_the_whole_train(monkeypatch, n, d, block):
    """The fast form's ``t2``, summed block by block from row-major
    blocks of the view, is bit-equal to ``sq_norms`` of the whole row-major
    train, leaves the operand as it was (at one feature a block of the view
    is already contiguous), and ``route_train`` keeps it with the train."""
    x = np.random.default_rng(d).standard_normal((n, d)).astype(np.float32)
    blocks_of(monkeypatch, block, d)
    train = cuda_knn.route_train(x, CPU, None, "fast", torch.float32)
    t2 = cuda_knn._kept_with(train, "sq_norms", None)
    assert torch.equal(bits(t2), bits(sq_norms(torch.from_numpy(x))))
    assert torch.equal(bits(cuda_knn.train_sq_norms(train)), bits(t2))
    assert torch.equal(bits(train), bits(torch.from_numpy(x)))


def test_a_float64_train_is_converted_as_to_device_converts_it(monkeypatch):
    x = np.random.default_rng(3).standard_normal((300, 9))
    blocks_of(monkeypatch, 64, 9)
    train = cuda_knn.upload_feature_major(x, CPU)
    want = cuda_knn.to_device(x, np.float32, CPU)
    assert torch.equal(bits(train), bits(want))


def bigann_at_cpu_size(n=3000):
    """The bigann-100m configuration's draw at ``n`` rows, its limits, and
    64 queries."""
    cfg = json.loads(BIGANN.read_text())
    train = Dataset(integer_train(n, cfg["dim"], 1),
                    np.random.default_rng(2).integers(
                        0, cfg["classes"], n).astype(np.int32))
    test = Dataset(integer_train(64, cfg["dim"], 3), np.zeros(64, np.int32))
    return cfg, train, test


def test_model_answers_in_blocks_equal_the_one_block_answers(monkeypatch):
    """``KNNClassifier(10)``'s kneighbors and predict on a 3,000 x 128 train
    uploaded in six blocks give the one-block answers bit for bit, and the
    neighbors agree with the benchmark's reference within the
    configuration's limits."""
    cfg, train, test = bigann_at_cpu_size()
    one = KNNClassifier(10, device="cpu").fit(train)
    want_d, want_i = one.kneighbors(test)
    want_p = one.predict(test)
    assert cuda_knn.train_residency()["blocks"] == 1
    split = Dataset(train.features, train.labels)
    blocks_of(monkeypatch, 512, cfg["dim"])
    many = KNNClassifier(10, device="cpu").fit(split)
    got_d, got_i = many.kneighbors(test)
    assert cuda_knn.train_residency()["blocks"] == 6
    assert ("train_operand", "cpu") in split.device_cache
    assert got_d.tobytes() == want_d.tobytes()
    assert got_i.tobytes() == want_i.tobytes()
    np.testing.assert_array_equal(many.predict(test), want_p)

    ref_d, ref_i = reference.neighbors(train.features, test.features, 10)
    true_d = reference.distances(train.features, test.features,
                                 got_i.astype(np.int64))
    scale = ref_d[:, -1:]
    limits = cfg["limits"]
    assert ((true_d - ref_d) / scale).max() <= limits["rank_gap"]
    assert (np.abs(got_d - true_d) / scale).max() <= limits["dist_err"]
    assert all(len(set(row)) == 10 for row in got_i.tolist())


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_the_kernels_route_holds_no_row_major_copy(precision):
    """The exact and fast forms keep the operand alone; the bf16 form keeps
    its row-major store, as before."""
    _, train, test = bigann_at_cpu_size(600)
    cuda_knn.stripe_classify_arrays(train.features, train.labels,
                                    test.features, 5, 10, precision=precision,
                                    device="cpu", cache=train.device_cache)
    assert set(train.device_cache) == {("train_operand", "cpu"),
                                       ("labels", "cpu")}
    tile_knn.predict_tile(train.features, train.labels, test.features, 5, 10,
                          precision="bf16", device="cpu",
                          cache=train.device_cache)
    assert ("train", "cpu", "torch.float32") in train.device_cache


@pytest.mark.parametrize("dev", [CPU, torch.device("cpu", 0)])
def test_train_residency_reports_one_copy(monkeypatch, dev):
    """``card_bytes`` read from the tensors: the operand alone for the
    exact form (N a multiple of 128 rows, so nothing is padded), plus the
    norms once the fast form has read the train; kept after the train is
    freed. The cache is keyed by the device as named (``cpu:0``, like
    ``cuda``, is not the name its tensors give). On the CPU nothing crosses
    a link: no copy or transpose time."""
    x = integer_train(1024, 128)
    blocks_of(monkeypatch, 300, 128)
    cache = {("labels", str(dev)): torch.zeros(1024, dtype=torch.int32)}
    train = cuda_knn.route_train(x, dev, cache, "exact", torch.float32)
    rec = cuda_knn.train_residency()
    assert rec["rows"] == 1024 and rec["dim"] == 128
    assert rec["host_bytes"] == x.nbytes == rec["card_bytes"]
    assert rec["blocks"] == 4 and rec["upload_s"] > 0
    assert 0 < rec["stage_s"] <= rec["upload_s"]
    assert rec["copy_s"] is None and rec["transpose_s"] is None
    assert cuda_knn.route_train(x, dev, cache, "fast",  # one per device
                                torch.float32) is train
    rec = cuda_knn.train_residency()
    assert rec["card_bytes"] == x.nbytes + 1024 * 4
    # Padded rows are the operand's too.
    cuda_knn.upload_feature_major(x[:1000], CPU)
    assert cuda_knn.train_residency()["card_bytes"] == 1024 * 128 * 4
    del train, cache
    gc.collect()
    assert cuda_knn.train_residency()["host_bytes"] == 1000 * 128 * 4


@pytest.mark.parametrize("second", ["row_major", "kept"])
def test_a_second_copy_of_the_train_is_counted(second):
    """A row-major train in the device cache beside the operand (the
    layout before the operand was the one copy), or a copy kept with the
    train, reads as two copies: ``card_bytes`` is what the route holds,
    not what the upload made."""
    x = integer_train(1024, 128)
    cache = {}
    if second == "row_major":
        cuda_knn.cached_train(x, CPU, cache)
        train = cuda_knn.route_train(x, CPU, cache, "exact", torch.float32)
    else:
        train = cuda_knn.route_train(x, CPU, cache, "exact", torch.float32)
        cuda_knn._kept_with(train, "rows", lambda: train.contiguous())
        cuda_knn.route_train(x, CPU, cache, "exact", torch.float32)
    rec = cuda_knn.train_residency()
    assert rec["card_bytes"] / rec["host_bytes"] == 2.0


def test_clearing_the_device_cache_frees_the_operand():
    _, train, test = bigann_at_cpu_size(600)
    KNNClassifier(5, device="cpu").fit(train).kneighbors(test)
    held = train.device_cache[("train_operand", "cpu")]
    operand = weakref.ref(cuda_knn.feature_major(held, cache=True))
    holder = weakref.ref(held)
    del held
    train.device_cache.clear()
    gc.collect()
    assert holder() is None and operand() is None


def test_upload_spans_and_counters_with_obs_on(monkeypatch, obs_state):
    """One ``upload`` span per block, nested in ``prepare``; the counters
    add the blocks' bytes and number, and the gauge holds the card's
    bytes."""
    obs.enable()
    _, train, test = bigann_at_cpu_size(1000)
    blocks_of(monkeypatch, 300, 128)
    KNNClassifier(5, device="cpu").fit(train).kneighbors(test)
    spans = obs.tracer().spans()
    uploads = [s for s in spans if s.name == "upload"]
    assert len(uploads) == 4
    assert all(s.parent is not None and s.parent.name == "prepare"
               for s in uploads)
    reg = obs.registry()
    assert reg.counter("knn_train_upload_blocks_total").value == 4
    assert reg.counter("knn_train_upload_bytes_total").value == 1000 * 128 * 4
    assert (reg.gauge("knn_train_card_bytes").value
            == cuda_knn.train_residency()["card_bytes"] == 1024 * 128 * 4)


def test_upload_costs_nothing_with_obs_off(monkeypatch, obs_state):
    """Obs off: no span is made and no metric is registered, but the
    record is kept."""
    obs.disable()

    def no_span(*_a, **_k):
        raise AssertionError("a span was made with obs off")

    monkeypatch.setattr(obs.tracer(), "span", no_span)
    _, train, test = bigann_at_cpu_size(1000)
    blocks_of(monkeypatch, 300, 128)
    KNNClassifier(5, device="cpu").fit(train).kneighbors(test)
    assert obs.registry().instruments() == []
    assert cuda_knn.train_residency()["blocks"] == 4
