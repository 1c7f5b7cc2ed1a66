"""The port stands alone: no ``jax``, no ``knn_tpu``, and no quiet fallback
from the kernel to the host."""

import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from knn_tpu_torch.ops import _build, cuda_knn, probe_matmul, tile_knn  # noqa: E402
from knn_tpu_torch.resilience.errors import CompileError, DeviceError  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def test_import_leaves_jax_and_knn_tpu_out():
    # A subprocess: this test process already imported jax (conftest).
    code = (
        "import sys\n"
        "import knn_tpu_torch, knn_tpu_torch.cli, knn_tpu_torch.ops.cuda_knn\n"
        "import knn_tpu_torch.ops.tile_knn, knn_tpu_torch.backends.tile\n"
        "import knn_tpu_torch.backends, knn_tpu_torch.convert\n"
        "import knn_tpu_torch.obs.bench_timing, knn_tpu_torch.ops.probe_matmul\n"
        "import knn_tpu_torch.probes.data, knn_tpu_torch.probes.probe_mnist_r3\n"
        "import knn_tpu_torch.probes.tune_stripe_selection\n"
        "knn_tpu_torch.backends.available_backends()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'knn_tpu', 'triton'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|knn_tpu)(\.|\s|$)",
                        re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*(REPO / "knn_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
))
def test_source_imports_nothing_of_jax(path):
    assert not _FORBIDDEN.search((REPO / path).read_text()), path


class _FakeCudaTensor:
    """Stands in for a CUDA tensor on a host whose torch has no CUDA."""

    def __init__(self, *shape, dtype=torch.float32):
        self.shape = torch.Size(shape)
        self.device = torch.device("cuda", 0)
        self.dtype = dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


def test_wrapper_raises_when_library_is_missing(monkeypatch):
    def missing(name, signatures=None):
        raise CompileError(f"nvcc not found: cannot build {name}")

    monkeypatch.setattr(_build, "load_library", missing)
    before = (cuda_knn.knn_stripe_scan.launches,
              cuda_knn.knn_stripe_merge.launches)
    with pytest.raises(CompileError, match="stripe_knn"):
        cuda_knn.knn_stripe_scan(
            _FakeCudaTensor(50, 7), _FakeCudaTensor(4, 7), 50, 3, 1, 64)
    partial = _FakeCudaTensor(4, 2, 3)
    partial.dtype = torch.int64
    with pytest.raises(CompileError, match="stripe_knn"):
        cuda_knn.knn_stripe_merge(partial)
    assert (cuda_knn.knn_stripe_scan.launches,
            cuda_knn.knn_stripe_merge.launches) == before


@pytest.mark.parametrize("train,test,n_valid,k", [
    ((50, 7), (4, 7), 50, 257),
    ((50, 7), (4, 7), 50, 0),
    ((50, 129), (4, 129), 50, 3),
    ((50, 7), (4, 8), 50, 3),
    ((50, 7), (4, 7), 51, 3),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(
        monkeypatch, train, test, n_valid, k):
    monkeypatch.setattr(_build, "load_library",
                        lambda name, signatures=None: types.SimpleNamespace())
    with pytest.raises(ValueError):
        cuda_knn.knn_stripe_scan(
            _FakeCudaTensor(*train), _FakeCudaTensor(*test), n_valid, k, 1, 64)


@pytest.mark.parametrize("n_valid,n_splits,rows", [
    (50, 0, 64),      # no split
    (50, 1, 32),      # rows past the last split
    (50, 2, 64),      # an empty split
    (50, 65536, 1),   # more splits than the grid takes
])
def test_scan_rejects_splits_that_do_not_cut_the_rows(
        monkeypatch, n_valid, n_splits, rows):
    monkeypatch.setattr(_build, "load_library",
                        lambda name, signatures=None: types.SimpleNamespace())
    with pytest.raises(ValueError, match="splits"):
        cuda_knn.knn_stripe_scan(_FakeCudaTensor(50, 7), _FakeCudaTensor(4, 7),
                                 n_valid, 3, n_splits, rows)


@pytest.mark.parametrize("shape,dtype", [
    ((4, 2, 257), torch.int64),  # k > 256
    ((4, 2, 3), torch.int32),   # not packed keys
    ((4, 6), torch.int64),      # not [Q, splits, k]
])
def test_merge_rejects_what_the_kernel_does_not_take(monkeypatch, shape, dtype):
    monkeypatch.setattr(_build, "load_library",
                        lambda name, signatures=None: types.SimpleNamespace())
    partial = _FakeCudaTensor(*shape)
    partial.dtype = dtype
    with pytest.raises(ValueError):
        cuda_knn.knn_stripe_merge(partial)


def test_tile_wrapper_raises_when_library_is_missing(monkeypatch):
    def missing(name, signatures=None):
        raise CompileError(f"nvcc not found: cannot build {name}")

    monkeypatch.setattr(_build, "load_library", missing)
    before = dict(tile_knn.knn_tile_scan.launches)
    for form in tile_knn.FORMS:
        with pytest.raises(CompileError, match="tile_knn"):
            tile_knn.knn_tile_scan(_FakeCudaTensor(50, 784),
                                   _FakeCudaTensor(4, 784), 50, 3, form, 1, 128)
    assert tile_knn.knn_tile_scan.launches == before


@pytest.mark.parametrize("train,test,n_valid,k,form", [
    ((50, 784), (4, 784), 50, 257, "fast"),     # k > 256
    ((50, 784), (4, 784), 50, 0, "fast"),       # k < 1
    ((50, 784, "bf16"), (4, 784), 50, 3, "exact"),  # bf16 train, exact form
    ((50, 784, "bf16"), (4, 784), 50, 3, "fast"),   # bf16 train, fast form
    ((50, 784), (4, 784, "bf16"), 50, 3, "bf16"),   # bf16 queries
    ((50, 784), (4, 783), 50, 3, "bf16"),       # feature counts differ
    ((50, 784), (4, 784), 51, 3, "exact"),      # n_valid past the rows
    ((50, 784), (4, 784), 50, 3, "tf32"),       # no such form
])
def test_tile_wrapper_rejects_what_the_kernel_does_not_take(
        monkeypatch, train, test, n_valid, k, form):
    monkeypatch.setattr(_build, "load_library",
                        lambda name, signatures=None: types.SimpleNamespace())

    def fake(shape):
        *dims, dtype = shape if shape[-1] == "bf16" else (*shape, "f32")
        return _FakeCudaTensor(*dims, dtype=torch.bfloat16 if dtype == "bf16"
                               else torch.float32)

    before = dict(tile_knn.knn_tile_scan.launches)
    with pytest.raises(ValueError):
        tile_knn.knn_tile_scan(fake(train), fake(test), n_valid, k, form, 1, 128)
    with pytest.raises(ValueError):
        tile_knn.knn_tile_candidates(fake(train), fake(test), n_valid, k, form)
    assert tile_knn.knn_tile_scan.launches == before


@pytest.mark.parametrize("form", ["exact", "fast", "bf16"])
def test_tile_wrapper_rejects_host_and_card_mix(monkeypatch, form):
    monkeypatch.setattr(_build, "load_library",
                        lambda name, signatures=None: types.SimpleNamespace())
    with pytest.raises(ValueError, match="CUDA device"):
        tile_knn.knn_tile_scan(torch.zeros(50, 7), _FakeCudaTensor(4, 7), 50,
                               3, form, 1, 128)
    with pytest.raises(ValueError, match="CUDA device"):
        tile_knn.knn_tile_candidates(_FakeCudaTensor(50, 7), torch.zeros(4, 7),
                                     50, 3, form)


def test_tile_scan_rejects_splits_that_do_not_cut_the_rows(monkeypatch):
    monkeypatch.setattr(_build, "load_library",
                        lambda name, signatures=None: types.SimpleNamespace())
    with pytest.raises(ValueError, match="splits"):
        tile_knn.knn_tile_scan(_FakeCudaTensor(300, 9), _FakeCudaTensor(4, 9),
                               300, 3, "fast", 2, 128)


def test_new_wrappers_raise_when_library_is_missing(monkeypatch):
    def missing(name, signatures=None):
        raise CompileError(f"nvcc not found: cannot build {name}")

    monkeypatch.setattr(_build, "load_library", missing)
    before = (dict(cuda_knn.knn_stripe_scan_variant.launches),
              probe_matmul.pure_matmul.launches)
    for mode in cuda_knn.SELECT_MODES:
        with pytest.raises(CompileError, match="stripe_knn"):
            cuda_knn.knn_stripe_scan_variant(
                _FakeCudaTensor(50, 7), _FakeCudaTensor(4, 7), 50, 3, mode, 1, 64)
    with pytest.raises(CompileError, match="probe_matmul"):
        probe_matmul.pure_matmul(_FakeCudaTensor(64, 784, dtype=torch.bfloat16),
                                 _FakeCudaTensor(4, 784, dtype=torch.bfloat16),
                                 1024)
    assert (cuda_knn.knn_stripe_scan_variant.launches,
            probe_matmul.pure_matmul.launches) == before


@pytest.mark.parametrize("train,test,n_valid,k,mode", [
    ((50, 7), (4, 7), 50, 17, "rounds"),   # the variants stop at k = 16
    ((50, 7), (4, 7), 50, 0, "lite"),
    ((50, 7), (4, 7), 50, 3, "insert"),    # not a variant
    ((50, 129), (4, 129), 50, 3, "nosel"),
    ((50, 7), (4, 7), 51, 3, "rounds"),
])
def test_variant_wrapper_rejects_what_the_kernel_does_not_take(
        monkeypatch, train, test, n_valid, k, mode):
    monkeypatch.setattr(_build, "load_library",
                        lambda name, signatures=None: types.SimpleNamespace())
    with pytest.raises(ValueError):
        cuda_knn.knn_stripe_scan_variant(
            _FakeCudaTensor(*train), _FakeCudaTensor(*test), n_valid, k, mode,
            1, 64)


@pytest.mark.parametrize("train,test,block_n", [
    ((64, 784, torch.float32), (4, 784, torch.bfloat16), 1024),  # f32 train
    ((64, 784, torch.bfloat16), (4, 784, torch.float32), 1024),  # f32 queries
    ((64, 784, torch.bfloat16), (4, 783, torch.bfloat16), 1024),  # D differs
    ((64, 0, torch.bfloat16), (4, 0, torch.bfloat16), 1024),      # no features
    ((64, 784, torch.bfloat16), (4, 784, torch.bfloat16), 1020),  # not 8k
])
def test_matmul_wrapper_rejects_what_the_kernel_does_not_take(
        monkeypatch, train, test, block_n):
    monkeypatch.setattr(_build, "load_library",
                        lambda name, signatures=None: types.SimpleNamespace())
    with pytest.raises(ValueError):
        probe_matmul.pure_matmul(_FakeCudaTensor(*train[:2], dtype=train[2]),
                                 _FakeCudaTensor(*test[:2], dtype=test[2]),
                                 block_n)
    with pytest.raises(ValueError, match="CUDA device"):
        probe_matmul.pure_matmul(torch.zeros(64, 8, dtype=torch.bfloat16),
                                 _FakeCudaTensor(4, 8, dtype=torch.bfloat16), 64)


def test_build_without_nvcc_is_a_compile_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(CompileError, match="nvcc not found"):
        _build.load_library("stripe_knn")
    with pytest.raises(CompileError, match="nvcc not found"):
        _build.load_library("tile_knn")
    with pytest.raises(CompileError, match="nvcc not found"):
        _build.load_library("probe_matmul")
    with pytest.raises(CompileError, match="nvcc not found"):
        _build.build_all()


def test_library_name_tracks_the_sources():
    lib = _build.library_path("stripe_knn")
    assert lib.parent == REPO / "build" / "knn_tpu_torch"
    assert re.fullmatch(r"libstripe_knn-[0-9a-f]{16}\.so", lib.name)
    assert re.fullmatch(r"libtile_knn-[0-9a-f]{16}\.so",
                        _build.library_path("tile_knn").name)
    assert re.fullmatch(r"libprobe_matmul-[0-9a-f]{16}\.so",
                        _build.library_path("probe_matmul").name)
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_resolve_device_never_falls_back(monkeypatch):
    assert cuda_knn.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        cuda_knn.resolve_device("cuda")
    with pytest.raises(ValueError):
        cuda_knn.resolve_device("meta")
