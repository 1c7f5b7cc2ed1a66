"""The port stands alone: no ``jax``, no ``knn_tpu``, and no quiet fallback
from the kernel to the host."""

import ast
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from knn_tpu_torch import KNNClassifier, KNNRegressor, sweep_k  # noqa: E402
from knn_tpu_torch.data.dataset import Dataset  # noqa: E402
from knn_tpu_torch.models import knn  # noqa: E402
from knn_tpu_torch.ops import _build, cuda_knn, probe_matmul, tile_knn  # noqa: E402
from knn_tpu_torch.resilience.errors import CompileError, DeviceError  # noqa: E402
from tests import fixtures  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def test_import_leaves_jax_and_knn_tpu_out():
    # A subprocess: this test process already imported jax (conftest). It
    # imports every module, then runs --sweep-k and --dump-predictions.
    code = (
        "import sys\n"
        "import knn_tpu_torch, knn_tpu_torch.cli, knn_tpu_torch.ops.cuda_knn\n"
        "import knn_tpu_torch.ops.topk, knn_tpu_torch.utils.windowed\n"
        "import knn_tpu_torch.backends.cuda\n"
        "import knn_tpu_torch.ops.tile_knn, knn_tpu_torch.backends.tile\n"
        "import knn_tpu_torch.backends, knn_tpu_torch.convert\n"
        "import knn_tpu_torch.obs.bench_timing, knn_tpu_torch.ops.probe_matmul\n"
        "import knn_tpu_torch.probes.data, knn_tpu_torch.probes.probe_mnist_r3\n"
        "import knn_tpu_torch.probes.tune_stripe_selection\n"
        "import knn_tpu_torch.models, knn_tpu_torch.models.knn\n"
        "import knn_tpu_torch.resilience, knn_tpu_torch.obs\n"
        "import knn_tpu_torch.obs.export, knn_tpu_torch.obs.instrument\n"
        "import knn_tpu_torch.native, knn_tpu_torch.native.arff_native\n"
        "import knn_tpu_torch.backends.native\n"
        "import knn_tpu_torch.resilience.degrade\n"
        "assert 'native' in knn_tpu_torch.backends.available_backends()\n"
        "import io, os, tempfile\n"
        "tr, te = sys.argv[1:3]\n"
        "dump = os.path.join(tempfile.mkdtemp(), 'p.npy')\n"
        "for argv in ([tr, te, '1', '--sweep-k', '1,3', '--device', 'cpu',\n"
        "              '--dump-predictions', dump],\n"
        "             [tr, te, '3', '--device', 'cpu',\n"
        "              '--dump-predictions', dump],\n"
        "             [tr, te, '3', '2', '--persona', 'multi-thread',\n"
        "              '--metrics-out', os.path.join(os.path.dirname(dump),\n"
        "                                            'm.json')]):\n"
        "    assert knn_tpu_torch.cli.run(argv, stdout=io.StringIO()) == 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'knn_tpu', 'triton'))\n"
        "print(bad)\n"
    )
    d = fixtures.datasets_dir()
    out = subprocess.run([sys.executable, "-c", code,
                          str(d / "small-train.arff"),
                          str(d / "small-test.arff")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_serving_leaves_jax_and_knn_tpu_out():
    # The serving slice: import its modules, save an index through the
    # CLI, serve one request in-process, capture a profile, then look.
    code = (
        "import io, os, sys, tempfile, threading, json, urllib.request\n"
        "import knn_tpu_torch.serve, knn_tpu_torch.serve.server\n"
        "import knn_tpu_torch.serve.cache, knn_tpu_torch.obs.devprof\n"
        "import knn_tpu_torch.obs.reqtrace, knn_tpu_torch.obs.slo\n"
        "import knn_tpu_torch.obs.accounting, knn_tpu_torch.obs.capacity\n"
        "import knn_tpu_torch.obs.drift, knn_tpu_torch.resilience.breaker\n"
        "from knn_tpu_torch import cli\n"
        "from knn_tpu_torch.obs import devprof\n"
        "from knn_tpu_torch.serve import artifact, server\n"
        "tr = sys.argv[1]\n"
        "idx = os.path.join(tempfile.mkdtemp(), 'idx')\n"
        "assert cli.run(['save-index', tr, idx, '--k', '3'],\n"
        "               stdout=io.StringIO()) == 0\n"
        "assert cli.run(['serve', '/no/such/index', '--device', 'cpu']) == 2\n"
        "app = server.ServeApp(artifact.load_index(idx, device='cpu'),\n"
        "                      cost_accounting=True, batch_buckets=(16,))\n"
        "srv = server.make_server(app)\n"
        "threading.Thread(target=srv.serve_forever, daemon=True).start()\n"
        "app.warm((1,))\n"
        "row = app.model.train_.features[:1].tolist()\n"
        "host, port = srv.server_address[:2]\n"
        "req = urllib.request.Request(\n"
        "    f'http://{host}:{port}/predict',\n"
        "    data=json.dumps({'instances': row}).encode(),\n"
        "    headers={'Content-Type': 'application/json'})\n"
        "assert urllib.request.urlopen(req, timeout=30).status == 200\n"
        "assert devprof.capture_for(10)['traceEvents']\n"
        "srv.shutdown(); srv.server_close(); app.close()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'knn_tpu'))\n"
        "print(bad)\n"
    )
    d = fixtures.datasets_dir()
    out = subprocess.run([sys.executable, "-c", code,
                          str(d / "small-train.arff")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_index_family_leaves_jax_and_knn_tpu_out():
    # The index family: import its modules, build a partition through the
    # CLI, serve one request on the ivf rung in-process, then look.
    code = (
        "import io, os, sys, tempfile\n"
        "import knn_tpu_torch.index, knn_tpu_torch.index.ivf\n"
        "import knn_tpu_torch.index.kmeans, knn_tpu_torch.index.probe_policy\n"
        "import knn_tpu_torch.ops.segment_score, knn_tpu_torch.convert\n"
        "from knn_tpu_torch import cli\n"
        "from knn_tpu_torch.serve import artifact, server\n"
        "tr = sys.argv[1]\n"
        "idx = os.path.join(tempfile.mkdtemp(), 'idx')\n"
        "assert cli.run(['save-index', tr, idx, '--k', '3', '--ivf-cells',\n"
        "                '8', '--device', 'cpu'], stdout=io.StringIO()) == 0\n"
        "app = server.ServeApp(artifact.load_index(idx, device='cpu'),\n"
        "                      ivf_probes=2, max_wait_ms=0.0)\n"
        "h = app.batcher.submit(app.model.train_.features[:2], 'predict')\n"
        "h.result(timeout=30)\n"
        "assert h.meta['rung'] == 'ivf', h.meta\n"
        "app.close()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'knn_tpu'))\n"
        "print(bad)\n"
    )
    d = fixtures.datasets_dir()
    out = subprocess.run([sys.executable, "-c", code,
                          str(d / "small-train.arff")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_quality_and_workload_layers_leave_jax_and_knn_tpu_out():
    # The answer-quality and workload slice: import its five modules, serve
    # with shadow scoring, drift and capture on, capture a window, replay it
    # in-process through the CLI, then look.
    code = (
        "import io, os, sys, tempfile\n"
        "import knn_tpu_torch.obs.shedqueue, knn_tpu_torch.obs.drift\n"
        "import knn_tpu_torch.obs.quality, knn_tpu_torch.obs.workload\n"
        "import knn_tpu_torch.obs.replay\n"
        "from knn_tpu_torch import cli\n"
        "from knn_tpu_torch.serve import artifact, server\n"
        "tr = sys.argv[1]\n"
        "tmp = tempfile.mkdtemp()\n"
        "idx = os.path.join(tmp, 'idx')\n"
        "assert cli.run(['save-index', tr, idx, '--k', '3'],\n"
        "               stdout=io.StringIO()) == 0\n"
        "m = artifact.read_manifest(idx)\n"
        "app = server.ServeApp(\n"
        "    artifact.load_index(idx, device='cpu'), max_wait_ms=0.0,\n"
        "    shadow_rate=1.0, drift_rate=1.0,\n"
        "    reference_sketch=artifact.reference_sketch(m),\n"
        "    capture_dir=os.path.join(tmp, 'caps'),\n"
        "    index_version=artifact.index_version(m))\n"
        "app.workload.start()\n"
        "app.batcher.submit(app.model.train_.features[:2],\n"
        "                   'predict').result(timeout=30)\n"
        "assert app.quality.drain(30) and app.workload.drain(30)\n"
        "path = app.workload.stop()['path']\n"
        "assert app.quality_block()['shadow']['scored'] == 1\n"
        "app.close()\n"
        "assert cli.run(['replay', path, '--index', idx, '--device', 'cpu',\n"
        "                '--speed', '0', '--fail-on-divergence'],\n"
        "               stdout=io.StringIO()) == 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'knn_tpu'))\n"
        "print(bad)\n"
    )
    d = fixtures.datasets_dir()
    out = subprocess.run([sys.executable, "-c", code,
                          str(d / "small-train.arff")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_mutable_tier_leaves_jax_and_knn_tpu_out():
    # The mutable tier: import its four modules, serve --mutable on with a
    # device tail, insert, delete, read, compact, reboot from CURRENT.json,
    # then look.
    code = (
        "import io, os, sys, tempfile\n"
        "import knn_tpu_torch.mutable.state, knn_tpu_torch.mutable.engine\n"
        "import knn_tpu_torch.mutable.compact\n"
        "import knn_tpu_torch.mutable.device_tail\n"
        "from knn_tpu_torch import cli\n"
        "from knn_tpu_torch.serve import artifact, server\n"
        "tr = sys.argv[1]\n"
        "tmp = tempfile.mkdtemp()\n"
        "idx = os.path.join(tmp, 'idx')\n"
        "assert cli.run(['save-index', tr, idx, '--k', '3'],\n"
        "               stdout=io.StringIO()) == 0\n"
        "os.environ['KNN_TPU_DEVICE_TAIL'] = 'on'\n"
        "m = artifact.load_index(idx, device='cpu')\n"
        "app = server.ServeApp(m, max_wait_ms=0.0, index_path=idx,\n"
        "                      mutable=True, compact_interval_s=0.0)\n"
        "x = m.train_.features[:2]\n"
        "b = app.batcher\n"
        "b.submit_mutation('insert', {'rows': x, 'values': [0, 1]}\n"
        "                  ).result(timeout=30)\n"
        "b.submit_mutation('delete', {'ids': [0]}).result(timeout=30)\n"
        "b.submit(x, 'predict').result(timeout=30)\n"
        "assert app.compactor.run_once(force=True)['compacted']\n"
        "app.close()\n"
        "base, cur = artifact.resolve_mutable_base(idx)\n"
        "assert cur['generation'] == 1\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'knn_tpu'))\n"
        "print(bad)\n"
    )
    d = fixtures.datasets_dir()
    out = subprocess.run([sys.executable, "-c", code,
                          str(d / "small-train.arff")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_multi_device_slice_leaves_jax_and_knn_tpu_out():
    # The multi-device slice: import its modules (the mesh engines, the
    # collectives and their audit, the launcher and its worker, the shard
    # layer, the fleet aggregation), run the mpi persona and each sharded
    # backend through the CLI, the worker solo, a sharded ServeApp, then
    # look.
    code = (
        "import io, os, sys, tempfile\n"
        "import knn_tpu_torch.parallel, knn_tpu_torch.parallel.mesh\n"
        "import knn_tpu_torch.parallel.collectives\n"
        "import knn_tpu_torch.parallel.comm_audit\n"
        "import knn_tpu_torch.parallel.query_sharded\n"
        "import knn_tpu_torch.parallel.train_sharded\n"
        "import knn_tpu_torch.parallel.ring\n"
        "import knn_tpu_torch.parallel.multihost\n"
        "import knn_tpu_torch.parallel.launch\n"
        "import knn_tpu_torch.shard, knn_tpu_torch.shard.plan\n"
        "import knn_tpu_torch.shard.dispatch, knn_tpu_torch.shard.model\n"
        "import knn_tpu_torch.obs.aggregate\n"
        "from knn_tpu_torch import cli\n"
        "from knn_tpu_torch.parallel import multihost\n"
        "from knn_tpu_torch.serve import artifact, server\n"
        "tr, te = sys.argv[1:3]\n"
        "for extra in (['--persona', 'mpi'],\n"
        "              ['--backend', 'cuda-train-sharded', '--devices', '4'],\n"
        "              ['--backend', 'cuda-ring', '--devices', '3']):\n"
        "    assert cli.run([tr, te, '3', '--device', 'cpu', *extra],\n"
        "                   stdout=io.StringIO()) == 0\n"
        "os.environ[multihost.DEVICE_ENV] = 'cpu'\n"
        "assert multihost._worker_main([tr, te, '3']) == 0\n"
        "idx = os.path.join(tempfile.mkdtemp(), 'idx')\n"
        "assert cli.run(['save-index', tr, idx, '--k', '3'],\n"
        "               stdout=io.StringIO()) == 0\n"
        "app = server.ServeApp(artifact.load_index(idx, device='cpu'),\n"
        "                      max_wait_ms=0.0, shards=2)\n"
        "app.batcher.submit(app.model.train_.features[:2],\n"
        "                   'predict').result(timeout=30)\n"
        "assert app.health()['shard']['num_shards'] == 2\n"
        "app.close()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'knn_tpu'))\n"
        "print(bad)\n"
    )
    d = fixtures.datasets_dir()
    out = subprocess.run([sys.executable, "-c", code,
                          str(d / "small-train.arff"),
                          str(d / "small-test.arff")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# A path component "knn_tpu" in a string the code uses (not a docstring),
# apart from a "knn_tpu/....py:LINE" reference to the reference's source.
_JAX_PATH = re.compile(r"(^|[/\\])knn_tpu([/\\]|$)")
_SOURCE_REF = re.compile(r"^knn_tpu/[\w/]+\.py:\d+$")


def _code_strings(path):
    """The string constants of ``path`` that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*(REPO / "knn_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
))
def test_no_port_file_reads_a_path_under_knn_tpu(path):
    bad = [s for s in _code_strings(REPO / path)
           if (_JAX_PATH.search(s) or s == "knn_tpu")
           and not _SOURCE_REF.match(s)]
    assert not bad, (path, bad)


def test_native_sources_are_the_ports_own():
    from knn_tpu_torch import native

    for src, _ in native.SOURCES.values():
        assert src.is_relative_to(REPO / "knn_tpu_torch" / "native")
        assert src.exists()
    assert native.BUILD_DIR == REPO / "build" / "knn_tpu_torch" / "native"


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
    ((4, 2, 0), torch.int64),    # k < 1
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
    ((50, 784), (4, 784), 50, -1, "fast"),      # k < 1
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


def _no_card_problem():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (60, 3)).astype(np.float32)
    train = Dataset(x, rng.integers(0, 3, 60).astype(np.int32),
                    raw_targets=rng.normal(size=60).astype(np.float32))
    return train, Dataset(x[:7], np.zeros(7, np.int32))


@pytest.mark.parametrize("engine", ["auto", "stripe", "xla"])
def test_models_without_a_card_raise_and_never_answer_from_the_host(
        monkeypatch, engine):
    """Every model entry asks for the card unless ``device="cpu"`` was
    given: with no card it is a DeviceError, never the host's answer."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, test = _no_card_problem()
    clf = KNNClassifier(k=3, engine=engine).fit(train)
    reg = KNNRegressor(k=3, engine=engine).fit(train)
    calls = [
        lambda: clf.kneighbors(test),
        lambda: clf.kneighbors_async(test),
        lambda: clf.predict_async(test),
        lambda: clf.predict_proba(test),
        lambda: clf.radius_neighbors(test, 1.0),
        lambda: KNNClassifier(k=3, engine=engine,
                              weights="distance").fit(train).predict(test),
        lambda: reg.predict(test),
        lambda: reg.predict_async(test),
        lambda: sweep_k(train, test, [1, 3], engine=engine),
        lambda: knn._kneighbors_arrays(train.features, test.features[:0], 3,
                                       engine=engine),
    ]
    if engine == "auto":
        calls.append(lambda: clf.predict(test))
    for call in calls:
        with pytest.raises(DeviceError, match="device='cpu'"):
            call()
    assert not train.device_cache
    # The same calls on the host answer.
    d, i = KNNClassifier(k=3, engine=engine, device="cpu").fit(
        train).kneighbors(test)
    assert i.shape == (7, 3)
