"""Nothing the benchmark runs loads JAX or the JAX package."""

from __future__ import annotations

import subprocess
import sys

from knnbench import manifest, run


def test_the_check_compares_top_level_names_whole():
    bad = run.forbidden_modules(["jax", "jax.numpy", "jaxlib", "flax.linen",
                                 "knn_tpu", "knn_tpu.ops.pallas_knn"])
    assert bad == ["flax.linen", "jax", "jax.numpy", "jaxlib", "knn_tpu",
                   "knn_tpu.ops.pallas_knn"]
    assert run.forbidden_modules(["knn_tpu_torch", "knn_tpu_torch.models",
                                  "jaxtyping", "numpy", "knnbench.run"]) == []


def _loaded(code: str) -> "list[str]":
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print('\\n'.join(sorted(sys.modules)))"],
        cwd=manifest.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    return out.stdout.split()


def test_the_harness_and_the_program_load_no_jax():
    names = _loaded("import knnbench.run, knnbench.control, knnbench.trace\n"
                    "import knn_tpu_torch.models.knn, knn_tpu_torch.data.dataset")
    assert "knn_tpu_torch" in names
    assert run.forbidden_modules(names) == []


def test_the_reference_imports_nothing_of_the_program():
    names = _loaded("import knnbench.reference")
    assert not [n for n in names if n.split(".")[0].startswith("knn_tpu")]
    source = (manifest.HERE / "reference.py").read_text()
    assert "knn_tpu" not in source
