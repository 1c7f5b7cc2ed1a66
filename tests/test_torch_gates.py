"""The port's gates (``knn_tpu_torch/gates/``) on the CPU, against the JAX
package's scripts they port.

- ``disabled_overhead --device cpu`` passes in a fresh interpreter, fails
  with its diagnosis under ``KNN_TPU_OBS=1``, and its module, thread and
  instrument name lists are the ones ``scripts/check_disabled_overhead.py``
  names (read from the script's text with ``ast``), ``knn_tpu`` renamed;
- the fixture ladder of ``probes/data.py`` is byte-equal to
  ``scripts/make_fixtures.py``'s;
- the parity sweep's trials are JAX's (``scripts/device_parity_sweep.py``
  run by ``runpy`` with its JAX calls stubbed), its CPU run passes, a wrong
  answer fails it, and its launch rule fails a kernel path that launched
  nothing;
- the parity report passes on the CPU and its oracle/native table is the
  one ``scripts/parity_report.py`` prints;
- the capacity probe's ``prom_cost_sums``, knee rule and verdict give the
  JAX script's results on the same seeded step records and metrics text
  (its ramp loop and verdict statements executed from its source), and a
  client-limited step is never the knee;
- without a card every gate exits non-zero unless given ``--device cpu``.

Each test has its own time limit (:func:`limit`).
"""

import ast
import functools
import io
import math
import os
import re
import runpy
import signal
import subprocess
import sys
import textwrap
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from knn_tpu_torch.gates import capacity_probe as cap
from knn_tpu_torch.gates import device_parity_sweep as sweep
from knn_tpu_torch.gates import disabled_overhead as overhead
from knn_tpu_torch.gates import parity_report
from knn_tpu_torch.probes import data

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"


def limit(seconds: int):
    """Fail the test once it has run ``seconds`` (SIGALRM: the test runs in
    the worker's main thread)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            def on_alarm(signum, frame):
                raise TimeoutError(f"{fn.__name__} passed its {seconds} s "
                                   f"limit")
            old = signal.signal(signal.SIGALRM, on_alarm)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return wrapper
    return deco


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "KNN_TPU_OBS"}
    env.update(extra)
    return env


# -- the disabled-path overhead gate ------------------------------------------


# The timing half's budget is the card's (chip_smoke.py's gates phase): on
# the host the plain versions' medium predict takes ~30 ms alone and ten
# times that beside the other test workers, so the functional run lifts
# the budget through the gate's own override and the next test holds the
# timing check to a budget it cannot meet.
@limit(150)
def test_overhead_gate_passes_in_a_fresh_interpreter():
    out = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.gates.disabled_overhead",
         "--device", "cpu"], cwd=REPO,
        env=_env(KNN_TPU_OVERHEAD_BUDGET_MS="60000"), capture_output=True,
        text=True, timeout=140)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "disabled-overhead: PASS"
    for part in ("functional ok (0 spans, 0 instruments",
                 "workload off-state ok", "devprof off-state ok",
                 "router off-state ok", "workload-capture on-state ok",
                 "cost-accounting on-state ok",
                 "medium-preset predict best-of-5 min"):
        assert any(part in ln for ln in lines), part


@limit(150)
def test_overhead_gate_fails_past_its_budget():
    out = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.gates.disabled_overhead",
         "--device", "cpu"], cwd=REPO,
        env=_env(KNN_TPU_OVERHEAD_BUDGET_MS="0.001"), capture_output=True,
        text=True, timeout=140)
    assert out.returncode == 1
    assert "disabled-overhead: router off-state ok" in out.stdout
    assert re.search(r"FAIL: best-of min [\d.]+ ms exceeds the 0 ms budget",
                     out.stderr), out.stderr


@limit(60)
def test_overhead_gate_refuses_obs_on():
    out = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.gates.disabled_overhead",
         "--device", "cpu"], cwd=REPO, env=_env(KNN_TPU_OBS="1"),
        capture_output=True, text=True, timeout=50)
    assert out.returncode == 1
    assert out.stderr.strip() == (
        "disabled-overhead: FAIL: KNN_TPU_OBS is set; this gate measures "
        "the DISABLED path — unset it")


def _jax_overhead_names():
    """The name lists of scripts/check_disabled_overhead.py, from its AST:
    the tuples of ``for mod in (...)`` loops and ``... in sys.modules``
    tests (modules), and the arguments of ``t.name.startswith`` (threads)
    and ``i.name.startswith`` (instruments), in source order."""
    tree = ast.parse((SCRIPTS / "check_disabled_overhead.py").read_text())
    found = {"modules": [], "threads": [], "instruments": []}
    nodes = sorted((n for n in ast.walk(tree) if hasattr(n, "lineno")),
                   key=lambda n: (n.lineno, n.col_offset))
    for node in nodes:
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Name)
                and node.target.id == "mod"):
            found["modules"].append(ast.literal_eval(node.iter))
        elif (isinstance(node, ast.Compare)
              and isinstance(node.left, ast.Constant)
              and isinstance(node.ops[0], ast.In)
              and ast.unparse(node.comparators[0]) == "sys.modules"):
            found["modules"].append(node.left.value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "startswith"):
            owner = ast.unparse(node.func.value)
            kind = {"t.name": "threads", "i.name": "instruments"}.get(owner)
            if kind:
                found[kind].append(ast.literal_eval(node.args[0]))
    return found


def _renamed(value):
    if isinstance(value, tuple):
        return tuple(_renamed(v) for v in value)
    return re.sub(r"^knn_tpu(?=\.)", "knn_tpu_torch", value)


@pytest.mark.parametrize("kind, port", [
    ("modules", [overhead.DEVICE_TAIL_MODULES, overhead.SHARD_MODULES,
                 overhead.FLEET_MODULES, overhead.CONTROL_MODULES,
                 overhead.HISTORY_MODULES,
                 "knn_tpu_torch.control.autoscale",
                 overhead.HISTORY_MODULES]),
    ("threads", [overhead.LAYER_THREAD_PREFIXES,
                 overhead.ROUTER_BOOTSTRAP_THREAD,
                 overhead.ROUTER_AUTOSCALE_THREAD,
                 overhead.ROUTER_HISTORY_THREADS]),
    ("instruments", ["knn_cache_", overhead.LAYER_INSTRUMENT_PREFIXES,
                     overhead.ROUTER_INSTRUMENT_PREFIX]),
])
@limit(30)
def test_overhead_name_lists_are_the_jax_scripts(kind, port):
    jax_lists = _jax_overhead_names()[kind]
    assert [_renamed(v) for v in jax_lists] == port
    # Every module the gate names exists in the port: nothing was renamed
    # away (RENAMED maps only the checks whose subject changed role).
    if kind == "modules":
        import importlib.util

        names = {m for v in port for m in (v if isinstance(v, tuple)
                                           else (v,))}
        for name in names:
            assert importlib.util.find_spec(name) is not None, name
    assert set(overhead.RENAMED) == {
        "knn_tpu.obs.devprof.install_compile_listeners",
        "knn_tpu.models.knn.query_buckets", "bench._load_medium"}


# -- the fixture ladder ---------------------------------------------------------


@pytest.mark.parametrize("size", ["small", "medium", "large"])
@limit(120)
def test_fixtures_are_byte_equal_to_make_fixtures(size, tmp_path):
    make = runpy.run_path(str(SCRIPTS / "make_fixtures.py"))["make"]
    make(size, tmp_path / "jax")
    paths = data.fixture_paths(size, tmp_path / "port")
    for path in paths:
        assert path.read_bytes() == (tmp_path / "jax" / path.name).read_bytes()
    x, y, tx, ty = data.fixture(size)
    assert (x.shape[0], tx.shape[0], x.shape[1]) == data.SIZES[size]


# -- the device parity sweep ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_sweep_draws():
    """The problems scripts/device_parity_sweep.py draws in its first 6
    trials: its source run by runpy, its JAX imports stubbed (the stub
    oracle records its inputs; every path answers as the oracle does)."""
    drawn = []

    def oracle(train_x, train_y, test_x, k, c):
        drawn.append((train_x.copy(), train_y.copy(), test_x.copy(), k, c))
        return np.zeros(test_x.shape[0], np.int32)

    def path(train_x, train_y, test_x, *args, **kwargs):
        return np.zeros(test_x.shape[0], np.int32)

    stubs = {
        "jax": types.SimpleNamespace(devices=lambda: [
            types.SimpleNamespace(device_kind="stub")]),
        "knn_tpu.backends.oracle": types.SimpleNamespace(knn_oracle=oracle),
        "knn_tpu.backends.tpu": types.SimpleNamespace(predict_arrays=path),
        "knn_tpu.ops.pallas_knn": types.SimpleNamespace(predict_pallas=path),
        "knn_tpu.parallel.query_sharded": types.SimpleNamespace(
            predict_query_sharded=path),
        "knn_tpu.parallel.train_sharded": types.SimpleNamespace(
            predict_train_sharded=path),
    }
    saved = {name: sys.modules.get(name) for name in stubs}
    sys.modules.update(stubs)
    try:
        ns = runpy.run_path(str(SCRIPTS / "device_parity_sweep.py"))
        with redirect_stdout(io.StringIO()):
            assert ns["main"](6) == 0
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
    return drawn


@pytest.mark.parametrize("trial", range(6))
@limit(60)
def test_sweep_draws_jax_problems(jax_sweep_draws, trial):
    rng = np.random.default_rng(sweep.SEED)
    for t in range(trial + 1):
        train_x, train_y, test_x, k, c, meta = sweep.draw_trial(rng, t)
    jx, jy, jq, jk, jc = jax_sweep_draws[trial]
    assert np.array_equal(train_x, jx, equal_nan=True)
    assert np.array_equal(train_y, jy)
    assert np.array_equal(test_x, jq, equal_nan=True)
    assert (k, c) == (jk, jc)
    assert np.isnan(train_x).any() == (trial % 3 == 0)


def test_sweep_paths_answer_for_every_jax_path():
    src = (SCRIPTS / "device_parity_sweep.py").read_text()
    jax_paths = re.findall(r'^\s+"([a-z0-9-]+)": lambda', src, re.M)
    assert [v[0] for v in sweep.PATHS.values()] == jax_paths


@limit(120)
def test_sweep_cpu_run_passes():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = sweep.main(["2", "--bigk-trials", "1", "--device", "cpu"])
    assert rc == 0, out.getvalue()
    text = out.getvalue()
    assert "2 trials x 8 paths ALL EXACT" in text
    assert "k > 16 block: 1 trials x 3 paths ALL EXACT" in text


@limit(120)
def test_sweep_fails_a_wrong_answer(monkeypatch):
    from knn_tpu_torch.ops import tile_knn

    real = tile_knn.predict_tile

    def wrong(*args, **kwargs):
        preds = real(*args, **kwargs)
        return preds + (kwargs.get("precision") == "bf16")

    monkeypatch.setattr(tile_knn, "predict_tile", wrong)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = sweep.main(["1", "--bigk-trials", "0", "--device", "cpu"])
    assert rc == 1
    fails = re.findall(r"FAIL trial 0 \[([a-z0-9-]+)\]", out.getvalue())
    assert fails == ["tile-bf16"]


@limit(120)
def test_sweep_launch_rule_fails_a_kernel_path_that_launched_nothing():
    # On the host no kernel launches: held to the card's rule, every
    # kernel path fails and the torch-op paths pass.
    launches = {"sweep": {name: dict.fromkeys(
        ("stripe_scan", "stripe_merge", "tile_exact", "tile_fast",
         "tile_bf16"), 0) for name in sweep.PATHS}}
    out = io.StringIO()
    with redirect_stdout(out):
        failures = sweep._run_block(
            "sweep", np.random.default_rng(sweep.SEED), 0, 1, sweep.PATHS,
            {}, torch.device("cpu"), True, launches)
    kernel_paths = [n for n, (_j, need) in sweep.PATHS.items() if need]
    assert failures == len(kernel_paths) == 6
    named = re.findall(r"FAIL trial 0 \[([a-z0-9-]+)\].*no launch",
                       out.getvalue())
    assert named == kernel_paths


# -- the parity report ----------------------------------------------------------


def _table(text):
    """The markdown rows without the ms column."""
    rows = []
    for line in text.splitlines():
        if line.startswith("| ") and "---" not in line:
            cells = [c.strip() for c in line.strip("|").split("|")]
            rows.append(cells[:4] + cells[5:])
    return rows


@limit(120)
def test_parity_report_cpu_run_passes():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = parity_report.main(["--device", "cpu"])
    assert rc == 0, out.getvalue()
    rows = _table(out.getvalue())[1:]
    assert len(rows) == 15
    assert {r[2] for r in rows} == {"oracle", "native", "native-mt", "cuda",
                                    "cuda-tile"}
    assert all(r[4] in ("oracle", "==") for r in rows)
    assert "all 15 runs prediction-identical (synthetic fixtures)" in \
        out.getvalue()


@limit(150)
def test_parity_report_table_is_the_jax_scripts():
    jax = subprocess.run(
        [sys.executable, str(SCRIPTS / "parity_report.py"), "--backends",
         "oracle,native"], cwd=REPO, env=_env(JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=140)
    assert jax.returncode == 0, jax.stderr
    out = io.StringIO()
    with redirect_stdout(out):
        rc = parity_report.main(["--backends", "oracle,native",
                                 "--device", "cpu"])
    assert rc == 0
    want = _table(jax.stdout)
    assert len(want) == 7  # the header and 6 runs
    assert _table(out.getvalue()) == want
    assert out.getvalue().splitlines()[-1] == jax.stdout.splitlines()[-1]


# -- the capacity probe ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_probe():
    """scripts/capacity_probe.py's globals (runpy; its sibling procgroup
    on the path) and the AST of its ``main``."""
    sys.path.insert(0, str(SCRIPTS))
    try:
        ns = runpy.run_path(str(SCRIPTS / "capacity_probe.py"))
    finally:
        sys.path.remove(str(SCRIPTS))
    src = (SCRIPTS / "capacity_probe.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return ns, src, main


def _seeded_steps(seed: int, n: int = 14):
    """Step records (all fields but the rate, which the ramp sets): clean
    steps with a drifting latency, then saturation of a seeded kind. A
    collapsed schedule comes with its p50 ballooned, so it is the
    server's and both rules take it as the knee."""
    rng = np.random.default_rng(seed)
    base = float(rng.uniform(5, 80))
    kind = rng.choice(["shed", "collapse", "blowup", "none"])
    at = int(rng.integers(1, n))
    out = []
    for i in range(n):
        p50 = round(base * float(rng.uniform(0.8, 1.3)), 1)
        p99 = round(p50 * float(rng.uniform(1.1, 2.5)), 1)
        rec = {"fired": int(rng.integers(5, 500)), "missed": 0, "ok": 0,
               "shed_429": 0, "other": 0,
               "shed_frac": round(float(rng.uniform(0, 0.05)), 4),
               "missed_frac": round(float(rng.uniform(0, 0.25)), 4),
               "p50_ms": p50, "p99_ms": p99}
        if i >= at and kind == "shed":
            rec["shed_frac"] = round(float(rng.uniform(0.051, 0.9)), 4)
        elif i >= at and kind == "collapse":
            rec["missed_frac"] = round(float(rng.uniform(0.26, 0.9)), 4)
            rec["p50_ms"] = round(base * float(rng.uniform(2.5, 9)), 1)
        elif i >= at and kind == "blowup":
            rec["p99_ms"] = round(max(5 * base * 2.5, base * 2.5 + 501)
                                  * float(rng.uniform(1, 3)), 1)
        out.append(rec)
    return out


def _jax_ramp(jax_probe, records, estimate, band_hi):
    """JAX's ramp loop, executed from its source with the client's step
    replaced by the next seeded record at the loop's rate."""
    ns, src, main = jax_probe
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.While)
                and ast.unparse(n.test) == "rate <= max_rate")
    code = textwrap.dedent(ast.get_source_segment(src, loop, padded=True))
    assert "client.run_step(rate, args.step_s)" in code
    code = code.replace("client.run_step(rate, args.step_s)",
                        "fake_step(rate)")
    feed = iter(records)
    env = dict(ns, fake_step=lambda rate: {"rate_qps": round(rate, 2),
                                           **next(feed)},
               steps=[], knee=None, base_p99=None,
               rate=max(1.0, estimate * 0.15),
               max_rate=estimate * band_hi * 1.5, math=math)
    with redirect_stdout(io.StringIO()):
        exec(compile(code, "capacity_probe.py", "exec"), env)
    return env["steps"], env["knee"]


def _port_ramp(monkeypatch, records, estimate, band_hi):
    feed = iter(records)

    class Client:
        def __init__(self, *args, **kwargs):
            pass

        def run_raw(self, rate, step_s):
            return rate, 0, []

        def close(self):
            pass

    monkeypatch.setattr(cap, "OpenLoopClient", Client)
    monkeypatch.setattr(cap, "summarize", lambda rate, *raw: {
        "rate_qps": round(rate, 2), **next(feed)})
    args = types.SimpleNamespace(workers=16, step_s=1.2,
                                 band_hi=band_hi)
    with redirect_stdout(io.StringIO()):
        steps, knee, procs, limited = cap._ramp("http://x", [], args,
                                                estimate)
    assert procs == 1 and limited == []
    return [{k: v for k, v in s.items() if k != "procs"} for s in steps], knee


@pytest.mark.parametrize("seed", range(12))
@limit(30)
def test_capacity_knee_rule_and_verdict_are_the_jax_scripts(
        jax_probe, monkeypatch, seed):
    rng = np.random.default_rng(100 + seed)
    estimate = round(float(rng.uniform(2, 900)), 2)
    records = _seeded_steps(seed)
    want = _jax_ramp(jax_probe, records, estimate, 3.0)
    got = _port_ramp(monkeypatch, records, estimate, 3.0)
    assert got == want
    knee = want[1]
    if knee is None:
        return
    ns, src, main = jax_probe
    stmts = [n for n in ast.walk(main) if isinstance(n, ast.Assign)
             and ast.unparse(n.targets[0]) in ("ratio", "within")]
    assert len(stmts) == 2
    for lo, hi in ((0.2, 3.0), (0.5, 1.5), (1.0, 2.0)):
        env = dict(knee=knee, estimate=estimate,
                   args=types.SimpleNamespace(band_lo=lo, band_hi=hi))
        exec(compile(ast.Module(body=stmts, type_ignores=[]), "jax", "exec"),
             env)
        assert cap.verdict(knee["measured_qps"], estimate, lo, hi) == (
            env["ratio"], env["within"])


@limit(30)
def test_capacity_client_limited_step_is_never_the_knee(monkeypatch):
    # A collapsed schedule whose p50 stayed flat is the client's: the
    # generator spreads over more processes and the step runs again; the
    # server's collapse after it (p50 ballooned) is the knee.
    flat = {"fired": 10, "missed": 30, "ok": 10, "shed_429": 0, "other": 0,
            "shed_frac": 0.0, "p50_ms": 10.0, "p99_ms": 20.0}
    records = [dict(flat, missed_frac=0.0), dict(flat, missed_frac=0.0),
               dict(flat, missed_frac=0.6),
               dict(flat, missed_frac=0.6, p50_ms=90.0)]
    feed = iter(records)
    spread = []

    class Client:
        def __init__(self, *args, **kwargs):
            pass

        def run_raw(self, rate, step_s):
            return rate, 0, []

        def close(self):
            pass

    class Spread(Client):
        def __init__(self, base, payloads, workers, procs):
            spread.append(procs)
            self.pids = list(range(procs))

    monkeypatch.setattr(cap, "OpenLoopClient", Client)
    monkeypatch.setattr(cap, "SpreadClient", Spread)
    monkeypatch.setattr(cap, "summarize", lambda rate, *raw: {
        "rate_qps": round(rate, 2), **next(feed)})
    args = types.SimpleNamespace(workers=16, step_s=1.2,
                                 band_hi=3.0)
    with redirect_stdout(io.StringIO()):
        steps, knee, procs, limited = cap._ramp("http://x", [], args, 100.0)
    assert spread == [2] and procs == 2
    assert [s["rate_qps"] for s in limited] == [33.75]
    assert [s["rate_qps"] for s in steps] == [15.0, 22.5, 33.75]
    assert knee["reason"] == "client_schedule_collapse"
    assert knee["last_clean_qps"] == 22.5
    assert cap.client_limited(records[2] | {"rate_qps": 1}, "shed", 10.0) \
        is False


@limit(30)
def test_capacity_client_limited_past_max_procs_is_no_knee(monkeypatch):
    # A step the client limits however far the generator spreads: no knee,
    # and the diagnosis names the client, not the headroom model.
    flat = {"fired": 10, "missed": 30, "ok": 10, "shed_429": 0, "other": 0,
            "shed_frac": 0.0, "p50_ms": 10.0, "p99_ms": 20.0}
    feed = iter([dict(flat, missed_frac=0.0)]
                + [dict(flat, missed_frac=0.6)] * 8)
    spread = []

    class Client:
        def __init__(self, *args, **kwargs):
            pass

        def run_raw(self, rate, step_s):
            return rate, 0, []

        def close(self):
            pass

    class Spread(Client):
        def __init__(self, base, payloads, workers, procs):
            spread.append(procs)
            self.pids = list(range(procs))

    monkeypatch.setattr(cap, "OpenLoopClient", Client)
    monkeypatch.setattr(cap, "SpreadClient", Spread)
    monkeypatch.setattr(cap, "summarize", lambda rate, *raw: {
        "rate_qps": round(rate, 2), **next(feed)})
    args = types.SimpleNamespace(workers=16, step_s=1.2, band_hi=3.0)
    with redirect_stdout(io.StringIO()):
        steps, knee, procs, limited = cap._ramp("http://x", [], args, 100.0)
    assert knee is None and procs == cap.MAX_PROCS == 8
    assert spread == [2, 4, 8]
    assert [s["procs"] for s in limited] == [1, 2, 4, 8]
    msg = cap._no_knee(100.0, procs, limited, 3.0)
    assert "the client, not the server, limited the ramp at 22.5 q/s" in msg
    assert "no knee found up to 450.0 q/s" in cap._no_knee(100.0, 1, [], 3.0)


@pytest.mark.parametrize("seed", range(3))
@limit(30)
def test_capacity_prom_cost_sums_are_the_jax_scripts(jax_probe, seed):
    rng = np.random.default_rng(seed)
    lines = ["# HELP knn_cost_device_ms_total device ms by class",
             "# TYPE knn_cost_device_ms_total counter"]
    for cls in ("probe", "ramp", "trickle", "default")[:1 + seed]:
        lines.append(f'knn_cost_device_ms_total{{class="{cls}"}} '
                     f'{float(rng.uniform(0, 1e4))!r}')
    lines += ["knn_cost_dispatch_wall_ms_total "
              f"{float(rng.uniform(0, 1e4))!r}",
              'knn_cost_requests_total{class="probe"} 6']
    text = "\n".join(lines) + "\n"
    assert cap.prom_cost_sums(text) == jax_probe[0]["prom_cost_sums"](text)


def test_capacity_probe_constants_are_the_jax_scripts(jax_probe):
    ns = jax_probe[0]
    for name in ("REQUEST_ROWS", "MAX_BATCH", "SHED_FRAC_KNEE",
                 "MISSED_FRAC_KNEE", "P99_BLOWUP_FACTOR",
                 "P99_BLOWUP_FLOOR_MS", "BOOT_TIMEOUT_S"):
        assert getattr(cap, name) == ns[name], name


# -- no card ----------------------------------------------------------------------


@pytest.mark.parametrize("gate, argv", [
    (sweep, []), (parity_report, []), (cap, ["--short"])])
@limit(30)
def test_gates_need_a_card_unless_told_cpu(gate, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gate.main(argv) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err


@limit(60)
def test_overhead_gate_needs_a_card_unless_told_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.gates.disabled_overhead"],
        cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=50)
    assert out.returncode == 1
    assert "torch.cuda.is_available() is false" in out.stderr
