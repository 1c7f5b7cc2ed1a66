# Build + backend-selection convention, preserving the reference's
# target-per-backend interface (reference Makefile:1-9: main | multi-thread |
# mpi | clean) and adding the native libs and the tpu target. Each backend
# target emits a wrapper script with the reference's positional CLI.

CXX      ?= g++
CXXFLAGS ?= -O3 -std=c++17 -fPIC -Wall -Wextra
LIB_DIR  := knn_tpu/native/lib

.PHONY: all native main multi-thread mpi tpu datasets test verify chaos serve-smoke chaos-soak quality-soak ivf-soak mutable-soak fleet-soak shard-soak overload-soak capacity-probe replay-gate bench bench-gate parity device-parity ref-diff verify-torch capacity-probe-torch device-parity-torch parity-torch clean

all: native main multi-thread mpi tpu datasets

# Synthetic fixture ladder with the reference datasets' shape characteristics
# (SURVEY.md §2.4) — generated, not copied, so a standalone checkout has
# runnable data for the README quick start. Freshness lives in the script
# (--if-stale: regenerate only when a file is missing or older than the
# generator) so this works on any make and is parallel-safe.
FIXTURES := $(foreach s,small medium large,$(foreach t,train test,datasets/$(s)-$(t).arff))

datasets:
	python3 scripts/make_fixtures.py --if-stale datasets

native: $(LIB_DIR)/libknn_arff.so $(LIB_DIR)/libknn_runtime.so

$(LIB_DIR)/libknn_arff.so: knn_tpu/native/arff/arff_c.cc
	@mkdir -p $(LIB_DIR)
	$(CXX) $(CXXFLAGS) -shared -o $@ $< -lpthread

$(LIB_DIR)/libknn_runtime.so: knn_tpu/native/runtime/knn_runtime.cc
	@mkdir -p $(LIB_DIR)
	$(CXX) $(CXXFLAGS) -shared -o $@ $< -lpthread

# Wrapper scripts: ./main train test k | ./multi-thread train test k T |
# ./mpi train test k | ./tpu train test k
define WRAPPER
	@printf '#!/bin/sh\nexec python3 -m knn_tpu.cli --persona $(1) "$$@"\n' > $(2)
	@chmod +x $(2)
	@echo "wrote ./$(2)"
endef

main: native
	$(call WRAPPER,main,main)

multi-thread: native
	$(call WRAPPER,multi-thread,multi-thread)

mpi:
	$(call WRAPPER,mpi,mpi)

tpu:
	$(call WRAPPER,tpu,tpu)

test:
	python3 -m pytest tests/ -q

# The tier-1 gate (ROADMAP.md): the not-slow suite on CPU with the 8-device
# virtual mesh, plus a bytecode-compile of the package so syntax errors in
# rarely-imported modules can't hide, plus the disabled-path overhead gate
# (observability/tracing must record NOTHING and cost ~nothing while off —
# docs/OBSERVABILITY.md §Overhead). CI runs exactly this target.
verify:
	python3 -m compileall -q knn_tpu bench.py
	JAX_PLATFORMS=cpu python3 -m pytest tests/ -q -m 'not slow' \
		--continue-on-collection-errors -p no:cacheprovider
	JAX_PLATFORMS=cpu python3 scripts/check_disabled_overhead.py

# The chaos gate (docs/RESILIENCE.md): the deterministic fault-injection
# suite — every (fault point, mode) pair must end in recovery with
# bit-identical predictions or a typed error, never a raw traceback.
# KNN_TPU_RETRY_BASE_MS=0 removes backoff sleeps so chaos runs at full
# speed; the schedule itself is covered by unit tests.
chaos:
	JAX_PLATFORMS=cpu KNN_TPU_RETRY_BASE_MS=0 python3 -m pytest \
		tests/test_resilience.py tests/test_arff_malformed.py -q \
		-p no:cacheprovider

# The serving lifecycle gate (docs/SERVING.md): build a fixture index,
# boot `knn_tpu serve` as a subprocess, probe /predict (bit-identical to
# the in-process model) + /healthz + /metrics, then SIGINT and require a
# clean exit. stdlib-only probing; covers what the in-process server
# tests cannot (signals, the ready banner, a real ephemeral-port bind).
serve-smoke:
	JAX_PLATFORMS=cpu python3 scripts/serve_smoke.py

# The self-healing gate (docs/SERVING.md §Ops runbook): boot the server
# under a seeded fault burst, hammer it with concurrent closed-loop
# clients, and assert the soak invariants — every request one terminal
# outcome with a request_id that resolves to a consistent flight-recorder
# timeline, 200s bit-identical to the oracle, no traceback bodies, the
# breaker opens then re-closes with availability back to 100%, the SLO
# burn rate rises under the burst and recovers to ~0, and a final SIGTERM
# under load drains cleanly (exit 0). Short mode ~20 s. The per-request
# Perfetto trace lands in build/ (CI uploads it as a workflow artifact).
chaos-soak:
	JAX_PLATFORMS=cpu KNN_TPU_RETRY_BASE_MS=0 python3 scripts/chaos_soak.py \
		--short --perfetto-out build/chaos-soak-trace.json

# The answer-quality gate (docs/OBSERVABILITY.md §Quality & drift): boot
# the server with shadow scoring at rate 1.0 under the chaos-soak fault
# burst and assert (1) the recall SLI holds exactly 1.0 across every
# exact rung the burst exercised — any divergence is a real bug — then
# (2) inject index corruption via the SIGUSR2 test hook and assert the
# quality burn rate rises and /debug/quality localizes it to the
# answering rung. The verdict JSON lands in build/ (CI uploads it).
quality-soak:
	JAX_PLATFORMS=cpu KNN_TPU_RETRY_BASE_MS=0 python3 scripts/quality_soak.py \
		--short --json-out build/quality-soak-verdict.json

# The approximate-serving gate (docs/INDEXES.md): build a format-3 IVF
# artifact over the large fixture and assert both enforced promises —
# (1) speed x recall: under identical closed-loop load with shadow
# scoring at rate 1.0, the ivf rung sustains >= 3x the exact fast rung's
# row throughput while the shadow-scored recall SLI on the ivf rung
# holds >= the recall floor; (2) the quality loop closes: with nprobe
# starved to 1 the quality burn rises above 1, the probe policy widens
# toward exact, and the short-window burn recovers. The verdict JSON
# lands in build/ (CI uploads it as a workflow artifact).
ivf-soak:
	JAX_PLATFORMS=cpu python3 scripts/ivf_soak.py --short \
		--json-out build/ivf-soak-verdict.json

# The online-mutation gate (docs/INDEXES.md §Mutable tier): boot serve
# --mutable on and assert the four mutable contracts — (1) under the
# chaos fault burst, every read's indices are bit-identical to an oracle
# replay of the acknowledged mutation history at that read's
# mutation_seq (distances inside float32 ulp — the rung-form rule) and
# write-to-visible freshness p99 stays bounded; (2) a compaction swap
# under concurrent load is atomic (every response carries exactly the
# old or the new index_version) and replay holds across the fold in
# BOTH generations' positional spaces; (3) a fault-armed compaction
# rolls back with the old generation serving and every write intact;
# (4) a SIGKILL mid-compaction recovers with zero acknowledged writes
# lost. The verdict JSON lands in build/ (CI uploads it).
mutable-soak:
	JAX_PLATFORMS=cpu KNN_TPU_RETRY_BASE_MS=0 python3 scripts/mutable_soak.py \
		--short --json-out build/mutable-soak-verdict.json

# The replica-set gate (docs/SERVING.md §Running a replica set): 3
# mutable replicas (primary + 2 WAL-shipped followers) behind a
# `knn_tpu route` router with auto-failover. Four legs — (1) a follower's
# process group is SIGKILLed under concurrent load: ZERO failed reads,
# every read bit-identical to the oracle replay of the primary's durable
# WAL; (2) the PRIMARY is SIGKILLed: writes 503 typed until the router
# promotes the most-caught-up follower, then resume, with zero
# acknowledged writes lost (every acked (seq, rows) pair present
# bit-identical in the new primary's WAL); (3) the ex-primary rejoins as
# a follower — unacked tail truncated at the takeover seq, catch-up over
# wal-append with no divergence; (4) a crash-stopped replica aborts a
# coordinated reload all-or-nothing (rolled back fleet-wide), and the
# retry flips every replica. The verdict JSON lands in build/ (CI
# uploads it).
fleet-soak:
	JAX_PLATFORMS=cpu KNN_TPU_RETRY_BASE_MS=0 python3 scripts/fleet_soak.py \
		--short --json-out build/fleet-soak-verdict.json

# Mesh-sharded serving held to its contracts (docs/SERVING.md §Sharded
# serving): a --shards 2 serve vs an unsharded twin under closed-loop
# load (bit-identity live, not just in tests), mutation lockstep over
# the sharded delta tail, straggler gauges on every surface, and the
# shard-group kill drill behind the router.
shard-soak:
	JAX_PLATFORMS=cpu KNN_TPU_RETRY_BASE_MS=0 python3 scripts/shard_soak.py \
		--short --json-out build/shard-soak-verdict.json

# The overload gate (docs/RESILIENCE.md §Degradation order): the control
# plane under fire, both halves. Phase 1 drives one replica past its
# queue bound with mixed-class clients and asserts the ladder engages in
# order and reverses — bulk sheds with the typed policy 429 (interactive
# never does), every overload response carries Retry-After >= 1 s, the
# brownout ladder applies then fully reverts (apply == revert, level 0),
# the admission cutoff restores, and the SLO layer counted the sheds in
# policy_sheds. Phase 2 puts a router with --scale-cmd over two live
# replicas plus an empty slot and asserts the autoscaler drives `up` at
# the slot under load and `down` at a live non-primary replica when the
# load stops, with the full begin/complete audit trail in the fleet
# event log. The verdict JSON lands in build/ (CI uploads it).
overload-soak:
	JAX_PLATFORMS=cpu KNN_TPU_RETRY_BASE_MS=0 python3 scripts/overload_soak.py \
		--short --json-out build/overload-soak-verdict.json

# The cost & capacity gate (docs/OBSERVABILITY.md §Cost & capacity): boot
# serve with cost accounting on and assert (1) every 200's timeline
# carries an attributed cost block, (2) attribution CONSERVES — summed
# per-class knn_cost_device_ms_total equals the measured dispatch walls
# to float tolerance, from both /debug/capacity and the Prometheus text —
# and (3) an open-loop ramp finds the real load knee within the
# documented tolerance band of the headroom model's low-load
# sustainable-QPS estimate. The verdict JSON lands in build/ (CI uploads
# it as a workflow artifact).
capacity-probe:
	JAX_PLATFORMS=cpu python3 scripts/capacity_probe.py --short \
		--json-out build/capacity-probe-verdict.json

# The workload replay gate (docs/OBSERVABILITY.md §Workload capture &
# replay): capture a seeded bursty open-loop workload (reads + an
# insert/delete stream) against a live in-process mutable serving stack,
# replay it against a pristine byte-identical twin, and assert — zero
# read/mutation errors, every replayed mutation on its captured
# mutation_seq, ZERO answer divergences at matching index_version/
# mutation_seq (bit-identical digests), and the what-if simulator's
# predicted p50 for the live policy within the documented band of the
# measured replay p50. The verdict JSON (including a candidate-policy
# frontier) lands in build/ (CI uploads it as a workflow artifact).
replay-gate:
	JAX_PLATFORMS=cpu python3 scripts/replay_gate.py \
		--json-out build/replay-gate-verdict.json

bench:
	python3 bench.py

# The perf-regression gate (docs/OBSERVABILITY.md §Device & fleet):
# measure the CPU-runnable gate record (bench.bench_gate_config — medium
# predict/kneighbors walls, serving c8 p50, ingest) and compare it
# against this environment's committed baseline with the best-of-mins +
# MAD-tolerance rule (knn_tpu/obs/regress.py). No baseline for this
# environment -> unarmed pass with a candidate record saved; refresh a
# baseline with `python3 scripts/bench_gate.py --write-baseline`. The
# verdict JSON lands in build/ (CI uploads it as a workflow artifact).
bench-gate:
	JAX_PLATFORMS=cpu python3 scripts/bench_gate.py \
		--out build/bench_gate_verdict.json

parity:
	python3 scripts/parity_report.py

device-parity:
	python3 scripts/device_parity_sweep.py

ref-diff:
	python3 scripts/reference_differential.py

# The PyTorch/CUDA port's gates (knn_tpu_torch/gates/), beside JAX's: each
# imports torch and the port only, and runs on the card unless given
# --device cpu. verify-torch is the port's tier-1 gate on the CPU: a
# bytecode-compile of the package, the port's tests and the disabled-path
# overhead gate (every layer zero-cost while off).
verify-torch:
	python3 -m compileall -q knn_tpu_torch
	JAX_PLATFORMS=cpu python3 -m pytest tests/test_torch_*.py -q \
		-m 'not slow' --continue-on-collection-errors -p no:cacheprovider
	python3 -m knn_tpu_torch.gates.disabled_overhead --device cpu

# The knee of a live `knn_tpu_torch serve` against the headroom model.
capacity-probe-torch:
	python3 -m knn_tpu_torch.gates.capacity_probe --short \
		--json-out build/capacity-probe-torch-verdict.json

# Random problems through every card route, exact against the oracle.
device-parity-torch:
	python3 -m knn_tpu_torch.gates.device_parity_sweep

# Every backend over the dataset ladder x k, against the oracle.
parity-torch:
	python3 -m knn_tpu_torch.gates.parity_report

clean:
	rm -rf $(LIB_DIR) main multi-thread mpi tpu build/fixtures
	rm -f $(FIXTURES)
	-rmdir datasets 2>/dev/null
