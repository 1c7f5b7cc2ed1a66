"""The control plane: close the loops the observability plane measures (the
port's copy of ``knn_tpu/control/``). Host code: no controller launches
anything on the card; the autotuner's replay goes through the live
batcher, whose worker launches the kernels as for any request.

Every signal this package acts on already exists — capacity headroom
(:mod:`knn_tpu_torch.obs.capacity`), SLO burn (:mod:`knn_tpu_torch.obs.slo`),
per-class cost attribution (:mod:`knn_tpu_torch.obs.accounting`), the what-if
policy frontier (:mod:`knn_tpu_torch.obs.whatif`) — but until this package the
only closed loop was nprobe (:mod:`knn_tpu_torch.index.probe_policy`). Under
overload the server shed blindly: a ``bulk`` batch job could exhaust the
error budget ``interactive`` traffic needed, and the fleet could neither
tighten quality to stay available nor grow itself.

Four controllers, engaged in the **strict degradation order** documented
in docs/RESILIENCE.md (:data:`knn_tpu_torch.resilience.degrade.DEGRADATION_ORDER`):

1. **scale** (:mod:`.autoscale`) — the router boots replicas through the
   snapshot-bootstrap path before any single replica has to degrade;
2. **shed low priority** (:mod:`.admission`) — lowest-priority request
   classes 429 first (typed :class:`~knn_tpu_torch.resilience.errors.ShedByPolicy`
   with a headroom-derived ``Retry-After``) while protected classes keep
   admitting;
3. **brownout quality** (:mod:`.brownout`) — reversible quality/cost
   knobs walk down a hysteretic ladder (shadow/drift sample rates, ivf
   nprobe toward base, deadline tightening) and walk back up on recovery;
4. **availability** is the last thing to go — the pre-existing
   queue-full :class:`~knn_tpu_torch.resilience.errors.OverloadError` backstop,
   which this package exists to make rare.

Every controller is hysteretic with a cooldown (the
:mod:`knn_tpu_torch.index.probe_policy` shape), every action is audited (an
in-memory ring exported over ``/debug/control`` plus ``knn_control_*``
instruments), and every action is REVERSIBLE — recovery restores the
exact pre-brownout operating point.

Zero-cost-when-disabled contract: nothing imports this package unless a
control flag is set (``--priority``, ``--brownout``,
``--autotune-interval-s``). Flagless serve holds no controller threads,
no ``knn_control_*`` instruments, and no ``knn_tpu_torch.control*``
modules in ``sys.modules`` (``tests/test_torch_control.py`` pins it).
"""
