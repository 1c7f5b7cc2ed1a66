"""Background compaction: fold delta + tombstones into a fresh generation
(the port of ``knn_tpu/mutable/compact.py``).

The LSM merge step (PAPERS.md: O'Neil et al. 1996; Fresh-DiskANN's
StreamingMerge): a worker folds the sealed delta tier and tombstones into
a brand-new immutable base — surviving base rows in their original order,
then surviving delta rows in insert order (the DETERMINISTIC id
assignment an oracle replay of the history reproduces) — re-runs IVF cell
assignment when the serving index is partitioned (on the model's device),
saves the result as an ordinary artifact generation (``serve/artifact.py``)
with the JAX package's backend names, so either package loads it, warms it
OFF the serving path, and swaps it through ``MicroBatcher.swap_model`` with
the engine rebase executed inside the same critical section.

Failure semantics (the hot-reload rollback contract, extended):

- any failure BEFORE the swap leaves the old generation serving and the
  sealed epoch's records on disk — nothing acknowledged is lost, the
  next attempt re-folds from scratch (``knn_mutable_compactions_total
  {outcome="rolled_back"}``);
- the COMMIT POINT is the atomic ``CURRENT.json`` replace: a process
  killed anywhere before it boots from the old base and replays every
  epoch record; killed after it boots from the new generation and
  replays only the records past ``folded_seq``;
- mid-compaction writes land in the fresh epoch the seal opened and are
  re-anchored onto the new base by the rebase — zero acknowledged writes
  lost.

A seeded fault point (``mutable.compact``) sits between warmup and swap
so the rollback path can be proven without timing luck. A successful
result carries ``split_ms``: the wall of each step (seal, fold, save,
warm, swap, commit).

``retention_floor`` and ``defer`` (the fleet's WAL retention and the
control plane's brownout gate) are kept for ROADMAP A12; nothing passes
them yet.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.data.dataset import Dataset
from knn_tpu_torch.models.knn import KNNClassifier, KNNRegressor
from knn_tpu_torch.resilience import faults
from knn_tpu_torch.serve import artifact

#: Incremental IVF compaction falls back to a full k-means rebuild when
#: the assignment-only partition's imbalance (largest cell over the
#: balanced size) crosses this — the point where skewed cells make probe
#: work and recall-per-probe visibly worse than a re-clustered field.
#: KNN_TPU_IVF_REBUILD_IMBALANCE overrides.
IVF_REBUILD_IMBALANCE = 4.0


def _rebuild_imbalance() -> float:
    try:
        return float(os.environ.get("KNN_TPU_IVF_REBUILD_IMBALANCE",
                                    IVF_REBUILD_IMBALANCE))
    except ValueError:
        return IVF_REBUILD_IMBALANCE


def rebuild_ivf(old_ivf, new_train: Dataset, device="cuda"):
    """The compaction IVF step: ``(new_index, path)`` where ``path``
    names which branch ran — ``"incremental"`` (one same-seed assignment
    of the folded rows to the EXISTING centroids) or ``"rebuild"`` (full
    Lloyd's, taken when the incremental partition's cell imbalance
    crosses the threshold, or the fold shrank the row count below the
    cell count). Every fold used to pay the full rebuild; incremental
    assignment makes steady-state compaction O(rows · cells) instead of
    O(rows · cells · iters). The assignment steps run on ``device``."""
    from knn_tpu_torch.index.ivf import IVFIndex

    cells = min(old_ivf.num_cells, new_train.num_instances)
    if cells == old_ivf.num_cells:
        candidate = IVFIndex.assign_to(new_train.features, old_ivf,
                                       device=device)
        if candidate.imbalance() <= _rebuild_imbalance():
            return candidate, "incremental"
    rebuilt = IVFIndex.build(
        new_train.features, cells, seed=int(old_ivf.meta.get("seed", 0)),
        device=device)
    return rebuilt, "rebuild"


class CompactionInProgress(Exception):
    """One compaction at a time (the reload-lock rule); /admin/compact
    maps this to HTTP 409."""


class CompactionCommitFailed(Exception):
    """A POST-SWAP step failed (the CURRENT.json commit): the new
    generation IS serving (swap+rebase succeeded) but the on-disk pointer
    still names the old one. NOT a rollback — and must never be reported
    as one. State stays consistent either way: the sealed epoch's records
    are still on disk, so a reboot loads the old base and replays the
    full acknowledged history; the next successful compaction re-folds
    and commits."""


def fold(base_train: Dataset, fold_input: dict,
         base_stable: np.ndarray) -> "tuple[Dataset, np.ndarray, dict]":
    """Pure fold: ``(new_train, new_base_stable, stats)``.

    Survivors keep their relative order — base rows first (ascending
    position), then live delta rows in insert order — so the new
    positional id space is a deterministic function of the acknowledged
    mutation history, which is exactly what lets an oracle replay verify
    post-compaction answers bit-for-bit."""
    count = fold_input["count"]
    tombs = fold_input["tomb_stable"]
    tomb_arr = (np.fromiter(tombs, np.int64, len(tombs)) if tombs
                else np.empty(0, np.int64))
    base_stable = np.asarray(base_stable, np.int64)
    base_keep = ~np.isin(base_stable, tomb_arr)
    delta_stable = np.asarray(fold_input["stable"][:count], np.int64)
    delta_keep = ~np.isin(delta_stable, tomb_arr)
    feats = np.concatenate([
        base_train.features[base_keep],
        np.asarray(fold_input["features"][:count], np.float32)[delta_keep],
    ])
    delta_vals = np.asarray(fold_input["values"][:count],
                            np.float32)[delta_keep]
    labels = np.concatenate([
        base_train.labels[base_keep],
        delta_vals.astype(base_train.labels.dtype),
    ])
    raw_targets = None
    if base_train.raw_targets is not None:
        raw_targets = np.concatenate([
            base_train.raw_targets[base_keep],
            delta_vals.astype(base_train.raw_targets.dtype),
        ])
    elif not np.array_equal(
            delta_vals.astype(base_train.labels.dtype).astype(np.float32),
            delta_vals):
        # Regression targets a sketch-less base stores as int labels
        # (Dataset.targets falls back to labels): a fractional/negative
        # acked target would silently truncate through the int cast and
        # the same read would answer differently after compaction.
        # Promote to raw_targets so the folded train set serves the
        # exact values the delta tier did.
        raw_targets = np.concatenate([
            base_train.labels[base_keep].astype(np.float32), delta_vals])
    new_train = Dataset(
        features=feats, labels=labels, relation=base_train.relation,
        attributes=list(base_train.attributes), raw_targets=raw_targets,
    )
    new_stable = np.concatenate([
        np.asarray(base_stable, np.int64)[base_keep],
        delta_stable[delta_keep],
    ])
    stats = {
        "base_kept": int(base_keep.sum()),
        "base_dropped": int((~base_keep).sum()),
        "delta_folded": int(delta_keep.sum()),
        "delta_dropped": int((~delta_keep).sum()),
        "rows": int(new_stable.shape[0]),
    }
    return new_train, new_stable, stats


def clone_fitted(model, train: Dataset):
    """A fresh model with the serving model's hyperparameters, fitted on
    the folded train set (compaction must not inherit device caches or
    any state tied to the old base); it runs on the serving model's
    device."""
    if isinstance(model, KNNClassifier):
        fresh = KNNClassifier(
            model.k, backend=model.backend_name, metric=model.metric,
            weights=model.weights, **dict(model.backend_opts),
        )
    elif isinstance(model, KNNRegressor):
        fresh = KNNRegressor(
            model.k, weights=model.weights, metric=model.metric,
            engine=model.engine, device=model.device,
        )
    else:
        raise TypeError(f"cannot compact a {type(model).__name__}")
    return fresh.fit(train)


class Compactor:
    """Owns the compaction lock, the optional interval thread, and the
    swap callback into the serving app.

    ``swap`` — ``swap(new_model, version, rebase_hook)``: must execute
    ``rebase_hook()`` inside the batcher's model-swap critical section
    (``ServeApp._mutable_swap`` does); ``warm`` — ``warm(new_model)``
    compiles the serving batch shapes off the serving path.

    ``retention_floor`` — optional zero-arg callable returning the
    lowest WAL cursor any live follower still needs (or None): epoch
    files whose records reach past that floor are NOT pruned after the
    fold (the fleet's, ROADMAP A12; a non-replicated serve passes
    nothing).

    ``defer`` — optional zero-arg callable (the control plane's brownout
    gate, ROADMAP A12): while it returns True,
    interval/threshold-triggered folds WAIT — headroom is negative, and
    a fold's warmup + swap stealing cycles from overload traffic is the
    LSM anti-pattern the scheduler exists to avoid. The explicit
    ``/admin/compact`` path (``run_once``) is NOT gated: an operator's
    direct order outranks the scheduler. Pressure keeps accruing while
    deferred (delta-full inserts still 429), so the first post-recovery
    tick folds immediately.
    """

    def __init__(self, engine, *, swap, warm,
                 threshold: int = 1024, interval_s: float = 30.0,
                 retention_floor=None, defer=None):
        if threshold < 1:
            raise ValueError(f"compact threshold must be >= 1, got "
                             f"{threshold}")
        if interval_s < 0:
            raise ValueError(f"compact interval must be >= 0, got "
                             f"{interval_s}")
        self.engine = engine
        self.threshold = int(threshold)
        self.interval_s = float(interval_s)
        self._swap = swap
        self._warm = warm
        self._retention_floor = retention_floor
        self._defer = defer
        self._lock = threading.Lock()
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.compactions = 0
        engine.on_pressure(self._on_pressure)

    # -- background thread -------------------------------------------------

    def start(self) -> None:
        """Start the interval worker (no thread at ``interval_s == 0`` —
        then only /admin/compact and threshold kicks run, synchronously
        and on demand; the zero-thread embedded mode)."""
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="knn-compactor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _on_pressure(self, pressure: int) -> None:
        if pressure < self.threshold:
            return
        self._kick.set()
        if self._defer is not None and self._defer():
            # Headroom-negative deferral: remember the kick, fold later.
            # Pressure persists, so the next mutation (zero-thread mode)
            # or interval tick re-attempts once headroom returns.
            return
        if self._thread is None and not self._stop.is_set():
            # Zero-thread mode (interval_s == 0) has no interval worker to
            # consume the kick — the CLI promise ("threshold kicks still
            # compact") needs a one-shot worker. run_once's non-blocking
            # lock dedupes concurrent kicks; compacting ON the mutation
            # thread would stall reads for the whole fold.
            threading.Thread(target=self._kick_once, name="knn-compactor",
                             daemon=True).start()

    def _kick_once(self) -> None:
        try:
            self.run_once()
        except CompactionInProgress:
            pass
        except Exception as e:  # noqa: BLE001 — logged, old gen serving
            print(f"warning: compaction failed ({type(e).__name__}: {e}); "
                  f"the previous generation keeps serving", flush=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(self.interval_s)
            if self._stop.is_set():
                return
            if self._defer is not None and self._defer():
                # Negative headroom: leave the kick set and re-check —
                # deferred pressure must fold on the FIRST healthy tick,
                # not wait for a fresh trigger. The bounded sleep (the
                # kick keeps `wait` from sleeping) stops the loop from
                # spinning while deferred.
                self._stop.wait(min(1.0, self.interval_s))
                continue
            kicked = self._kick.is_set()
            self._kick.clear()
            if (self.engine.pressure() >= self.threshold
                    or (kicked and self.engine.pressure() > 0)):
                try:
                    self.run_once()
                except CompactionInProgress:
                    pass
                except Exception as e:  # noqa: BLE001 — logged + counted,
                    # the old generation keeps serving; retried next tick.
                    print(f"warning: compaction failed "
                          f"({type(e).__name__}: {e}); the previous "
                          f"generation keeps serving", flush=True)

    @contextlib.contextmanager
    def exclusive(self):
        """Hold the compaction lock WITHOUT compacting — the snapshot
        bootstrap installer wraps its re-seed swap in this so no
        concurrent fold can seal the abandoned lineage's state and
        re-commit it over the freshly installed generation. Raises
        :class:`CompactionInProgress` (non-blocking, like
        ``run_once``) when a fold is mid-flight."""
        if not self._lock.acquire(blocking=False):
            raise CompactionInProgress(
                "a compaction is already in progress")
        try:
            yield
        finally:
            self._lock.release()

    # -- one compaction ----------------------------------------------------

    def run_once(self, force: bool = False) -> dict:
        """Fold → save generation → warm → swap+rebase → commit pointer.
        Folds whatever exists — threshold gating is the CALLER's job
        (``_run``/``_on_pressure``); ``force`` marks the /admin/compact
        trigger. With nothing to fold it returns ``compacted: False``
        without sealing. Raises :class:`CompactionInProgress` when
        another compaction holds the lock."""
        if not self._lock.acquire(blocking=False):
            raise CompactionInProgress(
                "a compaction is already in progress")
        t0 = time.monotonic()
        swapped = False
        split: "dict[str, float]" = {}
        mark = [t0]

        def lap(name: str) -> None:
            now = time.monotonic()
            split[name] = round((now - mark[0]) * 1e3, 3)
            mark[0] = now

        try:
            eng = self.engine
            if eng.pressure() == 0:
                return {"compacted": False, "reason": "nothing to fold"}
            old_model = eng._model
            base_train = old_model.train_
            base_stable = eng._base_stable
            with obs.span("mutable.compact",
                          pressure=eng.pressure()):
                fold_input = eng.seal()
                lap("seal")
                new_train, new_stable, stats = fold(
                    base_train, fold_input, base_stable)
                new_model = clone_fitted(old_model, new_train)
                new_ivf = None
                ivf_path = None
                old_ivf = getattr(old_model, "ivf_", None)
                if old_ivf is not None:
                    # Re-assign folded rows to cells: incremental (the
                    # existing centroid field, one same-seed assignment
                    # step) unless imbalance demands a full Lloyd's
                    # rebuild — deterministic artifacts either way.
                    from knn_tpu_torch.index.ivf import IVF_ATTR

                    new_ivf, ivf_path = rebuild_ivf(
                        old_ivf, new_train,
                        device=getattr(old_model, "device", "cuda"))
                    setattr(new_model, IVF_ATTR, new_ivf)
                lap("fold")
                generation = fold_input["generation"] + 1
                gen_dir = artifact.generation_path(eng.root, generation)
                artifact.save_index(
                    new_model, gen_dir, ivf=new_ivf,
                    mutable_block=eng.base_manifest_block(
                        fold_input, new_stable),
                )
                version = artifact.index_version(
                    artifact.read_manifest(gen_dir))
                lap("save")
                self._warm(new_model)
                lap("warm")
                # Seeded fault point for the rollback path: everything is
                # built and warmed, nothing swapped yet.
                faults.fault_point("mutable.compact")
                previous = self._swap(
                    new_model, version,
                    lambda: eng.rebase(fold_input, new_model, new_stable,
                                       generation, version=version),
                )
                swapped = True
                lap("swap")
                # COMMIT: after this atomic replace, boots load the new
                # generation and replay only records past folded_seq.
                artifact.write_current(eng.root, {
                    "generation": generation,
                    "base": str(gen_dir.relative_to(eng.root)),
                    "folded_seq": int(fold_input["seq"]),
                    "next_stable": int(eng._next_stable),
                    "active_epoch": int(eng._epoch),
                })
                cleanup = self._cleanup(fold_input, generation)
                lap("commit")
            wall_ms = (time.monotonic() - t0) * 1e3
            self.compactions += 1
            detail = {
                "generation": generation, "index_version": version,
                "previous_version": previous,
                "folded_seq": int(fold_input["seq"]), **cleanup, **stats,
                "split_ms": split,
            }
            if ivf_path is not None:
                # Which IVF branch this fold rode (the compaction
                # verdict's answer to "did we pay a full re-cluster?").
                detail["ivf_compaction"] = ivf_path
                detail["ivf_cell_imbalance"] = new_ivf.imbalance()
            eng.note_compaction("ok", wall_ms, detail)
            return {"compacted": True, "ms": round(wall_ms, 3), **detail}
        except CompactionInProgress:
            raise
        except Exception as e:
            if swapped:
                # The new generation is already serving — saying
                # "rolled_back" here would tell the operator the exact
                # opposite of the truth (e.g. CURRENT.json commit hit a
                # full disk). Reboot-safety holds regardless: the sealed
                # epoch is still on disk, so the old pointer + full
                # replay reconstruct every acknowledged write.
                self.engine.note_compaction(
                    "commit_failed", (time.monotonic() - t0) * 1e3)
                raise CompactionCommitFailed(
                    f"compaction swapped generation in but the pointer "
                    f"commit failed ({type(e).__name__}: {e}); the new "
                    f"generation is serving, a reboot replays onto the "
                    f"old one, and the next compaction re-commits"
                ) from e
            self.engine.note_compaction(
                "rolled_back", (time.monotonic() - t0) * 1e3)
            raise
        finally:
            self._lock.release()

    def _cleanup(self, fold_input: dict, generation: int) -> dict:
        """Best-effort removal of folded epoch files and superseded
        generation directories — AFTER the pointer committed, so a crash
        during cleanup only leaves redundant (skipped-on-replay) files.

        Retention floor: an epoch whose records reach past the lowest
        live follower cursor is HELD, not pruned — the silent hazard
        this closes is a primary compacting a lagging follower straight
        into the terminal behind-the-fold park. Held epochs stay
        eligible (``n <= sealed_epoch``) and are re-examined by the next
        compaction's cleanup once the floor advances; the hold itself is
        counted (``knn_fleet_wal_retention_held_total``) and surfaced in
        the compaction verdict so the router can audit it."""
        floor = None
        if self._retention_floor is not None:
            try:
                floor = self._retention_floor()
            except Exception:  # noqa: BLE001 — advisory; prune as before
                floor = None
        pruned = held = 0
        for n, path in artifact.list_epochs(self.engine.root):
            if n > fold_input["sealed_epoch"]:
                continue
            if floor is not None and floor < fold_input["seq"]:
                try:
                    records, _torn = artifact.read_epoch_records(
                        path, tolerate_torn=True)
                except Exception:  # noqa: BLE001 — unreadable: hold it
                    records = None
                if records is None:
                    last_seq = fold_input["seq"]  # conservative: hold
                elif not records:
                    last_seq = -1  # empty file holds nothing: prune
                else:
                    last_seq = int(records[-1]["seq"])
                if last_seq > floor:
                    held += 1
                    continue
            try:
                path.unlink()
                pruned += 1
            except OSError:
                pass
        if held:
            obs.counter_add(
                "knn_fleet_wal_retention_held_total", held,
                help="epoch files a compaction deferred pruning because "
                     "a live follower's WAL cursor still needs them",
            )
        gen_root = self.engine.root / artifact.GENERATIONS_DIR
        if gen_root.is_dir():
            keep = artifact.generation_path(self.engine.root,
                                            generation).name
            for p in gen_root.iterdir():
                if p.is_dir() and p.name != keep:
                    shutil.rmtree(p, ignore_errors=True)
        out = {"epochs_pruned": pruned, "epochs_held": held}
        if floor is not None:
            out["retention_floor"] = int(floor)
        return out
