"""Snapshot-shipping follower bootstrap (the port of
``knn_tpu/fleet/bootstrap.py``): how a blank or stale replica joins the
fleet without anyone copying directories by hand. Host code only: the
files ship as bytes, byte-equal across the packages.

The LSM recipe's missing distributed leg: component state (a generation
artifact — ``manifest.json`` + ``arrays.npz``) ships by snapshot over a
chunked, digest-verified ``/admin/snapshot`` transfer, then the WAL
catches the follower up through the normal ``wal-append`` path. Two
entry points share the machinery:

- **boot-time** (``serve --follower-of URL`` over a blank
  directory, cli.py): :func:`install_snapshot` pulls, verifies, and
  commits before the engine ever boots — "add a replica" is one
  command;
- **in-process** (``POST /admin/bootstrap`` on a running follower,
  serve/server.py): :func:`download_snapshot` stages and verifies while
  the old state keeps serving, then :func:`commit_snapshot` runs inside
  the engine's reseed critical section — clear the abandoned lineage's
  epochs, rename the staged generation in, atomically replace
  ``CURRENT.json``.

Failure contract: every byte is verified (whole-file sha256 against the
source manifest) before anything durable changes, the staged directory
lives inside the artifact root (same filesystem — the final rename is
atomic), and the ``fleet.snapshot_ship`` fault point fires before the
first destructive step — any failure leaves the prior state serving.
Crash windows are stale-but-consistent: removing the old epochs before
the pointer commit can only roll a *diverged-or-behind* follower back
to its own fold point, never replay another lineage's records.
"""

from __future__ import annotations

import hashlib
import shutil
from pathlib import Path
from typing import Optional

from knn_tpu_torch.resilience import faults
from knn_tpu_torch.resilience.errors import DataError
from knn_tpu_torch.serve import artifact
from knn_tpu_torch.fleet.wire import forward_bytes, request_json

#: Per-request transfer unit. Small enough that one chunk never trips
#: the serve handler's body ceiling, large enough that arrays ship in a
#: handful of round trips.
CHUNK_BYTES = 4 << 20

#: The only files a generation artifact consists of — the snapshot
#: manifest lists exactly these, and the chunk endpoint refuses
#: anything else (no path traversal surface).
SNAPSHOT_FILES = (artifact.MANIFEST_NAME, artifact.ARRAYS_NAME)


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


# -- primary side ----------------------------------------------------------


def snapshot_manifest(root) -> dict:
    """What ``GET /admin/snapshot`` returns: the current base
    generation's file list (name/size/sha256 each) plus the WAL cursor a
    follower resumes shipping from after installing it. Read purely from
    disk — the committed state — so the snapshot is self-consistent
    even while the live engine runs ahead of the fold point (the WAL
    ships the difference)."""
    root = Path(root)
    base_dir, current = artifact.resolve_mutable_base(root)
    block, _stable = artifact.read_mutable_block(base_dir)
    generation, wal_cursor, next_stable = 0, 0, 0
    if block is not None:
        generation = int(block.get("generation", 0))
        wal_cursor = int(block.get("folded_seq", 0))
        next_stable = int(block.get("next_stable", 0))
    if current is not None:
        generation = int(current.get("generation", generation))
        wal_cursor = max(wal_cursor, int(current.get("folded_seq", 0)))
        next_stable = max(next_stable, int(current.get("next_stable", 0)))
    files = []
    for name in SNAPSHOT_FILES:
        p = base_dir / name
        if not p.exists():
            raise DataError(
                f"{base_dir}: {name} missing — the serving base is not a "
                f"complete artifact; cannot snapshot"
            )
        files.append({"name": name, "size": p.stat().st_size,
                      "sha256": _sha256(p)})
    manifest = artifact.read_manifest(base_dir)
    return {
        "generation": generation,
        "wal_cursor": wal_cursor,
        "next_stable": next_stable,
        "index_version": artifact.index_version(manifest),
        "files": files,
    }


def read_chunk(root, name: str, offset: int, length: int,
               generation: int) -> bytes:
    """One chunk of a snapshot file, or a typed refusal. ``generation``
    is the client's precondition: a compaction swapping the base
    mid-transfer must surface as a 409-able error, never as a file
    stitched from two generations (the sha256 would catch it anyway —
    this catches it cheaply and with a name)."""
    root = Path(root)
    base_dir, current = artifact.resolve_mutable_base(root)
    block, _stable = artifact.read_mutable_block(base_dir)
    live_gen = 0
    if block is not None:
        live_gen = int(block.get("generation", 0))
    if current is not None:
        live_gen = int(current.get("generation", live_gen))
    if live_gen != generation:
        raise DataError(
            f"snapshot generation {generation} superseded by "
            f"{live_gen} (a compaction landed mid-transfer); re-fetch "
            f"the snapshot manifest and restart"
        )
    if name not in SNAPSHOT_FILES:
        raise DataError(
            f"{name!r} is not a snapshot file; a snapshot ships exactly "
            f"{list(SNAPSHOT_FILES)}"
        )
    if offset < 0 or length <= 0:
        raise DataError(f"bad chunk range offset={offset} length={length}")
    with open(base_dir / name, "rb") as f:
        f.seek(offset)
        return f.read(length)


# -- follower side ---------------------------------------------------------


class SnapshotInstallError(DataError):
    """A bootstrap transfer or install failed with the prior state still
    serving — retryable from scratch, nothing durable changed."""


def download_snapshot(primary_url: str, root, *, timeout_s: float = 30.0,
                      chunk_bytes: int = CHUNK_BYTES,
                      attempts: int = 3) -> dict:
    """Pull the primary's current generation into a staging directory
    under ``root`` and verify every file's sha256. Returns the staged
    plan (consumed by :func:`commit_snapshot`); raises
    :class:`SnapshotInstallError` with the staging directory removed on
    any failure. Restart-from-manifest on a generation-superseded 409:
    a compaction mid-transfer costs a retry, never a torn install."""
    primary_url = primary_url.rstrip("/")
    root = Path(root)
    last: Optional[str] = None
    for _attempt in range(attempts):
        try:
            status, man = request_json(
                "GET", primary_url + "/admin/snapshot", timeout=timeout_s)
        except OSError as e:
            last = f"snapshot manifest fetch failed: {e}"
            continue
        if status != 200:
            raise SnapshotInstallError(
                f"{primary_url}/admin/snapshot returned HTTP {status}: "
                f"{man.get('error', man)}"
            )
        try:
            generation = int(man["generation"])
            files = list(man["files"])
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotInstallError(
                f"{primary_url}: malformed snapshot manifest: {e}"
            ) from e
        tmp = root / f".bootstrap-gen-{generation:06d}.tmp"
        try:
            return _fetch_into(primary_url, tmp, man, generation, files,
                               timeout_s, chunk_bytes, root)
        except _GenerationSuperseded as e:
            shutil.rmtree(tmp, ignore_errors=True)
            last = str(e)
            continue
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    raise SnapshotInstallError(
        f"bootstrap from {primary_url} did not converge after "
        f"{attempts} attempts: {last}"
    )


class _GenerationSuperseded(Exception):
    pass


def _fetch_into(primary_url: str, tmp: Path, man: dict, generation: int,
                files: list, timeout_s: float, chunk_bytes: int,
                root: Path) -> dict:
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    total = 0
    for entry in files:
        name, size = str(entry["name"]), int(entry["size"])
        want = str(entry["sha256"])
        if name not in SNAPSHOT_FILES:
            raise SnapshotInstallError(
                f"{primary_url}: snapshot manifest lists unexpected file "
                f"{name!r}"
            )
        dest = tmp / name
        with open(dest, "wb") as out:
            offset = 0
            while offset < size:
                length = min(chunk_bytes, size - offset)
                url = (f"{primary_url}/admin/snapshot?file={name}"
                       f"&offset={offset}&length={length}"
                       f"&generation={generation}")
                status, body = forward_bytes("GET", url, None,
                                             timeout=timeout_s)
                if status == 409:
                    raise _GenerationSuperseded(
                        f"generation {generation} superseded mid-transfer")
                if status != 200:
                    raise SnapshotInstallError(
                        f"{url}: HTTP {status} mid-transfer"
                    )
                if len(body) != length:
                    # A torn chunk: the wire delivered fewer bytes than
                    # the range asked for — refuse now rather than let
                    # the digest check name it less precisely.
                    raise SnapshotInstallError(
                        f"{url}: torn chunk ({len(body)} bytes of "
                        f"{length})"
                    )
                out.write(body)
                offset += length
        got = _sha256(dest)
        if got != want:
            raise SnapshotInstallError(
                f"{name}: digest mismatch after transfer (want {want[:16]}…, "
                f"got {got[:16]}…) — refusing to install a corrupt snapshot"
            )
        total += size
    # Staged and fully verified; nothing durable has changed yet.
    return {
        "tmp_dir": tmp,
        "root": root,
        "generation": generation,
        "wal_cursor": int(man.get("wal_cursor", 0)),
        "next_stable": int(man.get("next_stable", 0)),
        "index_version": man.get("index_version"),
        "bytes": total,
        "files": [e["name"] for e in files],
    }


def plan_install_dir(staged: dict) -> Path:
    """Where the staged generation will live: ``generations/gen-NNNNNN``,
    or a ``-rsK`` suffixed sibling when that name is already taken by
    this replica's own (abandoned, possibly divergent) lineage —
    CURRENT.json's ``base`` is a relative path, so the name only has to
    be unique, and never clobbering the serving base keeps every crash
    window consistent."""
    root: Path = staged["root"]
    final = artifact.generation_path(root, staged["generation"])
    k = 0
    while final.exists():
        k += 1
        final = final.with_name(
            f"gen-{staged['generation']:06d}-rs{k}")
    return final


def commit_snapshot(staged: dict) -> dict:
    """The durable flip, in crash-safe order: fault point (the injected
    stand-in for disk-full mid-install) → rename the staged generation
    in (additive) → remove the old lineage's epoch files (so no record
    from an abandoned history can ever replay onto the new base) →
    atomic ``CURRENT.json`` replace (the commit point). A crash between
    epoch removal and the pointer commit boots the OLD base at its own
    fold point — stale but consistent, recoverable through replication.

    In-process callers run this inside the engine's reseed critical
    section (no concurrent append can land in an epoch being cleared);
    the boot-time path has no engine yet, so ordering alone suffices."""
    root: Path = staged["root"]
    faults.fault_point("fleet.snapshot_ship")
    final = plan_install_dir(staged)
    final.parent.mkdir(parents=True, exist_ok=True)
    import os

    os.replace(staged["tmp_dir"], final)
    for _n, path in artifact.list_epochs(root):
        try:
            path.unlink()
        except OSError:
            pass
    current = {
        "generation": staged["generation"],
        "base": str(final.relative_to(root)),
        "folded_seq": staged["wal_cursor"],
        "next_stable": staged["next_stable"],
        "active_epoch": 0,
    }
    artifact.write_current(root, current)
    return {**current, "bytes": staged["bytes"],
            "files": staged["files"],
            "index_version": staged["index_version"]}


def install_snapshot(root, primary_url: str, *, timeout_s: float = 30.0,
                     chunk_bytes: int = CHUNK_BYTES) -> dict:
    """The boot-time one-shot: download, verify, commit. Used by the CLI
    when ``--follower-of`` points a blank directory at a live primary —
    after this returns, the normal mutable boot path resolves the
    installed generation like any compacted artifact and the WAL
    shipper catches the replica up from ``wal_cursor``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    staged = download_snapshot(primary_url, root, timeout_s=timeout_s,
                               chunk_bytes=chunk_bytes)
    try:
        return commit_snapshot(staged)
    except Exception:
        shutil.rmtree(staged["tmp_dir"], ignore_errors=True)
        raise


def artifact_present(root) -> bool:
    """Does ``root`` already hold something bootable? (Either a plain
    artifact at the top or a CURRENT.json pointer.) The CLI's
    auto-bootstrap gate: never overwrite an existing lineage at boot —
    a *stale* follower re-seeds through the in-process path, where the
    decision is explicit."""
    root = Path(root)
    return ((root / artifact.MANIFEST_NAME).exists()
            or (root / artifact.CURRENT_NAME).exists())


def summary_line(doc: dict) -> str:
    return (f"bootstrap: installed generation {doc['generation']} "
            f"({doc['bytes']} bytes, {len(doc['files'])} files) at WAL "
            f"cursor {doc['folded_seq']}")
