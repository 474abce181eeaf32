"""Crash-consistent checkpoint directory manager (a copy of
``paddle_tpu/checkpoint/manager.py``: host code only; its trace spans go
to the port's ``telemetry`` and its manifest names the port's version).

Reference: python/paddle/distributed/auto_parallel/static/dist_saver.py
(DistributedSaver) pairs with fleet elastic's restart contract — the
recovery half of fault tolerance.  The design: a checkpoint is a
*directory* committed with one atomic ``os.rename``; everything inside it
(payload pickles + ``manifest.json`` with per-file SHA-256 digests) is
written and fsynced in a hidden temp dir first, so a crash at ANY point —
mid-payload, pre-manifest, pre-rename — leaves either the complete
checkpoint or garbage that ``latest()`` provably skips.  Serialization and
disk I/O run on a background writer thread (at most one in flight), so the
train step pays only the host snapshot.

Layout:

    <dir>/
      ckpt-00000042/            committed checkpoint (atomic rename target)
        state.pkl               pickled host snapshot (chunked writes)
        manifest.json           step/epoch, format version, file digests
      .tmp-ckpt-00000043-...    in-flight staging dir (never selected)
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional

from ..telemetry import trace as _ttrace

__all__ = ["CheckpointManager", "CheckpointError", "CheckpointInfo"]

MANIFEST_NAME = "manifest.json"
PAYLOAD_NAME = "state.pkl"
FORMAT_VERSION = 1
_CKPT_PREFIX = "ckpt-"
_TMP_PREFIX = ".tmp-"
_WRITE_CHUNK = 1 << 20  # 1 MiB payload chunks (crash-injection granularity)


class CheckpointError(RuntimeError):
    """Raised for writer failures (re-raised on the next save()/wait())
    and for restore() of a corrupt checkpoint."""


class CheckpointInfo:
    """A validated, committed checkpoint."""

    __slots__ = ("path", "step", "epoch", "manifest")

    def __init__(self, path: str, manifest: Dict[str, Any]):
        self.path = path
        self.step = int(manifest.get("step", -1))
        self.epoch = int(manifest.get("epoch", 0))
        self.manifest = manifest

    def __repr__(self):
        return f"CheckpointInfo(step={self.step}, path={self.path!r})"


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep_last_k: int = 3,
                 async_save: bool = True):
        self._dir = os.path.abspath(directory)
        self._keep = max(int(keep_last_k), 1)
        self._async = async_save
        self._inflight: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        # test-only fault injection: fn(point_name) may raise to simulate a
        # crash at that point of the write pipeline
        self._fault_hook: Optional[Callable[[str], None]] = None
        # positive-validation cache: committed dirs are immutable, so a
        # checkpoint that validated once need not be re-read and re-hashed
        # by every subsequent latest()/GC pass (keyed on manifest/payload
        # mtimes + size so external corruption that rewrites a file is
        # still caught; restore() always re-verifies the digest)
        self._valid_cache: Dict[str, tuple] = {}
        os.makedirs(self._dir, exist_ok=True)
        self._clean_stale_tmp()

    # -- properties ------------------------------------------------------
    @property
    def directory(self) -> str:
        return self._dir

    # -- save ------------------------------------------------------------
    def save(self, tree: Any, step: int, epoch: int = 0,
             meta: Optional[Dict[str, Any]] = None,
             blocking: Optional[bool] = None):
        """Snapshot ``tree`` (nested dict/list of host leaves -- use
        TrainState.capture or checkpoint.to_host) and commit it as
        checkpoint ``step``.  With async_save the caller only pays the
        in-memory snapshot; serialization + fsync + rename happen on the
        writer thread.  A previous writer failure is re-raised here."""
        blocking = (not self._async) if blocking is None else blocking
        # at most one in-flight write: drain the previous one first (disk
        # slower than the save cadence degrades to blocking, never to an
        # unbounded queue of host snapshots)
        self.wait()
        if blocking:
            self._write(tree, int(step), int(epoch), dict(meta or {}))
            return
        t = threading.Thread(
            target=self._write_guarded,
            args=(tree, int(step), int(epoch), dict(meta or {})),
            name=f"ckpt-writer-{step}", daemon=True)
        self._inflight = t
        t.start()

    def wait(self):
        """Block until the in-flight write (if any) commits; re-raise its
        error as CheckpointError."""
        t = self._inflight
        if t is not None:
            t.join()
            self._inflight = None
        with self._lock:
            err, self._writer_error = self._writer_error, None
        if err is not None:
            raise CheckpointError(
                f"async checkpoint writer failed: {err!r}") from err

    close = wait

    def _write_guarded(self, tree, step, epoch, meta):
        try:
            self._write(tree, step, epoch, meta)
        except BaseException as e:  # noqa: BLE001 — surfaced on next save()
            with self._lock:
                self._writer_error = e

    def _hook(self, point: str):
        if self._fault_hook is not None:
            self._fault_hook(point)

    def _write(self, tree, step: int, epoch: int, meta: Dict[str, Any]):
        tmp = os.path.join(
            self._dir,
            f"{_TMP_PREFIX}{_CKPT_PREFIX}{step:08d}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        try:
            # the span records on the CALLING thread — for async saves
            # that is the ckpt-writer thread, so the exported trace shows
            # the serialize/fsync/commit pipeline on its own row,
            # interleaved with (not blocking) the train-step spans
            with _ttrace.span("ckpt.write", step=step):
                self._write_staged(tree, step, epoch, meta, tmp)
        except BaseException:
            # a FAILED (not crashed) write must not leak its staging dir —
            # transient ENOSPC/EIO on a long-lived trainer would otherwise
            # accumulate full-payload tmp dirs on an already-full disk
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _write_staged(self, tree, step: int, epoch: int,
                      meta: Dict[str, Any], tmp: str):
        final = os.path.join(self._dir, f"{_CKPT_PREFIX}{step:08d}")
        os.makedirs(tmp)
        self._hook("after_tmpdir")
        with _ttrace.span("ckpt.serialize"):
            payload = pickle.dumps(tree, protocol=4)
        ppath = os.path.join(tmp, PAYLOAD_NAME)
        with _ttrace.span("ckpt.payload", bytes=len(payload)):
            with open(ppath, "wb") as f:
                for off in range(0, len(payload), _WRITE_CHUNK):
                    f.write(payload[off:off + _WRITE_CHUNK])
                    self._hook("mid_payload")
                f.flush()
                os.fsync(f.fileno())
        self._hook("after_payload")
        manifest = {
            "format_version": FORMAT_VERSION,
            "framework_version": _framework_version(),
            "step": step,
            "epoch": epoch,
            "meta": meta,
            "files": {PAYLOAD_NAME: {"sha256": _sha256_bytes(payload),
                                     "size": len(payload)}},
        }
        self._hook("before_manifest")
        mpath = os.path.join(tmp, MANIFEST_NAME)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        self._hook("before_commit")
        with _ttrace.span("ckpt.commit"):
            if os.path.exists(final):
                # re-save of the same step: displace the old dir, commit,
                # then drop the old content.  The brief both-absent window
                # is covered by the previous checkpoint (latest() falls
                # back).
                stale = final + f".gc-{uuid.uuid4().hex[:8]}"
                os.rename(final, stale)
                os.rename(tmp, final)
                shutil.rmtree(stale, ignore_errors=True)
            else:
                os.rename(tmp, final)
            _fsync_dir(self._dir)
            self._gc()

    # -- discovery / validation -----------------------------------------
    @staticmethod
    def _step_of(name: str) -> int:
        # order by the PARSED step, not the name: lexicographic order
        # inverts once a step outgrows the 8-digit zero-pad
        try:
            return int(name[len(_CKPT_PREFIX):])
        except ValueError:
            return -1

    def _committed_dirs(self) -> List[str]:
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        out = [n for n in names
               if n.startswith(_CKPT_PREFIX) and ".gc-" not in n]
        # newest step first
        return sorted(out, key=self._step_of, reverse=True)

    def _cache_key(self, path: str, files: Dict[str, Any]):
        try:
            key = [os.stat(os.path.join(path, MANIFEST_NAME)).st_mtime_ns]
            for fname in files:
                st = os.stat(os.path.join(path, fname))
                key += [st.st_mtime_ns, st.st_size]
            return tuple(key)
        except OSError:
            return None

    def _validate(self, name: str) -> Optional[CheckpointInfo]:
        path = os.path.join(self._dir, name)
        mpath = os.path.join(path, MANIFEST_NAME)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            self._valid_cache.pop(name, None)
            return None
        if manifest.get("format_version") != FORMAT_VERSION:
            return None
        files = manifest.get("files")
        if not isinstance(files, dict) or not files:
            return None
        key = self._cache_key(path, files)
        cached = self._valid_cache.get(name)
        if cached is not None and key is not None and cached[0] == key:
            return cached[1]
        for fname, rec in files.items():
            fpath = os.path.join(path, fname)
            try:
                if os.path.getsize(fpath) != rec["size"]:
                    return None
                with open(fpath, "rb") as f:
                    if _sha256_bytes(f.read()) != rec["sha256"]:
                        return None
            except (OSError, KeyError, TypeError):
                return None
        info = CheckpointInfo(path, manifest)
        if key is not None:
            self._valid_cache[name] = (key, info)
        return info

    def checkpoints(self) -> List[CheckpointInfo]:
        """All VALID committed checkpoints, newest step first.  Truncated,
        partial, and corrupt directories are silently skipped."""
        out = []
        for name in self._committed_dirs():
            info = self._validate(name)
            if info is not None:
                out.append(info)
        return out

    def latest(self) -> Optional[CheckpointInfo]:
        """Newest checkpoint that passes full manifest + digest
        validation; None when no valid checkpoint exists."""
        for name in self._committed_dirs():
            info = self._validate(name)
            if info is not None:
                return info
        return None

    # -- restore ---------------------------------------------------------
    def restore(self, info: Optional[CheckpointInfo] = None):
        """Load a checkpoint's payload tree.  Defaults to latest().
        Returns (tree, manifest) or raises CheckpointError when nothing
        valid exists (or the given checkpoint fails validation)."""
        if info is None:
            info = self.latest()
            if info is None:
                raise CheckpointError(
                    f"no valid checkpoint under {self._dir}")
        ppath = os.path.join(info.path, PAYLOAD_NAME)
        rec = info.manifest["files"][PAYLOAD_NAME]
        try:
            with open(ppath, "rb") as f:
                payload = f.read()
        except OSError as e:
            raise CheckpointError(f"unreadable checkpoint payload: {e}") from e
        if len(payload) != rec["size"] or _sha256_bytes(payload) != rec["sha256"]:
            raise CheckpointError(
                f"checkpoint payload digest mismatch in {info.path} "
                "(corrupted after commit)")
        try:
            tree = pickle.loads(payload)
        except Exception as e:  # noqa: BLE001
            raise CheckpointError(
                f"checkpoint payload unpickle failed in {info.path}: {e!r}") from e
        return tree, info.manifest

    # -- retention -------------------------------------------------------
    def prune_newer_than(self, step: int):
        """Drop every committed checkpoint with step > ``step``.

        Elastic rollback support: after the
        members agree to resume from ``step``, any newer checkpoint on
        disk belongs to the ABANDONED timeline — leaving it would make a
        later ``latest()`` (or a later recovery's resume exchange) offer
        state the new timeline never produced."""
        self.wait()
        for name in self._committed_dirs():
            if self._step_of(name) > int(step):
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)
                self._valid_cache.pop(name, None)

    def _gc(self):
        """Keep the newest ``keep_last_k`` VALID checkpoints; drop older
        valid ones and any invalid committed garbage.  keep>=1 means the
        newest valid checkpoint is never deleted — and garbage is only
        collected when at least one valid checkpoint exists."""
        valid, invalid = [], []
        for name in self._committed_dirs():
            (valid if self._validate(name) is not None else invalid).append(name)
        if not valid:
            return
        # .gc- dirs are displaced old content of a re-saved step; a crash
        # between the two commit renames can orphan one
        stale_gc = [n for n in os.listdir(self._dir)
                    if n.startswith(_CKPT_PREFIX) and ".gc-" in n]
        for name in valid[self._keep:] + invalid + stale_gc:
            shutil.rmtree(os.path.join(self._dir, name), ignore_errors=True)
            self._valid_cache.pop(name, None)

    def _clean_stale_tmp(self):
        """Remove staging dirs left by crashed writers of PREVIOUS
        processes (ours are tracked by the in-flight thread)."""
        pid = str(os.getpid())
        for name in os.listdir(self._dir):
            if not name.startswith(_TMP_PREFIX):
                continue
            parts = name.split("-")
            if len(parts) >= 2 and parts[-2] == pid:
                continue
            shutil.rmtree(os.path.join(self._dir, name), ignore_errors=True)


def _framework_version() -> str:
    from .. import __version__

    return f"paddle_tpu_torch {__version__}"
