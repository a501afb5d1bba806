"""Content-addressed artifact store: capture once per *cluster*, not per
process.

Counterpart of ``repro/store/store.py``; an entry written by either package
is read by the other under the same key.  Checkpoints answer "restore MY
latest state", the store answers "has ANYONE already computed this
object?" — captured functional traces, extracted ``FeatureSet``s, trained
params and crash-resume manifests, addressed by blake2b content keys
(``store.content``) derived from what the object is a pure function of.

Layout (all under one root, safe to blow away wholesale):

    <root>/objects/<kind>/<key[:2]>/<key>/   one entry: manifest.json +
                                             arr_*.bin (ckpt typed-path
                                             format, template-free)
    <root>/tmp/                              unique staging dirs

The reference's ``xla/`` directory (its JAX persistent compilation cache)
has no counterpart here yet: the port's is the nvcc build cache in
``build/`` (ROADMAP A.9).

Concurrency and crash safety: entries are immutable once published.  A put
stages into ``tmp/<key>-<pid>-<nonce>`` and publishes with one
``os.rename`` — readers never observe a partial entry, and two processes
racing the same key resolve to whichever rename wins (identical content
either way).  A torn write from a hard kill leaves either an orphan in
``tmp/`` (swept by ``gc``) or an entry without a manifest / with a
truncated array file — ``get`` treats any load failure as a miss, deletes
the entry, and counts it in ``stats()["corrupt_dropped"]``.

Eviction: entries carry their last-use time (directory mtime, refreshed on
every hit); ``gc(max_bytes=..., max_age_s=...)`` drops least-recently-used
entries past the byte budget and anything older than the age bound.  A
store constructed with ``max_bytes=`` self-GCs after each put.

Pinning: a reader that must not lose an entry mid-stream drops a
``.pin-<pid>-<nonce>`` marker file into the entry dir; ``gc`` — in this or
ANY process sharing the root — skips entries that hold a pin from a live
pid, and sweeps markers whose pid is gone.  ``get`` pins implicitly for the
duration of the load; ``pin(kind, key)`` is the public context manager for
longer holds.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..ckpt.checkpoint import load_array_tree, write_array_tree
from ..resilience.faults import fault_point

__all__ = ["ArtifactStore", "features_to_tree", "tree_to_features"]

_PIN_PREFIX = ".pin-"


class _PinLease:
    """One held pin marker.  Truthy when the marker landed (the entry
    existed at pin time).  ``release()`` is idempotent: an explicit
    release followed by the context-manager exit (or any double-unpin)
    is a no-op, never an unlink of a namesake marker."""

    __slots__ = ("path", "pinned")

    def __init__(self, path: str, pinned: bool):
        self.path = path
        self.pinned = pinned

    def __bool__(self) -> bool:
        return self.pinned

    def release(self) -> None:
        if not self.pinned:
            return
        self.pinned = False
        try:
            os.unlink(self.path)
        except OSError:
            pass


def features_to_tree(fs) -> Dict[str, Any]:
    """A ``FeatureSet`` as the plain nested dict the store serializes
    (``labels`` key absent when None — typed-path trees cannot hold
    None leaves)."""
    tree = {
        "opcode": fs.opcode,
        "regbits": fs.regbits,
        "flags": fs.flags,
        "brhist": fs.brhist,
        "memdist": fs.memdist,
    }
    if fs.labels is not None:
        tree["labels"] = dict(fs.labels)
    return tree


def tree_to_features(tree: Dict[str, Any]):
    """Inverse of :func:`features_to_tree`."""
    from ..core.features import FeatureSet  # lazy: keep store import light

    return FeatureSet(
        opcode=tree["opcode"],
        regbits=tree["regbits"],
        flags=tree["flags"],
        brhist=tree["brhist"],
        memdist=tree["memdist"],
        labels=tree.get("labels"),
    )


class ArtifactStore:
    """Content-addressed object cache under one filesystem root."""

    def __init__(self, root: str, *, max_bytes: Optional[int] = None):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.max_bytes = max_bytes
        os.makedirs(os.path.join(self.root, "objects"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "tmp"), exist_ok=True)
        self.counters: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "puts": 0,
            "put_races": 0,
            "corrupt_dropped": 0,
            "evicted": 0,
            "gc_pin_skips": 0,
            "stale_pins_swept": 0,
        }
        self._nonce = 0

    # ---- paths -----------------------------------------------------------

    def _entry_dir(self, kind: str, key: str) -> str:
        return os.path.join(self.root, "objects", kind, key[:2], key)

    def _stage_dir(self, key: str) -> str:
        self._nonce += 1
        return os.path.join(
            self.root, "tmp", f"{key}-{os.getpid()}-{self._nonce}"
        )

    # ---- pinning ---------------------------------------------------------

    @contextlib.contextmanager
    def pin(self, kind: str, key: str):
        """Hold a read-lock on one entry: while the context is open, no
        ``gc`` sharing this root (any process on this host) will evict it.
        Yields a truthy ``_PinLease`` when the pin landed, a falsy one
        when the entry does not exist (already evicted / never published)
        — the caller recomputes.  The lease's ``release()`` may be called
        early (and repeatedly: it is idempotent, so the context exit after
        an explicit release is a no-op).  Pins are advisory markers tied
        to this pid; a crash leaves a stale marker that the next ``gc``
        sweeps once the pid is gone."""
        self._nonce += 1
        pinfile = os.path.join(
            self._entry_dir(kind, key),
            f"{_PIN_PREFIX}{os.getpid()}-{self._nonce}",
        )
        try:
            open(pinfile, "x").close()
            pinned = True
        except OSError:  # entry dir vanished (or pinfile collision)
            pinned = False
        lease = _PinLease(pinfile, pinned)
        try:
            yield lease
        finally:
            lease.release()

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except OSError:  # EPERM etc.: someone else's live process
            return True
        return True

    def _sweep_stale_pins(self, edir: str) -> Tuple[bool, int]:
        """``(any live pin, stale markers removed)`` for one entry dir.
        Markers from dead pids (readers that were SIGKILLed mid-hold) are
        unlinked; anything unparseable is treated as stale too."""
        live, swept = False, 0
        try:
            names = os.listdir(edir)
        except OSError:
            return False, 0
        for name in names:
            if not name.startswith(_PIN_PREFIX):
                continue
            try:
                pid = int(name[len(_PIN_PREFIX):].split("-", 1)[0])
            except ValueError:
                pid = -1
            if pid > 0 and self._pid_alive(pid):
                live = True
            else:
                try:
                    os.unlink(os.path.join(edir, name))
                    swept += 1
                except OSError:
                    pass
        return live, swept

    def _has_live_pin(self, edir: str) -> bool:
        """True when any pin marker in the entry belongs to a live pid;
        markers from dead pids are swept as a side effect."""
        return self._sweep_stale_pins(edir)[0]

    # ---- core API --------------------------------------------------------

    def has(self, kind: str, key: str) -> bool:
        return os.path.exists(
            os.path.join(self._entry_dir(kind, key), "manifest.json")
        )

    def put(self, kind: str, key: str, tree: Any, extra: Optional[Dict] = None) -> bool:
        """Publish an entry (no-op when the key already exists — entries
        are immutable and content-addressed, so identical by construction).
        Returns True when this call created the entry."""
        dst = self._entry_dir(kind, key)
        if self.has(kind, key):
            return False
        stage = self._stage_dir(key)
        write_array_tree(tree, stage, extra)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.rename(stage, dst)
        except OSError:
            # lost a publish race with another process — their content is
            # byte-identical (same key), keep theirs
            shutil.rmtree(stage, ignore_errors=True)
            self.counters["put_races"] += 1
            return False
        self.counters["puts"] += 1
        if self.max_bytes is not None:
            self.gc(max_bytes=self.max_bytes)
        return True

    def get(self, kind: str, key: str) -> Optional[Tuple[Any, Dict]]:
        """``(tree, extra)`` for a published entry, or None.  Any load
        failure (partial write, bit rot, format drift) quarantines the
        entry and reports a miss — the caller recomputes and re-puts."""
        path = self._entry_dir(kind, key)
        if not os.path.exists(path):
            self.counters["misses"] += 1
            return None
        # pin for the duration of the load: a concurrent gc (this or any
        # other process on the root) cannot delete the files mid-read.
        # pinned=False means the entry vanished between exists() and the
        # pin — an ordinary miss, not corruption.
        with self.pin(kind, key) as pinned:
            if not pinned:
                self.counters["misses"] += 1
                return None
            try:
                fault_point("store.load", payload=key)
                tree, extra = load_array_tree(path)
            except Exception:
                shutil.rmtree(path, ignore_errors=True)
                self.counters["corrupt_dropped"] += 1
                self.counters["misses"] += 1
                return None
        self.counters["hits"] += 1
        try:
            os.utime(path)  # LRU clock for gc()
        except OSError:
            pass
        return tree, extra

    def delete(self, kind: str, key: str) -> bool:
        """Explicitly drop one entry (e.g. a registry name being
        re-published).  Returns True when something was removed.  Unlike
        gc this ignores pins — an explicit delete is an operator decision,
        not cache pressure."""
        path = self._entry_dir(kind, key)
        if not os.path.exists(path):
            return False
        shutil.rmtree(path, ignore_errors=True)
        return True

    def list_extras(self, kind: str) -> Iterator[Tuple[str, Dict]]:
        """Yield ``(key, extra)`` for every published entry of ``kind``,
        reading only the manifests (no array payloads) — how the model
        registry enumerates published names from a content-addressed
        namespace."""
        kdir = os.path.join(self.root, "objects", kind)
        if not os.path.isdir(kdir):
            return
        for prefix in sorted(os.listdir(kdir)):
            pdir = os.path.join(kdir, prefix)
            for key in sorted(os.listdir(pdir)):
                try:
                    with open(os.path.join(pdir, key, "manifest.json")) as f:
                        yield key, json.load(f).get("extra", {})
                except (OSError, ValueError):
                    continue

    # ---- maintenance -----------------------------------------------------

    def _entries(self) -> List[Tuple[str, int, float]]:
        """(entry_dir, bytes, last_use) for every published entry."""
        out = []
        obj_root = os.path.join(self.root, "objects")
        for kind in sorted(os.listdir(obj_root)):
            kdir = os.path.join(obj_root, kind)
            for prefix in sorted(os.listdir(kdir)):
                pdir = os.path.join(kdir, prefix)
                for key in sorted(os.listdir(pdir)):
                    edir = os.path.join(pdir, key)
                    try:
                        size = sum(
                            e.stat().st_size
                            for e in os.scandir(edir)
                            if e.is_file()
                        )
                        out.append((edir, size, os.stat(edir).st_mtime))
                    except OSError:
                        continue
        return out

    def stats(self) -> Dict[str, Any]:
        entries = self._entries()
        return {
            "root": self.root,
            "entries": len(entries),
            "bytes": sum(sz for _, sz, _ in entries),
            **self.counters,
        }

    def gc(
        self,
        *,
        max_bytes: Optional[int] = None,
        max_age_s: Optional[float] = None,
    ) -> Dict[str, int]:
        """Drop stale tmp dirs and dead-pid pin markers, then entries:
        first anything unused for longer than ``max_age_s``, then
        least-recently-used entries until the total is within
        ``max_bytes``."""
        dropped = 0
        tmp_root = os.path.join(self.root, "tmp")
        now = time.time()
        for name in os.listdir(tmp_root):
            p = os.path.join(tmp_root, name)
            try:
                if now - os.stat(p).st_mtime > 3600:  # torn writes only
                    shutil.rmtree(p, ignore_errors=True)
            except OSError:
                continue

        entries = sorted(self._entries(), key=lambda e: e[2])  # LRU first
        # sweep dead-pid pin markers over EVERY entry, not just the ones
        # under eviction pressure — a pin left by a SIGKILLed reader must
        # not outlive the next gc regardless of cache size or entry age
        stale = 0
        for edir, _, _ in entries:
            stale += self._sweep_stale_pins(edir)[1]
        self.counters["stale_pins_swept"] += stale
        total = sum(sz for _, sz, _ in entries)
        keep = []
        for edir, size, mtime in entries:
            if max_age_s is not None and now - mtime > max_age_s:
                if self._has_live_pin(edir):  # a reader is streaming it
                    self.counters["gc_pin_skips"] += 1
                    keep.append((edir, size, mtime))
                    continue
                shutil.rmtree(edir, ignore_errors=True)
                total -= size
                dropped += 1
            else:
                keep.append((edir, size, mtime))
        if max_bytes is not None:
            for edir, size, _ in keep:
                if total <= max_bytes:
                    break
                if self._has_live_pin(edir):
                    self.counters["gc_pin_skips"] += 1
                    continue
                shutil.rmtree(edir, ignore_errors=True)
                total -= size
                dropped += 1
        self.counters["evicted"] += dropped
        return {"evicted": dropped, "bytes": total, "stale_pins": stale}
