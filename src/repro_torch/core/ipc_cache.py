"""Persistent, content-addressed artifact store for measurement-side results.

The paper's "pre-execution" step measures kernel IPC tables once, offline;
online scheduling then only reads them. This module gives the repro the
same property across *processes*, and generalizes it beyond IPC tables: any
deterministic, content-addressable artifact of the measurement path
(simulator IPC measurements, calibrated benchmark profiles, Markov-model
solves) lives in one keyed JSON store per identity, so

  * identical computations are never repeated, no matter which benchmark,
    test, or example asks first;
  * any change to an input field, the seed, the round count, or the
    producing code (each store's schema version) silently misses and
    recomputes — there is no way to read a stale value.

``ArtifactStore`` is the generic layer: one JSON file per (name, schema),
holding one dict of entries per *kind*, dirty-tracked, written atomically
and merged with concurrent writers at save time. ``IPCCache`` is the IPC
table instance of it (kinds ``solo``/``pair``), keeping its original API.

Layout:  <cache_dir>/<name>_v<schema>.json
         {"schema": <int>, "kinds": {"<kind>": {"<key>": value, ...}, ...}}

(IPC files keep their historical flat layout for compatibility:
``ipc_v<schema>_<gpu digest>_s<seed>_r<rounds>.json`` with one top-level
dict per kind — ``solo``/``pair`` IPCs plus the ``solo_w``/``pair_w``
per-config watts the same sweeps measure.)

``cache_dir`` defaults to ``artifacts/ipc_cache_torch`` under the current
working directory and is overridable via the ``REPRO_TORCH_IPC_CACHE``
environment variable; setting it to ``0``, ``off``, or ``none`` disables
persistence entirely (in-memory caching still applies). The port's stores
are its own: the reference package's (``REPRO_IPC_CACHE``,
``artifacts/ipc_cache``) use the same content keys, so sharing a directory
would let one package replay the other's decisions and solves.

Two on-disk backends implement the same store contract:

  * **sqlite** (default) — one SQLite file per (name, schema), saves
    upsert only the entries written since the last save: O(dirty), which
    is what the serving daemon's eager save-per-decision loop needs. See
    ``repro.core.jobstore``.
  * **json** (``REPRO_STORE_BACKEND=json``) — one whole file per
    (name, schema), rewritten atomically on every save (tmp file + fsync
    + ``os.replace``, so a crash mid-save can never tear the file).
    Simple and diffable, but a save costs O(total entries) — the known
    hot-table rewrite.

``open_store`` / ``open_ipc_cache`` are the backend-dispatching
constructors; every store family (ipc / markov / calib / decisions) goes
through them.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence

try:                                     # posix advisory locks; best-effort
    import fcntl
except ImportError:                      # pragma: no cover - non-posix
    fcntl = None

from repro_torch.core.profiles import GPUSpec, content_digest

ENV_VAR = "REPRO_TORCH_IPC_CACHE"
ENV_BACKEND = "REPRO_STORE_BACKEND"
DEFAULT_DIR = os.path.join("artifacts", "ipc_cache_torch")

# bump when simulator physics change in a way that alters measurements
# (v2: power model — GPUSpec power coefficients fold into content digests,
# and IPC files carry per-config watts next to the IPC values)
_SCHEMA = 2


def cache_dir() -> Optional[str]:
    """Resolved cache directory, or None when persistence is disabled."""
    path = os.environ.get(ENV_VAR)
    if path is None:
        return DEFAULT_DIR
    if path.strip().lower() in ("", "0", "off", "none", "disable"):
        return None
    return path


def store_backend() -> str:
    """Selected artifact-store backend: ``sqlite`` (the default since
    PR 10 — O(dirty) saves instead of whole-file rewrites) or ``json``
    via ``REPRO_STORE_BACKEND=json``. Unknown values fall back to the
    default — the store is an optimization layer and must never refuse
    to start. Both backends share the content-addressed key scheme, so
    switching is always safe: the other backend's files are simply cold
    (see docs/operations.md for the migration note)."""
    raw = os.environ.get(ENV_BACKEND)
    if raw is None:
        return "sqlite"
    raw = raw.strip().lower()
    return raw if raw in ("json", "sqlite") else "sqlite"


def open_store(name: str, kinds: Sequence[str], schema: int = 1,
               path: Optional[str] = None,
               dirname: Optional[str] = None,
               backend: Optional[str] = None) -> "ArtifactStore":
    """Backend-dispatching store constructor (the one producers use):
    returns an ``ArtifactStore`` (json) or ``SqliteArtifactStore``
    depending on ``backend`` / ``REPRO_STORE_BACKEND``."""
    backend = backend if backend is not None else store_backend()
    if backend == "sqlite":
        from repro_torch.core.jobstore import SqliteArtifactStore
        return SqliteArtifactStore(name, kinds, schema=schema, path=path,
                                   dirname=dirname)
    return ArtifactStore(name, kinds, schema=schema, path=path,
                         dirname=dirname)


def open_ipc_cache(gpu: GPUSpec, seed: int, rounds: int,
                   path: Optional[str] = None,
                   backend: Optional[str] = None) -> "IPCCache":
    """Backend-dispatching ``IPCCache`` constructor (what ``IPCTable``
    uses for its persistent layer)."""
    backend = backend if backend is not None else store_backend()
    if backend == "sqlite":
        from repro_torch.core.jobstore import SqliteIPCCache
        return SqliteIPCCache(gpu, seed, rounds, path=path)
    return IPCCache(gpu, seed, rounds, path=path)


def _entry_key(prof_ws) -> str:
    return "|".join(f"{content_digest(p)}:{w}" for p, w in prof_ws)


class ArtifactStore:
    """Keyed JSON artifact store: one file per (name, schema), entries
    grouped by kind. Dirty-tracked, atomic writes, merge-on-save union so
    concurrent processes never clobber each other.

    Values must be JSON-serializable and *content-addressed by their key*:
    two writers putting the same key always mean the same value, so a dict
    union across processes is always valid.
    """

    def __init__(self, name: str, kinds: Sequence[str], schema: int = 1,
                 path: Optional[str] = None, dirname: Optional[str] = None):
        self._kinds = tuple(kinds)
        self._schema = int(schema)
        if path is not None:
            self.path = path
        else:
            base = dirname if dirname is not None else cache_dir()
            self.path = (None if base is None
                         else os.path.join(base, f"{name}_v{schema}.json"))
        self._data = self._load()
        self._dirty = False

    # ---- on-disk format ---- #
    def _empty(self) -> dict:
        return {k: {} for k in self._kinds}

    def _decode(self, raw) -> Optional[dict]:
        """Validate a parsed JSON payload; None when unusable (wrong shape
        or schema-version mismatch) so the caller falls back to empty."""
        if not isinstance(raw, dict):
            return None
        if raw.get("schema") != self._schema:
            return None
        kinds = raw.get("kinds")
        if not isinstance(kinds, dict):
            return None
        if not all(isinstance(kinds.get(k), dict) for k in self._kinds):
            return None
        return {k: kinds[k] for k in self._kinds}

    def _encode(self, data: dict) -> dict:
        return {"schema": self._schema, "kinds": data}

    def _load(self) -> dict:
        if self.path is None:
            return self._empty()
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            # missing, unreadable, corrupted, or truncated file: start
            # empty — the store is a cache, never a correctness dependency
            return self._empty()
        data = self._decode(raw)
        return data if data is not None else self._empty()

    # ---- entry access ---- #
    def get(self, kind: str, key: str):
        """Raw JSON value stored under (kind, key), or None on miss."""
        return self._data[kind].get(key)

    def put(self, kind: str, key: str, value) -> None:
        self._data[kind][key] = value
        if self.path is not None:
            self._dirty = True

    def __len__(self) -> int:
        return sum(len(d) for d in self._data.values())

    # ---- persistence ---- #
    def save(self) -> None:
        if self.path is None or not self._dirty:
            return
        tmp = None
        lock = None
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            # serialize the read-merge-replace against concurrent savers:
            # without the lock, two processes can both load, each merge
            # only its own entries, and the second replace drops the
            # first's write (the fsync below widens that window enough to
            # hit in practice)
            lock = self._acquire_lock()
            # merge with whatever a concurrent process wrote since our
            # load: entries are content-addressed, so union is always valid
            on_disk = self._load()
            for kind in self._kinds:
                merged = dict(on_disk[kind])
                merged.update(self._data[kind])
                self._data[kind] = merged
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path),
                                       suffix=".tmp")
            # crash-atomic: the payload is fully durable in the temp file
            # *before* the rename swaps it in, so a SIGKILL (or power cut)
            # at any point leaves either the old complete file or the new
            # complete file — never a torn one
            with os.fdopen(fd, "w") as f:
                json.dump(self._encode(self._data), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            tmp = None
            self._fsync_dir(os.path.dirname(self.path))
            self._dirty = False          # only a successful write settles it
        except OSError:
            # unwritable cache location: degrade to in-memory only (still
            # dirty, so a later save() can retry) — persistence is an
            # optimization, never a correctness dependency
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        finally:
            self._release_lock(lock)

    def _acquire_lock(self):
        """Blocking exclusive advisory lock on a dot-prefixed sidecar
        (``.<file>.lock``) next to the store file; None when locking is
        unavailable (non-posix, unwritable dir) — save proceeds unlocked,
        which is the historical best-effort behavior.

        The sidecar is unlinked on release so cache directories hold only
        store files; unlink + flock is racy in general, so acquisition
        re-checks after locking that the fd still names the on-disk file
        (a holder that unlinked it hands waiters a dead inode — they
        retry on the fresh path)."""
        if fcntl is None or self.path is None:
            return None
        d, fname = os.path.split(self.path)
        lock_path = os.path.join(d, f".{fname}.lock")
        while True:
            try:
                fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
                fcntl.flock(fd, fcntl.LOCK_EX)
            except OSError:
                try:
                    os.close(fd)
                except (OSError, UnboundLocalError):
                    pass
                return None
            try:
                if os.fstat(fd).st_ino == os.stat(lock_path).st_ino:
                    return (fd, lock_path)
            except OSError:
                pass                     # unlinked under us: retry
            os.close(fd)

    @staticmethod
    def _release_lock(lock) -> None:
        if lock is None:
            return
        fd, lock_path = lock
        try:
            # unlink while still holding the lock: blocked waiters wake
            # on a dead inode, notice, and re-acquire on the fresh path
            os.unlink(lock_path)
        except OSError:
            pass
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        except OSError:
            pass
        finally:
            os.close(fd)

    @staticmethod
    def _fsync_dir(dirname: str) -> None:
        """Best-effort directory fsync so the rename itself is durable on
        power loss (not required for mere process kills)."""
        try:
            fd = os.open(dirname, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)


    # ---- garbage collection ---- #
    # every store file carries its schema version in the file name:
    # keyed stores as ``<name>_v<schema>.json`` / ``.sqlite``, the
    # historical flat IPC layout as ``ipc_v<schema>_<identity>.json`` — so
    # dead generations can be collected from the names alone, without
    # parsing payloads
    _FILE_RE = re.compile(r"_v(\d+)(?:_|\.(?:json|sqlite)$)")

    @staticmethod
    def gc(keep_schemas: Optional[Dict[str, int]] = None,
           dirname: Optional[str] = None) -> List[str]:
        """Delete store files written under a dead schema version.

        ``keep_schemas`` maps a store family (the leading file-name token:
        ``ipc``, ``markov``, ``calib``, ``decisions``) to its live schema;
        defaults to ``live_schemas()``. Files of unknown families, or whose
        version cannot be parsed, are left alone. Covers both backends
        (``.json`` and ``.sqlite``, including the latter's ``-wal``/
        ``-shm`` sidecars). Returns the removed paths (empty when
        persistence is disabled or the directory is missing) — the stores
        otherwise grow one dead file per schema bump forever.
        """
        if keep_schemas is None:
            keep_schemas = live_schemas()
        base = dirname if dirname is not None else cache_dir()
        if base is None or not os.path.isdir(base):
            return []
        removed = []
        for fname in sorted(os.listdir(base)):
            if not fname.endswith((".json", ".sqlite")):
                continue
            family = fname.split("_", 1)[0]
            live = keep_schemas.get(family)
            m = ArtifactStore._FILE_RE.search(fname)
            if live is None or m is None or int(m.group(1)) == int(live):
                continue
            path = os.path.join(base, fname)
            try:
                os.unlink(path)
                removed.append(path)
            except OSError:
                pass                      # best effort: gc is maintenance
            for sidecar in (path + "-wal", path + "-shm"):
                try:
                    os.unlink(sidecar)
                    removed.append(sidecar)
                except OSError:
                    pass
        return removed


def live_schemas() -> Dict[str, int]:
    """Current schema version per store family (lazy imports: the producer
    modules import this one)."""
    from repro_torch.core import calibrate, markov, scheduler
    return {
        "ipc": _SCHEMA,
        "markov": markov.MARKOV_SCHEMA,
        "calib": calibrate.CALIB_STORE_SCHEMA,
        "decisions": scheduler.DECISION_STORE_SCHEMA,
    }


def ipc_store_name(gpu: GPUSpec, seed: int, rounds: int) -> str:
    """Stem of the per-(gpu, seed, rounds) IPC store file (the backend
    appends its own extension)."""
    return f"ipc_v{_SCHEMA}_{content_digest(gpu)}_s{seed}_r{rounds}"


class TypedIPCAccess:
    """prof_ws-keyed get/put on top of a raw (kind, key) store — shared by
    both IPC backends (``IPCCache`` and ``jobstore.SqliteIPCCache``)."""

    def get(self, kind: str, prof_ws):
        """kind: 'solo' | 'pair' | 'solo_w' | 'pair_w'; prof_ws:
        [(profile, w), ...]. Returns the cached float — or, for the exact
        kind 'pair', the (cipc1, cipc2) tuple — or None on miss (the
        watts kinds are single floats for both arities)."""
        val = super().get(kind, _entry_key(prof_ws))
        if val is None:
            return None
        return tuple(val) if kind == "pair" else float(val)

    def put(self, kind: str, prof_ws, value) -> None:
        super().put(kind, _entry_key(prof_ws),
                    list(value) if kind == "pair" else float(value))


# the store kinds every IPC backend carries: IPC values plus the matching
# per-config mean draw (``*_w``) written by the same measurement sweep
IPC_KINDS = ("solo", "pair", "solo_w", "pair_w")


class IPCCache(TypedIPCAccess, ArtifactStore):
    """One on-disk IPC table per (gpu, seed, rounds). Keeps the historical
    flat file layout (top-level per-kind dicts, schema in the file name)
    and the prof_ws-keyed get/put API on top of ``ArtifactStore``."""

    def __init__(self, gpu: GPUSpec, seed: int, rounds: int,
                 path: Optional[str] = None):
        base = path if path is not None else cache_dir()
        fpath = None
        if base is not None:
            fpath = os.path.join(base,
                                 ipc_store_name(gpu, seed, rounds) + ".json")
        super().__init__("ipc", IPC_KINDS, schema=_SCHEMA,
                         path=fpath)

    # historical flat layout: one top-level dict per kind with the schema
    # version carried by the file name instead of a field
    def _decode(self, raw) -> Optional[dict]:
        if (isinstance(raw, dict)
                and all(isinstance(raw.get(k), dict) for k in IPC_KINDS)):
            return {k: raw[k] for k in IPC_KINDS}
        return None

    def _encode(self, data: dict) -> dict:
        return data
