"""Durable serving state: the job state machine, the SQLite ``JobStore``,
and the SQLite backend for the artifact store's hot tables.

Kernelet is a *runtime* system: jobs arrive, get sliced, co-scheduled,
preempted, cancelled — and the dispatcher that does this must survive a
process restart without losing (or silently re-running) work. This module
provides the durability layer the serving daemon
(``repro.runtime.daemon``) is built on:

  * **Job state machine.** Explicit states ``queued → running →
    paused / cancelled / failed / finished`` with a transition table;
    anything not in the table raises ``IllegalTransition``. The extra
    ``running → queued`` edge is the crash-requeue: a job found
    ``running`` by a restarted daemon was interrupted mid-drain and is
    requeued for resumption from its last phase-boundary checkpoint.
  * **``JobStore``.** One SQLite file (WAL mode, schema-versioned via
    ``PRAGMA user_version``) holding the jobs table, an append-only
    event log (every transition is a row; the recovery tests compare
    event logs bit-for-bit), per-job phase-boundary checkpoints, final
    results, and the ``leases`` table. Every mutation is one IMMEDIATE
    transaction with bounded ``SQLITE_BUSY`` retries, so a SIGKILL
    between any two statements leaves a consistent store and sibling
    pods merely contend, never corrupt.
  * **Leases.** Multi-pod fleets (``repro.runtime.fleet_daemon``) share
    one store; the single-writer-per-job guarantee moves from "one
    process owns the file" to a per-job *lease*: ``acquire_lease`` is
    the only ``queued -> running`` gate, carries a TTL heartbeat, and
    hands back a monotonically increasing **fencing epoch**. Fenced
    writes (checkpoints, transitions) verify ``(pod_id, epoch)`` against
    the lease row inside the same transaction — a zombie pod waking
    after its lease expired (and the job was requeued or re-acquired)
    gets ``StaleLease`` instead of silently committing stale state.
  * **``SqliteArtifactStore``.** The hot-table backend for
    ``repro.core.ipc_cache``: same (name, schema, kinds, get/put/save/gc)
    contract as the JSON backend, but ``save()`` upserts only the entries
    written since the last save — O(dirty) instead of the JSON backend's
    O(total entries) whole-file rewrite (the PR 2/3 O(D²) hot-table
    problem; ``benchmarks/daemon_recovery.py`` pins the speedup).
    Selected via ``REPRO_STORE_BACKEND=sqlite``; the JSON backend remains
    the default and the fallback.

Durability model: WAL + ``synchronous=NORMAL`` — immune to process kills
(what the fault-injection tests exercise); on whole-machine power loss the
most recent commits may roll back but the file never tears. The artifact
stores are caches (recomputable), the job store's checkpoint granularity
is one drain phase, so either way no completed work is lost silently.
"""
from __future__ import annotations

import contextlib
import json
import os
import sqlite3
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import ipc_cache
from repro_torch.core.profiles import GPUSpec

# ---------------------------------------------------------------- #
# job state machine
# ---------------------------------------------------------------- #

QUEUED = "queued"
RUNNING = "running"
PAUSED = "paused"
CANCELLED = "cancelled"
FAILED = "failed"
FINISHED = "finished"

STATES = (QUEUED, RUNNING, PAUSED, CANCELLED, FAILED, FINISHED)
TERMINAL_STATES = frozenset((CANCELLED, FAILED, FINISHED))

# every legal edge; the running -> queued edge is the crash-requeue used
# by daemon recovery (the job was interrupted, not restarted from scratch:
# its checkpoint row still carries the phase-boundary state)
TRANSITIONS: Dict[str, frozenset] = {
    QUEUED: frozenset((RUNNING, CANCELLED)),
    RUNNING: frozenset((PAUSED, CANCELLED, FAILED, FINISHED, QUEUED)),
    PAUSED: frozenset((RUNNING, CANCELLED)),
    CANCELLED: frozenset(),
    FAILED: frozenset(),
    FINISHED: frozenset(),
}


class IllegalTransition(RuntimeError):
    """Raised for any job-state edge not in ``TRANSITIONS``."""


class JobStoreError(RuntimeError):
    """Storage-layer failure (unwritable/corrupt/schema-skewed database).
    The daemon treats these as transient and retries with backoff before
    degrading to read-only planning mode."""


class StaleLease(RuntimeError):
    """A fenced write carried a ``(pod_id, epoch)`` that no longer
    matches the job's lease: the lease expired and the job was requeued
    (or stolen and re-acquired at a higher epoch). Deliberately NOT a
    ``JobStoreError`` — retrying cannot help; the holder must abandon
    the job (another pod owns it now, exactly-once is preserved)."""


def check_transition(from_state: Optional[str], to_state: str) -> None:
    """Validate one edge (``from_state=None`` means job creation, which
    may only enter ``queued``)."""
    if to_state not in STATES:
        raise IllegalTransition(f"unknown state {to_state!r}")
    if from_state is None:
        if to_state != QUEUED:
            raise IllegalTransition(
                f"jobs are created queued, not {to_state!r}")
        return
    if from_state not in STATES:
        raise IllegalTransition(f"unknown state {from_state!r}")
    if to_state not in TRANSITIONS[from_state]:
        raise IllegalTransition(
            f"illegal transition {from_state!r} -> {to_state!r}")


# bump when the jobs/events/checkpoints/leases schema changes
# incompatibly (2 added the leases table for multi-pod fleets)
JOBSTORE_SCHEMA = 2

_JOBSTORE_DDL = (
    """CREATE TABLE IF NOT EXISTS jobs (
        job_id     TEXT PRIMARY KEY,
        state      TEXT NOT NULL,
        spec       TEXT NOT NULL,
        result     TEXT,
        created_at REAL NOT NULL,
        updated_at REAL NOT NULL)""",
    """CREATE TABLE IF NOT EXISTS events (
        seq        INTEGER PRIMARY KEY AUTOINCREMENT,
        job_id     TEXT NOT NULL,
        ts         REAL NOT NULL,
        from_state TEXT,
        to_state   TEXT NOT NULL,
        info       TEXT NOT NULL DEFAULT '')""",
    """CREATE TABLE IF NOT EXISTS checkpoints (
        job_id     TEXT PRIMARY KEY,
        phase      INTEGER NOT NULL,
        payload    TEXT NOT NULL,
        updated_at REAL NOT NULL)""",
    # one row per job that has ever been leased. pod_id = '' means
    # released/requeued (no holder); epoch is monotone per job and is
    # the fencing token — it NEVER resets, so any (pod, epoch) pair a
    # previous holder still carries can be rejected forever.
    """CREATE TABLE IF NOT EXISTS leases (
        job_id      TEXT PRIMARY KEY,
        pod_id      TEXT NOT NULL,
        epoch       INTEGER NOT NULL,
        acquired_at REAL NOT NULL,
        expires_at  REAL NOT NULL)""",
)


def _dumps(obj) -> str:
    # default=float absorbs np.float64 totals; Python's repr round-trip
    # keeps every float64 bit-exact through the store
    return json.dumps(obj, default=float)


class JobStore:
    """SQLite-backed durable job state: jobs, transitions (event log),
    phase-boundary checkpoints, leases, results. Single-writer *per job*
    (the lease gate); many pod connections may share the file — writes
    run as IMMEDIATE transactions with bounded ``SQLITE_BUSY`` retries,
    and ``contention`` counts every busy collision for the daemon stats.

    ``clock`` injects the wall clock (lease TTL arithmetic and event
    timestamps) so the chaos harness can skew per-pod time.
    """

    def __init__(self, path: str, *, timeout_s: float = 5.0,
                 clock=time.time, busy_retries: int = 6):
        self.path = path
        self._clock = clock
        self._busy_retries = max(0, int(busy_retries))
        self.contention = 0
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._conn = sqlite3.connect(path, timeout=timeout_s)
            self._conn.execute(
                f"PRAGMA busy_timeout = {int(timeout_s * 1000):d}")
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._init_schema()
        except (OSError, sqlite3.Error) as e:
            raise JobStoreError(f"cannot open job store at {path}: {e}") \
                from e

    def _init_schema(self) -> None:
        def txn():
            # version check and creation share one IMMEDIATE
            # transaction: two pods racing to create the same store
            # serialize here instead of tripping over half-made tables
            with self._immediate():
                ver = self._conn.execute(
                    "PRAGMA user_version").fetchone()[0]
                if ver == JOBSTORE_SCHEMA:
                    return
                if ver == 1:
                    # v1 (PR 6, pre-leases) migrates in place: the only
                    # delta is the leases table itself
                    self._conn.execute(_JOBSTORE_DDL[-1])
                    self._conn.execute(
                        f"PRAGMA user_version = {JOBSTORE_SCHEMA:d}")
                    return
                if ver != 0:
                    # durable state is NOT a cache: refuse loudly
                    # instead of silently starting empty next to real
                    # jobs
                    raise JobStoreError(
                        f"{self.path}: schema version {ver} != "
                        f"{JOBSTORE_SCHEMA} (migrate or point the "
                        "daemon at a fresh store)")
                has_jobs = self._conn.execute(
                    "SELECT name FROM sqlite_master WHERE type='table' "
                    "AND name='jobs'").fetchone()
                if has_jobs is not None:
                    # a pre-versioning file would land here; there is
                    # none, so any unversioned file with a jobs table
                    # is foreign
                    raise JobStoreError(
                        f"{self.path}: jobs table without a schema "
                        "version")
                for ddl in _JOBSTORE_DDL:
                    self._conn.execute(ddl)
                self._conn.execute(
                    f"PRAGMA user_version = {JOBSTORE_SCHEMA:d}")
        self._write(txn)

    def close(self) -> None:
        try:
            self._conn.close()
        except sqlite3.Error:
            pass

    # ---- multi-writer plumbing ---- #
    @contextlib.contextmanager
    def _immediate(self):
        """One write transaction opened IMMEDIATE: the read-check-write
        bodies below hold the write lock from their first statement, so
        a deferred-transaction upgrade can never fail mid-way under
        sibling-pod contention (SQLITE_BUSY_SNAPSHOT)."""
        self._conn.execute("BEGIN IMMEDIATE")
        try:
            yield self._conn
        except BaseException:
            self._conn.rollback()
            raise
        self._conn.commit()

    def _write(self, fn):
        """Run one write transaction with bounded retries on
        ``SQLITE_BUSY`` (lock contention from sibling pods); every
        retry re-runs the whole transaction body against a fresh
        snapshot. Each collision bumps ``contention`` (surfaced in
        daemon stats); exhausting the budget raises ``JobStoreError``
        (the daemon's transient-retry net takes over from there)."""
        delay = 0.002
        for attempt in range(self._busy_retries + 1):
            try:
                return fn()
            except sqlite3.OperationalError as e:
                msg = str(e).lower()
                if "locked" not in msg and "busy" not in msg:
                    raise JobStoreError(str(e)) from e
                self.contention += 1
                if attempt >= self._busy_retries:
                    raise JobStoreError(
                        f"{self.path}: still busy after "
                        f"{self._busy_retries} retries: {e}") from e
                time.sleep(delay)
                delay = min(delay * 2.0, 0.05)
            except sqlite3.Error as e:
                raise JobStoreError(str(e)) from e

    def data_version(self) -> int:
        """Cheap change detection for monitor loops: ``PRAGMA
        data_version`` bumps whenever *another* connection commits to
        this database — never for this connection's own writes — so an
        idle pod can poll one integer instead of re-scanning tables."""
        try:
            return int(self._conn.execute(
                "PRAGMA data_version").fetchone()[0])
        except sqlite3.Error as e:
            raise JobStoreError(str(e)) from e

    # ---- jobs ---- #
    def create_job(self, job_id: str, spec: dict) -> None:
        check_transition(None, QUEUED)

        def txn():
            now = self._clock()
            try:
                with self._immediate():
                    self._conn.execute(
                        "INSERT INTO jobs (job_id, state, spec, "
                        "created_at, updated_at) VALUES (?, ?, ?, ?, ?)",
                        (job_id, QUEUED, _dumps(spec), now, now))
                    self._conn.execute(
                        "INSERT INTO events (job_id, ts, from_state, "
                        "to_state, info) VALUES (?, ?, NULL, ?, ?)",
                        (job_id, now, QUEUED, "submitted"))
            except sqlite3.IntegrityError as e:
                raise JobStoreError(
                    f"job {job_id!r} already exists") from e
        self._write(txn)

    def transition(self, job_id: str, to_state: str, info: str = "",
                   result: Optional[dict] = None,
                   fence: Optional[Tuple[str, int]] = None) -> None:
        """Validated state transition; the jobs row update, the event-log
        append, and (optionally) the final result land in one transaction.

        ``fence=(pod_id, epoch)`` makes the write *fenced*: it commits
        only while that lease is still held (``StaleLease`` otherwise).
        Any transition out of ``running`` also releases the lease holder
        in the same transaction (the epoch row survives for fencing).
        """
        def txn():
            with self._immediate():
                row = self._conn.execute(
                    "SELECT state FROM jobs WHERE job_id = ?",
                    (job_id,)).fetchone()
                if row is None:
                    raise KeyError(f"unknown job {job_id!r}")
                check_transition(row[0], to_state)
                if fence is not None:
                    self._check_fence(job_id, fence[0], fence[1])
                now = self._clock()
                if result is not None:
                    self._conn.execute(
                        "UPDATE jobs SET state = ?, result = ?, "
                        "updated_at = ? WHERE job_id = ?",
                        (to_state, _dumps(result), now, job_id))
                else:
                    self._conn.execute(
                        "UPDATE jobs SET state = ?, updated_at = ? "
                        "WHERE job_id = ?", (to_state, now, job_id))
                if to_state != RUNNING:
                    self._conn.execute(
                        "UPDATE leases SET pod_id = '', expires_at = 0 "
                        "WHERE job_id = ?", (job_id,))
                self._conn.execute(
                    "INSERT INTO events (job_id, ts, from_state, "
                    "to_state, info) VALUES (?, ?, ?, ?, ?)",
                    (job_id, now, row[0], to_state, info))
        self._write(txn)

    # ---- leases (the multi-pod single-writer gate) ---- #
    def _check_fence(self, job_id: str, pod_id: str, epoch: int) -> None:
        row = self._conn.execute(
            "SELECT pod_id, epoch FROM leases WHERE job_id = ?",
            (job_id,)).fetchone()
        if row is None or row[0] != pod_id or int(row[1]) != int(epoch):
            held = None if row is None else (row[0], int(row[1]))
            raise StaleLease(
                f"job {job_id!r}: fence ({pod_id!r}, {int(epoch)}) "
                f"does not match lease {held!r}")

    def acquire_lease(self, job_id: str, pod_id: str, ttl_s: float, *,
                      now: Optional[float] = None,
                      from_state: str = QUEUED,
                      info: Optional[str] = None) -> Optional[int]:
        """Atomically claim ``job_id`` — the single-writer gate for
        ``queued -> running`` (pass ``from_state=PAUSED`` to resume a
        parked job). Returns the new fencing epoch, or ``None`` if the
        job is no longer in ``from_state`` (another pod won the race).
        The epoch increments on every acquisition and never resets, so
        every previous holder's fence is permanently invalidated."""
        def txn():
            t = self._clock() if now is None else now
            with self._immediate():
                row = self._conn.execute(
                    "SELECT state FROM jobs WHERE job_id = ?",
                    (job_id,)).fetchone()
                if row is None:
                    raise KeyError(f"unknown job {job_id!r}")
                if row[0] != from_state:
                    return None
                check_transition(from_state, RUNNING)
                lr = self._conn.execute(
                    "SELECT epoch FROM leases WHERE job_id = ?",
                    (job_id,)).fetchone()
                epoch = 1 if lr is None else int(lr[0]) + 1
                self._conn.execute(
                    "INSERT INTO leases (job_id, pod_id, epoch, "
                    "acquired_at, expires_at) VALUES (?, ?, ?, ?, ?) "
                    "ON CONFLICT(job_id) DO UPDATE SET "
                    "pod_id = excluded.pod_id, epoch = excluded.epoch, "
                    "acquired_at = excluded.acquired_at, "
                    "expires_at = excluded.expires_at",
                    (job_id, pod_id, epoch, t, t + float(ttl_s)))
                self._conn.execute(
                    "UPDATE jobs SET state = ?, updated_at = ? "
                    "WHERE job_id = ?", (RUNNING, t, job_id))
                self._conn.execute(
                    "INSERT INTO events (job_id, ts, from_state, "
                    "to_state, info) VALUES (?, ?, ?, ?, ?)",
                    (job_id, t, from_state, RUNNING,
                     info if info is not None
                     else f"leased by {pod_id} (epoch {epoch})"))
                return epoch
        return self._write(txn)

    def renew_lease(self, job_id: str, pod_id: str, epoch: int,
                    ttl_s: float, *,
                    now: Optional[float] = None) -> None:
        """Heartbeat: extend a held lease by ``ttl_s``. ``StaleLease``
        if the lease is no longer ``(pod_id, epoch)`` — the job was
        requeued (and possibly re-acquired); the caller must abandon
        it rather than keep draining."""
        def txn():
            t = self._clock() if now is None else now
            with self._immediate():
                self._check_fence(job_id, pod_id, epoch)
                self._conn.execute(
                    "UPDATE leases SET expires_at = ? WHERE job_id = ?",
                    (t + float(ttl_s), job_id))
        self._write(txn)

    def lease_of(self, job_id: str) -> Optional[Tuple[str, int, float]]:
        """Current lease row ``(pod_id, epoch, expires_at)`` or
        ``None``. ``pod_id == ''`` means released: the epoch survives
        for fencing, the holder is gone."""
        try:
            row = self._conn.execute(
                "SELECT pod_id, epoch, expires_at FROM leases "
                "WHERE job_id = ?", (job_id,)).fetchone()
        except sqlite3.Error as e:
            raise JobStoreError(str(e)) from e
        if row is None:
            return None
        return (row[0], int(row[1]), float(row[2]))

    def requeue_expired(self, *, now: Optional[float] = None) \
            -> List[Tuple[str, str, int]]:
        """Dead-pod detection: requeue every ``running`` job whose
        lease TTL has passed (the crash-requeue edge — its checkpoint
        stays, the next holder resumes) and blank the holder so the
        previous pod's fenced writes raise ``StaleLease`` from now on.
        Returns ``[(job_id, dead_pod_id, epoch), ...]``."""
        def txn():
            t = self._clock() if now is None else now
            with self._immediate():
                rows = self._conn.execute(
                    "SELECT l.job_id, l.pod_id, l.epoch FROM leases l "
                    "JOIN jobs j ON j.job_id = l.job_id "
                    "WHERE j.state = ? AND l.pod_id != '' "
                    "AND l.expires_at <= ?", (RUNNING, t)).fetchall()
                out = []
                for jid, pod, epoch in rows:
                    check_transition(RUNNING, QUEUED)
                    self._conn.execute(
                        "UPDATE jobs SET state = ?, updated_at = ? "
                        "WHERE job_id = ?", (QUEUED, t, jid))
                    self._conn.execute(
                        "UPDATE leases SET pod_id = '', expires_at = 0 "
                        "WHERE job_id = ?", (jid,))
                    self._conn.execute(
                        "INSERT INTO events (job_id, ts, from_state, "
                        "to_state, info) VALUES (?, ?, ?, ?, ?)",
                        (jid, t, RUNNING, QUEUED,
                         f"lease expired (pod {pod}, epoch "
                         f"{int(epoch)})"))
                    out.append((jid, pod, int(epoch)))
                return out
        return self._write(txn)

    def state(self, job_id: str) -> Optional[str]:
        try:
            row = self._conn.execute(
                "SELECT state FROM jobs WHERE job_id = ?",
                (job_id,)).fetchone()
        except sqlite3.Error as e:
            raise JobStoreError(str(e)) from e
        return None if row is None else row[0]

    def spec(self, job_id: str) -> dict:
        try:
            row = self._conn.execute(
                "SELECT spec FROM jobs WHERE job_id = ?",
                (job_id,)).fetchone()
        except sqlite3.Error as e:
            raise JobStoreError(str(e)) from e
        if row is None:
            raise KeyError(f"unknown job {job_id!r}")
        return json.loads(row[0])

    def result(self, job_id: str) -> Optional[dict]:
        try:
            row = self._conn.execute(
                "SELECT result FROM jobs WHERE job_id = ?",
                (job_id,)).fetchone()
        except sqlite3.Error as e:
            raise JobStoreError(str(e)) from e
        if row is None or row[0] is None:
            return None
        return json.loads(row[0])

    def jobs(self, state: Optional[str] = None) -> List[Tuple[str, str]]:
        """(job_id, state) rows, submission-ordered; optionally filtered."""
        try:
            if state is None:
                rows = self._conn.execute(
                    "SELECT job_id, state FROM jobs "
                    "ORDER BY created_at, job_id").fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT job_id, state FROM jobs WHERE state = ? "
                    "ORDER BY created_at, job_id", (state,)).fetchall()
        except sqlite3.Error as e:
            raise JobStoreError(str(e)) from e
        return [(r[0], r[1]) for r in rows]

    def events(self, job_id: Optional[str] = None) -> List[tuple]:
        """Append-only transition log: (seq, job_id, from, to, info)."""
        try:
            if job_id is None:
                rows = self._conn.execute(
                    "SELECT seq, job_id, from_state, to_state, info "
                    "FROM events ORDER BY seq").fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT seq, job_id, from_state, to_state, info "
                    "FROM events WHERE job_id = ? ORDER BY seq",
                    (job_id,)).fetchall()
        except sqlite3.Error as e:
            raise JobStoreError(str(e)) from e
        return [tuple(r) for r in rows]

    # ---- checkpoints ---- #
    def save_checkpoint(self, job_id: str, phase: int, payload: dict,
                        fence: Optional[Tuple[str, int]] = None) -> None:
        """Upsert the job's phase-boundary checkpoint. ``fence=(pod_id,
        epoch)`` verifies the lease inside the same transaction — the
        zombie-pod guard: a holder whose lease expired and was requeued
        can never overwrite the new holder's progress."""
        def txn():
            with self._immediate():
                if fence is not None:
                    self._check_fence(job_id, fence[0], fence[1])
                self._conn.execute(
                    "INSERT INTO checkpoints (job_id, phase, payload, "
                    "updated_at) VALUES (?, ?, ?, ?) "
                    "ON CONFLICT(job_id) DO UPDATE SET phase = excluded."
                    "phase, payload = excluded.payload, updated_at = "
                    "excluded.updated_at",
                    (job_id, int(phase), _dumps(payload),
                     self._clock()))
        self._write(txn)

    def load_checkpoint(self, job_id: str) -> Optional[Tuple[int, dict]]:
        try:
            row = self._conn.execute(
                "SELECT phase, payload FROM checkpoints WHERE job_id = ?",
                (job_id,)).fetchone()
        except sqlite3.Error as e:
            raise JobStoreError(str(e)) from e
        if row is None:
            return None
        return int(row[0]), json.loads(row[1])

    def drop_checkpoint(self, job_id: str) -> None:
        def txn():
            with self._immediate():
                self._conn.execute(
                    "DELETE FROM checkpoints WHERE job_id = ?",
                    (job_id,))
        self._write(txn)


class MemoryJobStore:
    """In-memory ``JobStore`` stand-in: the daemon's read-only-degrade
    target when the durable store is unwritable. Same API (leases and
    fencing included) and the same state-machine validation; nothing
    survives the process and nothing is shared across connections —
    ``data_version`` counts this instance's own mutations instead."""

    def __init__(self, *, clock=time.time):
        self._jobs: Dict[str, dict] = {}
        self._events: List[tuple] = []
        self._ckpts: Dict[str, Tuple[int, dict]] = {}
        # job_id -> [pod_id, epoch, expires_at]; pod_id '' = released
        self._leases: Dict[str, list] = {}
        self._clock = clock
        self._dv = 0
        self.contention = 0
        self.path = None

    def close(self) -> None:
        pass

    def data_version(self) -> int:
        return self._dv

    def create_job(self, job_id: str, spec: dict) -> None:
        check_transition(None, QUEUED)
        if job_id in self._jobs:
            raise JobStoreError(f"job {job_id!r} already exists")
        self._jobs[job_id] = {"state": QUEUED,
                              "spec": json.loads(_dumps(spec)),
                              "result": None}
        self._events.append((len(self._events) + 1, job_id, None, QUEUED,
                             "submitted"))
        self._dv += 1

    def _check_fence(self, job_id: str, pod_id: str, epoch: int) -> None:
        row = self._leases.get(job_id)
        if row is None or row[0] != pod_id or int(row[1]) != int(epoch):
            held = None if row is None else (row[0], int(row[1]))
            raise StaleLease(
                f"job {job_id!r}: fence ({pod_id!r}, {int(epoch)}) "
                f"does not match lease {held!r}")

    def transition(self, job_id: str, to_state: str, info: str = "",
                   result: Optional[dict] = None,
                   fence: Optional[Tuple[str, int]] = None) -> None:
        job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        check_transition(job["state"], to_state)
        if fence is not None:
            self._check_fence(job_id, fence[0], fence[1])
        self._events.append((len(self._events) + 1, job_id, job["state"],
                             to_state, info))
        job["state"] = to_state
        if to_state != RUNNING and job_id in self._leases:
            self._leases[job_id][0] = ""
            self._leases[job_id][2] = 0.0
        if result is not None:
            job["result"] = json.loads(_dumps(result))
        self._dv += 1

    def acquire_lease(self, job_id: str, pod_id: str, ttl_s: float, *,
                      now: Optional[float] = None,
                      from_state: str = QUEUED,
                      info: Optional[str] = None) -> Optional[int]:
        job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        if job["state"] != from_state:
            return None
        check_transition(from_state, RUNNING)
        t = self._clock() if now is None else now
        old = self._leases.get(job_id)
        epoch = 1 if old is None else int(old[1]) + 1
        self._leases[job_id] = [pod_id, epoch, t + float(ttl_s)]
        self._events.append(
            (len(self._events) + 1, job_id, from_state, RUNNING,
             info if info is not None
             else f"leased by {pod_id} (epoch {epoch})"))
        job["state"] = RUNNING
        self._dv += 1
        return epoch

    def renew_lease(self, job_id: str, pod_id: str, epoch: int,
                    ttl_s: float, *,
                    now: Optional[float] = None) -> None:
        self._check_fence(job_id, pod_id, epoch)
        t = self._clock() if now is None else now
        self._leases[job_id][2] = t + float(ttl_s)
        self._dv += 1

    def lease_of(self, job_id: str) -> Optional[Tuple[str, int, float]]:
        row = self._leases.get(job_id)
        if row is None:
            return None
        return (row[0], int(row[1]), float(row[2]))

    def requeue_expired(self, *, now: Optional[float] = None) \
            -> List[Tuple[str, str, int]]:
        t = self._clock() if now is None else now
        out = []
        for jid, row in self._leases.items():
            if (row[0] != "" and row[2] <= t
                    and self._jobs[jid]["state"] == RUNNING):
                check_transition(RUNNING, QUEUED)
                self._events.append(
                    (len(self._events) + 1, jid, RUNNING, QUEUED,
                     f"lease expired (pod {row[0]}, epoch "
                     f"{int(row[1])})"))
                self._jobs[jid]["state"] = QUEUED
                out.append((jid, row[0], int(row[1])))
                row[0] = ""
                row[2] = 0.0
                self._dv += 1
        return out

    def state(self, job_id: str) -> Optional[str]:
        job = self._jobs.get(job_id)
        return None if job is None else job["state"]

    def spec(self, job_id: str) -> dict:
        return self._jobs[job_id]["spec"]

    def result(self, job_id: str) -> Optional[dict]:
        return self._jobs[job_id]["result"]

    def jobs(self, state: Optional[str] = None) -> List[Tuple[str, str]]:
        return [(jid, j["state"]) for jid, j in self._jobs.items()
                if state is None or j["state"] == state]

    def events(self, job_id: Optional[str] = None) -> List[tuple]:
        return [e for e in self._events
                if job_id is None or e[1] == job_id]

    def save_checkpoint(self, job_id: str, phase: int, payload: dict,
                        fence: Optional[Tuple[str, int]] = None) -> None:
        if fence is not None:
            self._check_fence(job_id, fence[0], fence[1])
        self._ckpts[job_id] = (int(phase), json.loads(_dumps(payload)))
        self._dv += 1

    def load_checkpoint(self, job_id: str) -> Optional[Tuple[int, dict]]:
        return self._ckpts.get(job_id)

    def drop_checkpoint(self, job_id: str) -> None:
        self._ckpts.pop(job_id, None)
        self._dv += 1


# ---------------------------------------------------------------- #
# SQLite backend for the artifact store's hot tables
# ---------------------------------------------------------------- #

class SqliteArtifactStore(ipc_cache.ArtifactStore):
    """``ArtifactStore`` on SQLite: one ``<name>_v<schema>.sqlite`` file,
    entries in a (kind, key, value) table. ``save()`` upserts only the
    entries written since the last successful save — O(dirty), killing
    the JSON backend's whole-file rewrite — and the upsert union gives
    the same merge-on-save semantics (entries are content-addressed, so
    last-writer-wins is always valid).

    Failure contract matches the JSON backend: a corrupt or unreadable
    database loads as empty (and is quarantined so the next save can
    recreate it); an unwritable location degrades to in-memory with the
    store left dirty for a later retry.
    """

    def __init__(self, name: str, kinds: Sequence[str], schema: int = 1,
                 path: Optional[str] = None, dirname: Optional[str] = None):
        if path is None:
            base = dirname if dirname is not None else ipc_cache.cache_dir()
            path = (None if base is None
                    else os.path.join(base, f"{name}_v{schema}.sqlite"))
        self._fresh: Dict[tuple, object] = {}
        super().__init__(name, kinds, schema=schema, path=path)

    # ---- connection plumbing (per call: no lifecycle to manage) ---- #
    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.path, timeout=5.0)
        conn.execute("PRAGMA busy_timeout = 5000")
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    def _quarantine(self) -> None:
        """Drop an unreadable database file (plus WAL sidecars) so the
        next save starts clean — caches recompute, they never block."""
        for p in (self.path, self.path + "-wal", self.path + "-shm"):
            try:
                os.unlink(p)
            except OSError:
                pass

    def _load(self) -> dict:
        if self.path is None or not os.path.exists(self.path):
            return self._empty()
        data = self._empty()
        try:
            conn = self._connect()
        except sqlite3.Error:
            self._quarantine()
            return self._empty()
        try:
            ver = conn.execute("PRAGMA user_version").fetchone()[0]
            if ver != self._schema:
                # file-name and embedded versions disagree (hand-copied
                # file): reject the contents, recreate on next save
                return self._empty()
            for kind, key, raw in conn.execute(
                    "SELECT kind, key, value FROM entries"):
                if kind in data:
                    data[kind][key] = json.loads(raw)
        except (sqlite3.Error, ValueError):
            self._quarantine()
            return self._empty()
        finally:
            try:
                conn.close()
            except sqlite3.Error:
                pass
        return data

    def put(self, kind: str, key: str, value) -> None:
        super().put(kind, key, value)
        if self.path is not None:
            self._fresh[(kind, key)] = value

    def save(self) -> None:
        if self.path is None or not self._dirty:
            return
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            conn = self._connect()
        except (OSError, sqlite3.Error):
            return                        # unwritable: stay dirty, retry later
        try:
            with conn:
                conn.execute(
                    "CREATE TABLE IF NOT EXISTS entries ("
                    "kind TEXT NOT NULL, key TEXT NOT NULL, "
                    "value TEXT NOT NULL, PRIMARY KEY (kind, key))")
                conn.execute(f"PRAGMA user_version = {self._schema:d}")
                rows = [(k, key, json.dumps(v))
                        for (k, key), v in self._fresh.items()]
                conn.executemany(
                    "INSERT OR REPLACE INTO entries (kind, key, value) "
                    "VALUES (?, ?, ?)", rows)
            self._fresh.clear()
            self._dirty = False
        except sqlite3.Error:
            pass                          # degraded: stay dirty, retry later
        finally:
            try:
                conn.close()
            except sqlite3.Error:
                pass


class SqliteIPCCache(ipc_cache.TypedIPCAccess, SqliteArtifactStore):
    """SQLite counterpart of ``IPCCache``: same per-(gpu, seed, rounds)
    file identity and prof_ws-keyed typed access, sqlite storage."""

    def __init__(self, gpu: GPUSpec, seed: int, rounds: int,
                 path: Optional[str] = None):
        base = path if path is not None else ipc_cache.cache_dir()
        fpath = None
        if base is not None:
            fpath = os.path.join(
                base, ipc_cache.ipc_store_name(gpu, seed, rounds)
                + ".sqlite")
        super().__init__("ipc", ipc_cache.IPC_KINDS,
                         schema=ipc_cache._SCHEMA, path=fpath)
