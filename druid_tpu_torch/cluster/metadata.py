"""The SQL metadata store (sqlite): the cluster's source of truth.

The port's own copy of the reference package's `cluster/metadata.py`:
`SegmentDescriptor` (the DataSegment analog: identity, shard spec and size,
without the column data), `SegmentAllocationError`, `StaleTermError` and
`MetadataStore`, with the same schema and semantics.

Reference analogs:
  segments table + transactional publish — server/src/main/java/org/apache/
    druid/metadata/IndexerSQLMetadataStorageCoordinator.java (announceHistorical
    Segments with dataSource-metadata compare-and-swap = exactly-once streaming
    publish), MetadataSegmentManager.java (used-segment polling)
  rules table — metadata/MetadataRuleManager.java
  audit — server/audit/SQLAuditManager.java

Segments are stored as JSON descriptors (DataSegment analog); payload columns
keep (datasource, start, end, version, partition, used) queryable. The
datasource metadata CAS is the exactly-once hook used by streaming ingestion
(offsets and segments commit in one transaction).
"""
from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from druid_tpu_torch.cluster.shardspec import ShardSpec, shardspec_from_json
from druid_tpu_torch.utils.intervals import Interval, ts_to_iso


class SegmentAllocationError(RuntimeError):
    """Allocation refused: the bucket conflicts with differently-aligned
    committed segments (SegmentAllocateAction returns null there)."""


class StaleTermError(RuntimeError):
    """A fenced write carried a term older than the current lease term:
    the writer's lease was taken over and it must stop acting as leader
    (the fencing-token rejection of a zombie leader's writes)."""


@dataclass(frozen=True)
class SegmentDescriptor:
    """DataSegment analog (api/.../timeline/DataSegment.java): identity +
    shard spec + size/location metadata, without the column data."""
    datasource: str
    interval: Interval
    version: str
    partition: int = 0
    shard_spec: Optional[ShardSpec] = None
    size_bytes: int = 0
    num_rows: int = 0
    load_spec: Optional[dict] = None   # where the segment file lives

    @property
    def id(self) -> str:
        return (f"{self.datasource}_{self.interval}_{self.version}"
                f"_{self.partition}")

    def to_json(self) -> dict:
        return {"dataSource": self.datasource, "interval": str(self.interval),
                "version": self.version,
                "shardSpec": (self.shard_spec.to_json() if self.shard_spec
                              else {"type": "numbered",
                                    "partitionNum": self.partition,
                                    "partitions": 0}),
                "size": self.size_bytes, "numRows": self.num_rows,
                "loadSpec": self.load_spec}

    @staticmethod
    def from_json(j: dict) -> "SegmentDescriptor":
        spec = shardspec_from_json(j.get("shardSpec"))
        return SegmentDescriptor(
            j["dataSource"], Interval.parse(j["interval"]), j["version"],
            getattr(spec, "partition_num", 0), spec,
            j.get("size", 0), j.get("numRows", 0), j.get("loadSpec"))


class MetadataStore:
    """sqlite-backed metadata store; ':memory:' for tests, a file path for
    durability. Thread-safe via one connection + lock (sqlite serializes
    writers anyway; the reference uses JDBI connection pools)."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        self._create_tables()

    def _create_tables(self):
        with self._lock, self._conn as c:
            c.executescript("""
            CREATE TABLE IF NOT EXISTS segments (
              id TEXT PRIMARY KEY, datasource TEXT NOT NULL,
              start INTEGER NOT NULL, end INTEGER NOT NULL,
              version TEXT NOT NULL, partition_num INTEGER NOT NULL,
              used INTEGER NOT NULL DEFAULT 1,
              created_ms INTEGER NOT NULL, payload TEXT NOT NULL);
            CREATE INDEX IF NOT EXISTS idx_segments_ds
              ON segments(datasource, used);
            CREATE TABLE IF NOT EXISTS datasource_metadata (
              datasource TEXT PRIMARY KEY, commit_metadata TEXT NOT NULL);
            CREATE TABLE IF NOT EXISTS rules (
              datasource TEXT PRIMARY KEY, payload TEXT NOT NULL,
              updated_ms INTEGER NOT NULL);
            CREATE TABLE IF NOT EXISTS config (
              name TEXT PRIMARY KEY, payload TEXT NOT NULL);
            CREATE TABLE IF NOT EXISTS audit (
              id INTEGER PRIMARY KEY AUTOINCREMENT, audit_key TEXT,
              type TEXT, author TEXT, comment_txt TEXT, created_ms INTEGER,
              payload TEXT);
            CREATE TABLE IF NOT EXISTS tasks (
              id TEXT PRIMARY KEY, datasource TEXT, status TEXT,
              created_ms INTEGER, payload TEXT);
            CREATE TABLE IF NOT EXISTS supervisors (
              id TEXT PRIMARY KEY, payload TEXT NOT NULL);
            CREATE TABLE IF NOT EXISTS pending_segments (
              id TEXT PRIMARY KEY, datasource TEXT NOT NULL,
              start INTEGER NOT NULL, end INTEGER NOT NULL,
              version TEXT NOT NULL, partition_num INTEGER NOT NULL,
              created_ms INTEGER NOT NULL);
            CREATE TABLE IF NOT EXISTS leases (
              service TEXT PRIMARY KEY, holder TEXT NOT NULL,
              term INTEGER NOT NULL, expires_ms INTEGER NOT NULL,
              meta TEXT);
            CREATE TABLE IF NOT EXISTS fence_log (
              id INTEGER PRIMARY KEY AUTOINCREMENT, service TEXT NOT NULL,
              term INTEGER NOT NULL, holder TEXT NOT NULL, op TEXT NOT NULL,
              created_ms INTEGER NOT NULL);
            """)

    # ---- leader leases (coordination source of truth) -------------------
    def try_acquire_lease(self, service: str, holder: str, now_ms: int,
                          lease_ms: int, meta: Optional[dict] = None
                          ) -> Optional[Tuple[int, int]]:
        """Atomic acquire-or-renew of the leader lease for `service`.
        Returns (term, expires_ms) when `holder` holds the lease after this
        call, None when another holder's unexpired lease blocks it.

        The term is the fencing token: it increments on every ownership
        change (including re-acquiring one's own EXPIRED lease — the gap may
        have admitted another writer), and stays fixed across renewals of a
        live lease. Writes fenced with an old term are rejected by
        check_fence even if the zombie still believes it leads."""
        expires = now_ms + lease_ms
        m = json.dumps(meta, sort_keys=True) if meta is not None else None
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                cur = self._conn.execute(
                    "SELECT holder, term, expires_ms FROM leases "
                    "WHERE service = ?", (service,))
                row = cur.fetchone()
                if row is None:
                    self._conn.execute(
                        "INSERT INTO leases(service, holder, term, "
                        "expires_ms, meta) VALUES(?,?,1,?,?)",
                        (service, holder, expires, m))
                    self._conn.execute("COMMIT")
                    return 1, expires
                cur_holder, term, cur_expires = row
                if cur_holder == holder and now_ms < cur_expires:
                    # renewal of a live lease: same term
                    self._conn.execute(
                        "UPDATE leases SET expires_ms = ?, meta = ? "
                        "WHERE service = ?", (expires, m, service))
                    self._conn.execute("COMMIT")
                    return int(term), expires
                if now_ms < cur_expires:
                    self._conn.execute("ROLLBACK")
                    return None            # someone else holds it, live
                # expired: takeover (by anyone, incl. the old holder)
                self._conn.execute(
                    "UPDATE leases SET holder = ?, term = term + 1, "
                    "expires_ms = ?, meta = ? WHERE service = ?",
                    (holder, expires, m, service))
                self._conn.execute("COMMIT")
                return int(term) + 1, expires
            except BaseException:
                try:
                    self._conn.execute("ROLLBACK")
                except sqlite3.OperationalError:
                    pass
                raise

    def read_lease(self, service: str) -> Optional[dict]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT holder, term, expires_ms, meta FROM leases "
                "WHERE service = ?", (service,))
            row = cur.fetchone()
            if row is None:
                return None
            return {"service": service, "holder": row[0], "term": int(row[1]),
                    "expiresMs": int(row[2]),
                    "meta": json.loads(row[3]) if row[3] else None}

    def release_lease(self, service: str, holder: str) -> bool:
        """Voluntary step-down (graceful shutdown): only the current holder
        may release; the row stays (term history preserved) but expires
        immediately so any standby's next heartbeat takes over."""
        with self._lock, self._conn as c:
            return c.execute(
                "UPDATE leases SET expires_ms = 0 WHERE service = ? AND "
                "holder = ?", (service, holder)).rowcount > 0

    def _check_fence_locked(self, fence: Tuple[str, int, str],
                            op: str, now_ms: int) -> None:
        """Validate (service, term, holder) against the lease row and log
        the accepted write — caller holds self._lock and an open txn (or
        the implicit one of `with self._conn`). Raises StaleTermError when
        the term is not the CURRENT term of the service's lease."""
        service, term, holder = fence
        cur = self._conn.execute(
            "SELECT holder, term FROM leases WHERE service = ?", (service,))
        row = cur.fetchone()
        if row is None:
            raise StaleTermError(
                f"fenced write [{op}] for service [{service}] but no lease "
                f"exists — writer [{holder}] was never elected")
        cur_holder, cur_term = row[0], int(row[1])
        if term != cur_term or holder != cur_holder:
            raise StaleTermError(
                f"stale fencing term for [{service}]: write [{op}] from "
                f"[{holder}] term {term} rejected — current leader is "
                f"[{cur_holder}] term {cur_term}")
        self._conn.execute(
            "INSERT INTO fence_log(service, term, holder, op, created_ms) "
            "VALUES(?,?,?,?,?)", (service, term, holder, op, now_ms))

    def fence_log(self, service: Optional[str] = None) -> List[dict]:
        """Accepted fenced writes, oldest first — the audit trail the
        single-writer-per-term safety tests assert over."""
        with self._lock:
            q = ("SELECT service, term, holder, op, created_ms FROM "
                 "fence_log")
            args: tuple = ()
            if service is not None:
                q += " WHERE service = ?"
                args = (service,)
            return [{"service": r[0], "term": int(r[1]), "holder": r[2],
                     "op": r[3], "created": int(r[4])}
                    for r in self._conn.execute(q + " ORDER BY id", args)]

    # ---- segments ------------------------------------------------------
    def publish_segments(self, descriptors: Sequence[SegmentDescriptor],
                         datasource_meta_update: Optional[Tuple[str, Optional[dict], dict]] = None,
                         fence: Optional[Tuple[str, int, str]] = None
                         ) -> bool:
        """Transactionally insert segments; optionally CAS the datasource
        commit metadata (start_metadata → end_metadata) in the SAME
        transaction — the exactly-once publish of
        IndexerSQLMetadataStorageCoordinator.announceHistoricalSegments.
        Returns False (and commits nothing) if the CAS comparison fails.

        fence: optional (service, term, holder) fencing token — the write
        commits only if `term` is still the service's CURRENT lease term
        (StaleTermError otherwise), in the same transaction, so a deposed
        leader cannot race a commit past its successor's takeover."""
        now = int(time.time() * 1000)
        with self._lock:
            try:
                self._conn.execute("BEGIN IMMEDIATE")
                if fence is not None:
                    self._check_fence_locked(fence, "publish_segments", now)
                if datasource_meta_update is not None:
                    ds, expected, new = datasource_meta_update
                    cur = self._conn.execute(
                        "SELECT commit_metadata FROM datasource_metadata "
                        "WHERE datasource = ?", (ds,))
                    row = cur.fetchone()
                    current = json.loads(row[0]) if row else None
                    if current != expected:
                        self._conn.execute("ROLLBACK")
                        return False
                    self._conn.execute(
                        "INSERT INTO datasource_metadata(datasource, commit_metadata) "
                        "VALUES(?, ?) ON CONFLICT(datasource) DO UPDATE SET "
                        "commit_metadata = excluded.commit_metadata",
                        (ds, json.dumps(new, sort_keys=True)))
                for d in descriptors:
                    self._conn.execute(
                        "INSERT OR IGNORE INTO segments(id, datasource, start, "
                        "end, version, partition_num, used, created_ms, payload) "
                        "VALUES(?,?,?,?,?,?,1,?,?)",
                        (d.id, d.datasource, d.interval.start, d.interval.end,
                         d.version, d.partition, now,
                         json.dumps(d.to_json(), sort_keys=True)))
                    self._conn.execute(
                        "DELETE FROM pending_segments WHERE id = ?", (d.id,))
                self._conn.execute("COMMIT")
                return True
            except BaseException:
                try:
                    self._conn.execute("ROLLBACK")
                except sqlite3.OperationalError:
                    pass
                raise

    def used_segments(self, datasource: Optional[str] = None
                      ) -> List[SegmentDescriptor]:
        with self._lock:
            if datasource is None:
                cur = self._conn.execute(
                    "SELECT payload FROM segments WHERE used = 1")
            else:
                cur = self._conn.execute(
                    "SELECT payload FROM segments WHERE used = 1 AND "
                    "datasource = ?", (datasource,))
            return [SegmentDescriptor.from_json(json.loads(r[0]))
                    for r in cur.fetchall()]

    def mark_unused(self, segment_ids: Sequence[str],
                    fence: Optional[Tuple[str, int, str]] = None) -> int:
        with self._lock, self._conn as c:
            if fence is not None:
                self._check_fence_locked(fence, "mark_unused",
                                         int(time.time() * 1000))
            n = 0
            for sid in segment_ids:
                n += c.execute("UPDATE segments SET used = 0 WHERE id = ?",
                               (sid,)).rowcount
            return n

    def mark_used(self, segment_ids: Sequence[str],
                  fence: Optional[Tuple[str, int, str]] = None) -> int:
        with self._lock, self._conn as c:
            if fence is not None:
                self._check_fence_locked(fence, "mark_used",
                                         int(time.time() * 1000))
            n = 0
            for sid in segment_ids:
                n += c.execute("UPDATE segments SET used = 1 WHERE id = ?",
                               (sid,)).rowcount
            return n

    def update_segment_payload(self, descriptor: SegmentDescriptor) -> bool:
        """Rewrite a segment's stored payload in place — the metadata step
        of archive/move/restore, which changes only the loadSpec."""
        with self._lock, self._conn as c:
            n = c.execute(
                "UPDATE segments SET payload = ? WHERE id = ?",
                (json.dumps(descriptor.to_json(), sort_keys=True),
                 descriptor.id)).rowcount
            return n > 0

    def delete_segments(self, segment_ids: Sequence[str],
                        fence: Optional[Tuple[str, int, str]] = None) -> int:
        """Permanent removal (the kill-task step after mark_unused)."""
        with self._lock, self._conn as c:
            if fence is not None:
                self._check_fence_locked(fence, "delete_segments",
                                         int(time.time() * 1000))
            n = 0
            for sid in segment_ids:
                n += c.execute("DELETE FROM segments WHERE id = ?",
                               (sid,)).rowcount
            return n

    def unused_segments(self, datasource: str,
                        interval: Optional[Interval] = None
                        ) -> List[SegmentDescriptor]:
        with self._lock:
            if interval is None:
                cur = self._conn.execute(
                    "SELECT payload FROM segments WHERE used = 0 AND "
                    "datasource = ?", (datasource,))
            else:
                cur = self._conn.execute(
                    "SELECT payload FROM segments WHERE used = 0 AND "
                    "datasource = ? AND start >= ? AND end <= ?",
                    (datasource, interval.start, interval.end))
            return [SegmentDescriptor.from_json(json.loads(r[0]))
                    for r in cur.fetchall()]

    def visible_segments(self, datasource: str,
                         interval: Optional[Interval] = None
                         ) -> List[SegmentDescriptor]:
        """Used segments VISIBLE under MVCC (overshadowed versions excluded)
        — what queries and compaction must operate on, vs. raw
        used_segments which may still contain not-yet-cleaned old versions."""
        from druid_tpu_torch.cluster.shardspec import NoneShardSpec as _None
        from druid_tpu_torch.cluster.timeline import (PartitionChunk,
                                                      VersionedIntervalTimeline)
        tl: VersionedIntervalTimeline = VersionedIntervalTimeline()
        for d in self.used_segments(datasource):
            spec = d.shard_spec or _None(d.partition)
            tl.add(d.interval, d.version, PartitionChunk(spec, d))
        iv = interval if interval is not None else Interval.eternity()
        out, seen = [], set()
        for holder in tl.lookup(iv):
            for chunk in holder.partitions:
                if chunk.obj.id not in seen:
                    seen.add(chunk.obj.id)
                    out.append(chunk.obj)
        return out

    def datasources(self) -> List[str]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT DISTINCT datasource FROM segments WHERE used = 1")
            return sorted(r[0] for r in cur.fetchall())

    def max_version(self, datasource: str, interval: Interval) -> Optional[str]:
        """Highest version overlapping the interval (segment allocation)."""
        with self._lock:
            cur = self._conn.execute(
                "SELECT MAX(version) FROM segments WHERE datasource = ? AND "
                "used = 1 AND start < ? AND end > ?",
                (datasource, interval.end, interval.start))
            row = cur.fetchone()
            return row[0] if row else None

    def max_partition(self, datasource: str, interval: Interval,
                      version: str) -> int:
        with self._lock:
            cur = self._conn.execute(
                "SELECT MAX(partition_num) FROM segments WHERE datasource = ? "
                "AND version = ? AND start = ? AND end = ?",
                (datasource, version, interval.start, interval.end))
            row = cur.fetchone()
            return -1 if row is None or row[0] is None else int(row[0])

    def allocate_segment(self, datasource: str, interval: Interval,
                         version: Optional[str] = None
                         ) -> Tuple[str, int]:
        """Atomically allocate (version, partition) for a new segment in the
        given time bucket — the overlord's SegmentAllocateAction: all
        concurrent writers to one bucket get the SAME version (appends are
        siblings, not overshadowing) and unique ascending partitions, by
        transacting against used + pending segments together."""
        now = int(time.time() * 1000)
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                # refuse buckets that overlap differently-aligned committed
                # segments: minting a newer version there would partially
                # overshadow (hide) their data
                cur = self._conn.execute(
                    "SELECT (SELECT COUNT(*) FROM segments WHERE "
                    "datasource = ? AND used = 1 AND start < ? AND end > ? "
                    "AND NOT (start = ? AND end = ?)) + "
                    "(SELECT COUNT(*) FROM pending_segments WHERE "
                    "datasource = ? AND start < ? AND end > ? "
                    "AND NOT (start = ? AND end = ?))",
                    (datasource, interval.end, interval.start,
                     interval.start, interval.end) * 2)
                if cur.fetchone()[0]:
                    self._conn.execute("ROLLBACK")
                    raise SegmentAllocationError(
                        f"bucket {interval} overlaps existing segments of a "
                        f"different granularity in [{datasource}]")
                if version is None:
                    cur = self._conn.execute(
                        "SELECT version FROM pending_segments WHERE "
                        "datasource = ? AND start = ? AND end = ? "
                        "UNION SELECT version FROM segments WHERE "
                        "datasource = ? AND start = ? AND end = ? AND used = 1",
                        (datasource, interval.start, interval.end) * 2)
                    versions = sorted(r[0] for r in cur.fetchall())
                    version = versions[-1] if versions else ts_to_iso(now)
                cur = self._conn.execute(
                    "SELECT MAX(partition_num) FROM (SELECT partition_num "
                    "FROM pending_segments WHERE datasource = ? AND "
                    "start = ? AND end = ? AND version = ? UNION ALL "
                    "SELECT partition_num FROM segments WHERE datasource = ? "
                    "AND start = ? AND end = ? AND version = ?)",
                    (datasource, interval.start, interval.end, version) * 2)
                row = cur.fetchone()
                part = 0 if row is None or row[0] is None else int(row[0]) + 1
                sid = f"{datasource}_{interval}_{version}_{part}"
                self._conn.execute(
                    "INSERT INTO pending_segments(id, datasource, start, end, "
                    "version, partition_num, created_ms) VALUES(?,?,?,?,?,?,?)",
                    (sid, datasource, interval.start, interval.end, version,
                     part, now))
                self._conn.execute("COMMIT")
                return version, part
            except BaseException:
                try:
                    self._conn.execute("ROLLBACK")
                except sqlite3.OperationalError:
                    pass
                raise

    def kill_pending_segments(self, datasource: str,
                              created_before_ms: Optional[int] = None) -> int:
        """Drop allocation leftovers from failed/discarded tasks
        (overlord killPendingSegments)."""
        with self._lock, self._conn as c:
            if created_before_ms is None:
                return c.execute(
                    "DELETE FROM pending_segments WHERE datasource = ?",
                    (datasource,)).rowcount
            return c.execute(
                "DELETE FROM pending_segments WHERE datasource = ? AND "
                "created_ms < ?", (datasource, created_before_ms)).rowcount

    # ---- datasource commit metadata (streaming offsets) ----------------
    def datasource_metadata(self, datasource: str) -> Optional[dict]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT commit_metadata FROM datasource_metadata WHERE "
                "datasource = ?", (datasource,))
            row = cur.fetchone()
            return json.loads(row[0]) if row else None

    def reset_datasource_metadata(self, datasource: str) -> None:
        with self._lock, self._conn as c:
            c.execute("DELETE FROM datasource_metadata WHERE datasource = ?",
                      (datasource,))

    # ---- rules ---------------------------------------------------------
    def set_rules(self, datasource: str, rules: List[dict]) -> None:
        with self._lock, self._conn as c:
            c.execute(
                "INSERT INTO rules(datasource, payload, updated_ms) "
                "VALUES(?,?,?) ON CONFLICT(datasource) DO UPDATE SET "
                "payload = excluded.payload, updated_ms = excluded.updated_ms",
                (datasource, json.dumps(rules), int(time.time() * 1000)))

    def rules_for(self, datasource: str) -> List[dict]:
        """Datasource rules + default-datasource (_default) rules appended —
        the reference's rule resolution order."""
        with self._lock:
            out = []
            for ds in (datasource, "_default"):
                cur = self._conn.execute(
                    "SELECT payload FROM rules WHERE datasource = ?", (ds,))
                row = cur.fetchone()
                if row:
                    out += json.loads(row[0])
            return out

    # ---- config / audit ------------------------------------------------
    def set_config(self, name: str, payload: dict) -> None:
        with self._lock, self._conn as c:
            c.execute("INSERT INTO config(name, payload) VALUES(?,?) "
                      "ON CONFLICT(name) DO UPDATE SET payload = excluded.payload",
                      (name, json.dumps(payload)))

    def get_config(self, name: str, default: Optional[dict] = None
                   ) -> Optional[dict]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT payload FROM config WHERE name = ?", (name,))
            row = cur.fetchone()
            return json.loads(row[0]) if row else default

    def audit(self, key: str, type_: str, author: str, comment: str,
              payload: dict) -> None:
        with self._lock, self._conn as c:
            c.execute("INSERT INTO audit(audit_key, type, author, comment_txt, "
                      "created_ms, payload) VALUES(?,?,?,?,?,?)",
                      (key, type_, author, comment, int(time.time() * 1000),
                       json.dumps(payload)))

    def audit_log(self, key: Optional[str] = None) -> List[dict]:
        with self._lock:
            q = "SELECT audit_key, type, author, comment_txt, created_ms, payload FROM audit"
            args: tuple = ()
            if key is not None:
                q += " WHERE audit_key = ?"
                args = (key,)
            return [{"key": r[0], "type": r[1], "author": r[2],
                     "comment": r[3], "created": r[4],
                     "payload": json.loads(r[5])}
                    for r in self._conn.execute(q + " ORDER BY id", args)]

    # ---- tasks / supervisors (used by the indexing service) ------------
    def insert_task(self, task_id: str, datasource: str, status: str,
                    payload: dict,
                    fence: Optional[Tuple[str, int, str]] = None) -> None:
        with self._lock, self._conn as c:
            now = int(time.time() * 1000)
            if fence is not None:
                self._check_fence_locked(fence, "insert_task", now)
            c.execute("INSERT OR REPLACE INTO tasks(id, datasource, status, "
                      "created_ms, payload) VALUES(?,?,?,?,?)",
                      (task_id, datasource, status, now,
                       json.dumps(payload)))

    def update_task_status(self, task_id: str, status: str,
                           fence: Optional[Tuple[str, int, str]] = None
                           ) -> None:
        with self._lock, self._conn as c:
            if fence is not None:
                self._check_fence_locked(fence, "update_task_status",
                                         int(time.time() * 1000))
            c.execute("UPDATE tasks SET status = ? WHERE id = ?",
                      (status, task_id))

    def task(self, task_id: str) -> Optional[dict]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT id, datasource, status, payload FROM tasks WHERE id = ?",
                (task_id,))
            r = cur.fetchone()
            if r is None:
                return None
            return {"id": r[0], "datasource": r[1], "status": r[2],
                    "payload": json.loads(r[3])}

    def tasks(self, status: Optional[str] = None) -> List[dict]:
        with self._lock:
            if status is None:
                cur = self._conn.execute(
                    "SELECT id, datasource, status, payload FROM tasks")
            else:
                cur = self._conn.execute(
                    "SELECT id, datasource, status, payload FROM tasks "
                    "WHERE status = ?", (status,))
            return [{"id": r[0], "datasource": r[1], "status": r[2],
                     "payload": json.loads(r[3])} for r in cur.fetchall()]

    def set_supervisor(self, supervisor_id: str, payload: dict) -> None:
        with self._lock, self._conn as c:
            c.execute("INSERT OR REPLACE INTO supervisors(id, payload) "
                      "VALUES(?,?)", (supervisor_id, json.dumps(payload)))

    def supervisors(self) -> Dict[str, dict]:
        with self._lock:
            return {r[0]: json.loads(r[1]) for r in self._conn.execute(
                "SELECT id, payload FROM supervisors")}
