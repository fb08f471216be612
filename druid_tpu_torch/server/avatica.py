"""Avatica JSON-RPC endpoint: the JDBC entry point (the port's own copy of
the reference package's `server/avatica.py`, stdlib only).

Reference analog: sql/src/main/java/org/apache/druid/sql/avatica/
DruidMeta.java + DruidAvaticaJsonHandler (POST /druid/v2/sql/avatica/) —
the Calcite Avatica remote-driver wire protocol (JSON flavor). The subset
implemented here covers what the Avatica JDBC driver issues for plain
statement execution: openConnection / createStatement / prepareAndExecute
/ prepare / execute / fetch / closeStatement / closeConnection /
connectionSync / databaseProperty.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence

_SQL_TYPE = {"string": ("VARCHAR", 12), "long": ("BIGINT", -5),
             "double": ("DOUBLE", 8), "float": ("FLOAT", 6),
             "timestamp": ("TIMESTAMP", 93)}


def _ident_key(identity) -> Optional[str]:
    """Normalize an identity (AuthenticationResult | str | None) to the
    comparable key connections bind to."""
    if identity is None:
        return None
    return getattr(identity, "identity", str(identity))


def _signature(columns: Sequence[str], rows: Sequence[list]) -> dict:
    """Column signature inferred from the result values (the executor
    shapes types; Avatica needs JDBC type codes)."""
    cols = []
    for i, name in enumerate(columns):
        kind = "string"
        for r in rows:
            v = r[i] if i < len(r) else None
            if isinstance(v, bool) or v is None:
                continue
            if isinstance(v, int):
                kind = "long"
                break
            if isinstance(v, float):
                kind = "double"
                break
            kind = "string"
            break
        tname, tid = _SQL_TYPE[kind]
        cols.append({
            "ordinal": i, "columnName": name, "label": name,
            "type": {"type": "scalar", "name": tname, "id": tid,
                     "rep": "OBJECT"},
            "nullable": 1,
        })
    return {"columns": cols, "sql": None, "parameters": [],
            "cursorFactory": {"style": "LIST"}, "statementType": "SELECT"}


class _Statement:
    def __init__(self, statement_id: int):
        self.id = statement_id
        self.columns: List[str] = []
        self.rows: List[list] = []
        self.sql: Optional[str] = None     # set by prepare


class _Connection:
    def __init__(self, connection_id: str, identity: Optional[str] = None):
        self.id = connection_id
        self.identity = identity     # bound at open; all requests must match
        self.statements: Dict[int, _Statement] = {}
        self.next_statement = 0
        self.last_used = time.monotonic()


class AvaticaServer:
    """Protocol state + request dispatch; mount under the query HTTP
    server at /druid/v2/sql/avatica/."""

    def __init__(self, sql_executor, max_connections: int = 50,
                 max_rows_per_frame: int = 5000):
        self.sql = sql_executor
        self.max_connections = max_connections
        self.max_rows_per_frame = max_rows_per_frame
        self._conns: Dict[str, _Connection] = {}
        self._lock = threading.Lock()

    # ---- dispatch -------------------------------------------------------
    def handle(self, payload: dict, authorize=None,
               identity: Optional[str] = None) -> dict:
        """authorize: optional (sql, params) -> bool — the same per-table
        decision the plain SQL resource makes; execution requests run it
        first. identity: the authenticated caller — connections BIND to
        the identity that opened them, so one user cannot fetch another's
        buffered rows by guessing a connection id (DruidMeta ties
        connections to the authenticated user)."""
        req = payload.get("request")
        fn = getattr(self, f"_req_{req}", None)
        if fn is None:
            return self._error(f"unsupported avatica request {req!r}")
        # request-scoped copy: identity rides the payload (instance state
        # would race across concurrent handler threads)
        payload = dict(payload)
        payload["__identity__"] = _ident_key(identity)
        try:
            if req in ("prepareAndExecute", "execute"):
                return fn(payload, authorize)
            return fn(payload)
        except KeyError as e:
            return self._error(f"missing field {e}")
        except PermissionError as e:
            return self._error(str(e))
        except Exception as e:
            return self._error(f"{type(e).__name__}: {e}")

    @staticmethod
    def _error(msg: str) -> dict:
        return {"response": "error", "errorMessage": msg,
                "errorCode": -1, "sqlState": "00000",
                "severity": "ERROR"}

    def _conn(self, payload: dict) -> _Connection:
        cid = payload["connectionId"]
        with self._lock:
            conn = self._conns.get(cid)
            if conn is None:
                raise ValueError(f"unknown connection {cid}")
            if conn.identity != payload.get("__identity__"):
                raise PermissionError(
                    "connection belongs to another identity")
            conn.last_used = time.monotonic()
            return conn

    # ---- connection lifecycle ------------------------------------------
    def _req_openConnection(self, payload: dict) -> dict:
        # reap abandoned connections on every open: a crashed JDBC client
        # must not permanently consume a slot (DruidMeta's timeout reaper)
        self.expire_idle()
        cid = payload.get("connectionId") or str(uuid.uuid4())
        identity = payload.get("__identity__")
        with self._lock:
            existing = self._conns.get(cid)
            if existing is not None:
                if existing.identity != identity:
                    return self._error(
                        "connection belongs to another identity")
                return {"response": "openConnection", "connectionId": cid}
            if len(self._conns) >= self.max_connections:
                return self._error("too many connections")
            self._conns[cid] = _Connection(cid, identity)
        return {"response": "openConnection", "connectionId": cid}

    def _req_closeConnection(self, payload: dict) -> dict:
        try:
            self._conn(payload)      # identity must match to close
        except ValueError:
            return {"response": "closeConnection"}   # already gone: idempotent
        with self._lock:
            self._conns.pop(payload["connectionId"], None)
        return {"response": "closeConnection"}

    def _req_connectionSync(self, payload: dict) -> dict:
        self._conn(payload)
        return {"response": "connectionSync", "connProps": {
            "connProps": "connPropsImpl", "autoCommit": True,
            "readOnly": True, "dirty": False}}

    def _req_databaseProperty(self, payload: dict) -> dict:
        return {"response": "databaseProperty", "map": {
            "GET_S_Q_L_KEYWORDS": "", "GET_DRIVER_NAME": "druid-tpu",
            "GET_DRIVER_VERSION": "0.1",
            "GET_DATABASE_PRODUCT_NAME": "druid-tpu",
            "GET_DATABASE_PRODUCT_VERSION": "0.1"}}

    # ---- statements -----------------------------------------------------
    def _req_createStatement(self, payload: dict) -> dict:
        conn = self._conn(payload)
        with self._lock:
            sid = conn.next_statement
            conn.next_statement += 1
            conn.statements[sid] = _Statement(sid)
        return {"response": "createStatement",
                "connectionId": conn.id, "statementId": sid}

    def _req_closeStatement(self, payload: dict) -> dict:
        conn = self._conn(payload)
        with self._lock:
            conn.statements.pop(payload["statementId"], None)
        return {"response": "closeStatement"}

    def _req_prepare(self, payload: dict) -> dict:
        conn = self._conn(payload)
        sql = payload["sql"]
        with self._lock:
            sid = conn.next_statement
            conn.next_statement += 1
            st = conn.statements[sid] = _Statement(sid)
            st.sql = sql
        return {"response": "prepare", "statement": {
            "connectionId": conn.id, "id": sid,
            "signature": {"columns": [], "sql": sql, "parameters": [],
                          "cursorFactory": {"style": "LIST"},
                          "statementType": "SELECT"}}}

    def _execute_sql(self, conn: _Connection, sid: int, sql: str,
                     parameters: Sequence = (),
                     max_rows: int = -1, authorize=None) -> dict:
        if authorize is not None and not authorize(sql, parameters):
            raise PermissionError("unauthorized")
        cols, rows = self.sql.execute(sql, parameters)
        if max_rows is not None and max_rows >= 0:
            rows = rows[:max_rows]
        # statement registry is mutated under the server lock everywhere
        # else; concurrent requests on one connection race the dict insert
        with self._lock:
            st = conn.statements.setdefault(sid, _Statement(sid))
            st.columns, st.rows = list(cols), [list(r) for r in rows]
        first = st.rows[: self.max_rows_per_frame]
        done = len(first) == len(st.rows)
        return {
            "response": "resultSet", "connectionId": conn.id,
            "statementId": sid, "ownStatement": True,
            "signature": _signature(st.columns, st.rows),
            "firstFrame": {"offset": 0, "done": done, "rows": first},
            "updateCount": -1,
        }

    def _req_prepareAndExecute(self, payload: dict, authorize=None) -> dict:
        conn = self._conn(payload)
        rs = self._execute_sql(conn, payload["statementId"],
                               payload["sql"], (),
                               payload.get("maxRowCount", -1), authorize)
        return {"response": "executeResults", "missingStatement": False,
                "connectionId": conn.id,
                "statementId": payload["statementId"], "results": [rs]}

    def _req_execute(self, payload: dict, authorize=None) -> dict:
        handle = payload["statementHandle"]
        conn = self._conn({**payload,
                           "connectionId": handle["connectionId"]})
        st = conn.statements.get(handle["id"])
        if st is None or st.sql is None:
            return self._error("statement not prepared")
        params = [p.get("value") for p in
                  payload.get("parameterValues", [])]
        rs = self._execute_sql(conn, st.id, st.sql, params,
                               payload.get("maxRowCount", -1), authorize)
        return {"response": "executeResults", "missingStatement": False,
                "connectionId": conn.id, "statementId": st.id,
                "results": [rs]}

    def _req_fetch(self, payload: dict) -> dict:
        conn = self._conn(payload)
        st = conn.statements.get(payload["statementId"])
        if st is None:
            return self._error("unknown statement")
        offset = int(payload.get("offset", 0))
        n = int(payload.get("fetchMaxRowCount",
                            self.max_rows_per_frame))
        if n < 0:
            n = self.max_rows_per_frame
        rows = st.rows[offset:offset + n]
        done = offset + len(rows) >= len(st.rows)
        return {"response": "fetch", "connectionId": conn.id,
                "statementId": st.id,
                "frame": {"offset": offset, "done": done, "rows": rows}}

    # ---- maintenance ----------------------------------------------------
    def expire_idle(self, ttl_seconds: float = 300.0) -> int:
        """Drop connections idle past the ttl (DruidMeta's connection
        timeout reaper)."""
        now = time.monotonic()
        with self._lock:
            dead = [cid for cid, c in self._conns.items()
                    if now - c.last_used > ttl_seconds]
            for cid in dead:
                del self._conns[cid]
        return len(dead)
