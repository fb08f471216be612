"""URI-backed namespace lookups (reference: extensions-core/
lookups-cached-global — UriExtractionNamespace + its namespaceParseSpec
family: the cluster-managed lookup whose key→value map is periodically
re-read from a file/object-store URI instead of being inlined in the
spec).

The port's copy of the reference package's `ext/namespace_lookup.py`: host
code over the port's modules.

Registers the "uri" extractionNamespace loader with the cluster lookup
sync. Spec shape mirrors the reference:

    {"type": "uri", "uri": "file:///path/map.json",
     "namespaceParseSpec": {"format": "json"},          # {"k": "v", ...}
     "pollPeriod": 60}

Formats: "json" (flat object), "customJson" (list of objects with
keyFieldName/valueFieldName), "csv"/"tsv" (keyColumn/valueColumn over a
header row). Gzip transparently by .gz suffix.
"""
from __future__ import annotations

import csv
import gzip
import io
import json
from typing import Dict
from urllib.parse import urlparse

from druid_tpu_torch.cluster.lookups import register_namespace_loader


def _read_uri(uri: str) -> bytes:
    parsed = urlparse(uri)
    if parsed.scheme in ("", "file"):
        path = parsed.path if parsed.scheme else uri
        with open(path, "rb") as f:
            data = f.read()
        if path.endswith(".gz"):
            data = gzip.decompress(data)
        return data
    raise ValueError(f"unsupported namespace URI scheme {parsed.scheme!r} "
                     "(deep-storage schemes plug in via their own loader)")


def load_uri_namespace(ns: dict) -> Dict[str, str]:
    data = _read_uri(ns["uri"]).decode("utf-8")
    ps = ns.get("namespaceParseSpec", {"format": "json"})
    fmt = ps.get("format", "json")
    if fmt == "json":
        obj = json.loads(data)
        if not isinstance(obj, dict):
            raise ValueError("json namespace must be a flat object")
        return {str(k): str(v) for k, v in obj.items()}
    if fmt == "customJson":
        kf, vf = ps["keyFieldName"], ps["valueFieldName"]
        recs = json.loads(data)
        if not isinstance(recs, list):
            # a flat object would string-iterate into a silent {} — that
            # must be a load FAILURE (keeping the last good mapping)
            raise ValueError("customJson namespace must be a list of objects")
        out: Dict[str, str] = {}
        for rec in recs:
            if isinstance(rec, dict) and kf in rec and vf in rec:
                out[str(rec[kf])] = str(rec[vf])
        return out
    if fmt in ("csv", "tsv"):
        delim = "," if fmt == "csv" else "\t"
        rows = list(csv.reader(io.StringIO(data), delimiter=delim))
        if not rows:
            return {}
        header = rows[0]
        kc = ps.get("keyColumn", header[0])
        vc = ps.get("valueColumn", header[-1])
        ki, vi = header.index(kc), header.index(vc)
        return {r[ki]: r[vi] for r in rows[1:] if len(r) > max(ki, vi)}
    raise ValueError(f"unknown namespaceParseSpec format {fmt!r}")


register_namespace_loader("uri", load_uri_namespace)
