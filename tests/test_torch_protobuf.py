"""The port's protobuf input parser (druid_tpu_torch/ext/protobuf_parser.py)
against the reference package's, on the CPU: tests/test_extensions.py's
protobuf cases (the roundtrip through the registered "protobuf" type, and
nested messages flattened into dotted keys), the unknown parser type, and
binary records through a parser into the port's IncrementalIndex, whose
snapshot equals the reference's."""
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.ext as r_ext
import druid_tpu.ingest as r_ingest
import druid_tpu.ingest.input as r_input
import druid_tpu.query.aggregators as r_aggs
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.ext as p_ext
import druid_tpu_torch.ingest as p_ingest
import druid_tpu_torch.ingest.input as p_input
import druid_tpu_torch.query.aggregators as p_aggs
from druid_tpu_torch.utils.intervals import Interval as PInterval
from tests.test_torch_ingest import same_segment

torch.set_num_threads(1)


def _event_descriptor_set():
    """A FileDescriptorSet built in process (what `protoc
    --descriptor_set_out` emits for a proto3 Event message and a wrapper)."""
    from google.protobuf import descriptor_pb2 as dp
    f = dp.FileDescriptorProto()
    f.name, f.package, f.syntax = "event.proto", "t", "proto3"
    m = f.message_type.add()
    m.name = "Event"
    for i, (name, ftype) in enumerate([
            ("ts", dp.FieldDescriptorProto.TYPE_STRING),
            ("page", dp.FieldDescriptorProto.TYPE_STRING),
            ("clicks", dp.FieldDescriptorProto.TYPE_INT64)], start=1):
        fld = m.field.add()
        fld.name, fld.number, fld.type = name, i, ftype
        fld.label = dp.FieldDescriptorProto.LABEL_OPTIONAL
    nested = f.message_type.add()
    nested.name = "Wrapped"
    inner = nested.field.add()
    inner.name, inner.number = "event", 1
    inner.type = dp.FieldDescriptorProto.TYPE_MESSAGE
    inner.type_name = ".t.Event"
    inner.label = dp.FieldDescriptorProto.LABEL_OPTIONAL
    return dp.FileDescriptorSet(file=[f]).SerializeToString()


def _events(parser, n=5):
    msgs = []
    for i in range(n):
        m = parser._msg_cls()
        m.ts = f"2026-07-{i % 28 + 1:02d}T00:00:00Z"
        m.page = f"p{i % 2}"
        m.clicks = i * 10
        msgs.append(m.SerializeToString())
    return msgs


def test_protobuf_parser_roundtrip():
    desc = _event_descriptor_set()
    parser = p_ext.ProtobufInputRowParser(desc, "t.Event",
                                          p_input.TimestampSpec("ts", "iso"))
    ref = r_ext.ProtobufInputRowParser(desc, "t.Event",
                                       r_input.TimestampSpec("ts", "iso"))
    msgs = _events(parser)
    batch = parser.parse_batch(msgs)
    assert len(batch) == 5
    assert batch.columns["page"][:2] == ["p0", "p1"]
    # proto3 JSON maps int64 to a string; the ingest side coerces numerics
    assert [int(v) for v in batch.columns["clicks"]] == [0, 10, 20, 30, 40]
    want = ref.parse_batch(msgs)
    assert batch.timestamps == want.timestamps
    assert batch.columns == want.columns
    assert parser.to_json() == ref.to_json()
    rt = p_input.InputRowParser.from_json(parser.to_json())
    assert isinstance(rt, p_ext.ProtobufInputRowParser)
    assert rt.parse_batch(msgs).columns["page"] == batch.columns["page"]


def test_protobuf_nested_flattening():
    desc = _event_descriptor_set()
    results = []
    for ext, inp in ((p_ext, p_input), (r_ext, r_input)):
        parser = ext.ProtobufInputRowParser(
            desc, "t.Wrapped", inp.TimestampSpec("event.ts", "iso"))
        w = parser._msg_cls()
        w.event.ts = "2026-07-01T00:00:00Z"
        w.event.page = "home"
        w.event.clicks = 7
        b = parser.parse_batch([w.SerializeToString()])
        results.append((b.timestamps, b.columns))
    (ts, cols), want = results
    assert cols["event.page"] == ["home"]
    assert int(cols["event.clicks"][0]) == 7
    assert (ts, cols) == want


def test_unknown_parser_type_raises():
    with pytest.raises(ValueError, match="unknown parser type"):
        p_input.InputRowParser.from_json({"type": "thrift", "parseSpec": {}})


def test_protobuf_records_into_the_index():
    """Binary records parsed by the registered type and rolled up: the
    port's snapshot equals the reference's column for column."""
    desc = _event_descriptor_set()
    segs = []
    for ext, inp, ing, A, Iv in (
            (p_ext, p_input, p_ingest, p_aggs, PInterval),
            (r_ext, r_input, r_ingest, r_aggs, RInterval)):
        spec = ext.ProtobufInputRowParser(
            desc, "t.Event", inp.TimestampSpec("ts", "iso"),
            inp.DimensionsSpec(("page",))).to_json()
        parser = inp.InputRowParser.from_json(spec)
        idx = ing.IncrementalIndex(
            "pb", Iv.of("2026-07-01", "2026-08-01"),
            [A.CountAggregator("rows"), A.LongSumAggregator("c", "clicks")],
            dimensions=["page"], query_granularity="day")
        idx.add_batch(parser.parse_batch(_events(parser, 60)))
        segs.append(idx.to_segment())
    port, ref = segs
    same_segment(ref, port)
    assert int(port.metrics["rows"].values.sum()) == 60
