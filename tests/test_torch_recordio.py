"""The port's copy of the flight recorder's record codec
(``hlsjs_p2p_wrapper_tpu_torch/engine/recordio.py``) against the
reference's ``engine/recordio.py``: the same records through both
writers give the same bytes, and each side reads the other's files,
whole, torn at every byte and with a flipped bit, to the same records
and the same counts."""

import json

import pytest

from hlsjs_p2p_wrapper_tpu.engine import recordio as ref
from hlsjs_p2p_wrapper_tpu_torch.engine import recordio as port

META = {"kind": "meta", "run_id": "r1", "host": "h"}


def _records():
    """Hot fixed-codec records (counter bumps, window marks, slo
    windows), chunked-JSON fall-throughs (a context-bearing bump, spans,
    rows, leases), int and float clocks, and a long string that needs
    several frames."""
    out = []
    for seq in range(6):
        out.append({"t": 1.0 + seq, "host": "h", "kind": "counter",
                    "name": "dispatch_faults",
                    "labels": "action=retry,reason=transient",
                    "n": seq + 1, "seq": seq})
    out += [
        {"t": 8, "host": "h", "kind": "counter", "name": "twin.stall_ms",
         "labels": "peer=p01", "n": -2.5, "seq": 6},
        {"t": 8.5, "host": "h", "kind": "counter",
         "name": "aot_cache_events", "labels": "layer=row,result=miss",
         "n": 1, "seq": 7, "ctx": {"group": 0, "chunk": 1, "attempt": 0}},
        {"t": 9.0, "host": "h", "kind": "mark", "name": "twin_window",
         "window": 0, "window_ms": 125.0, "seq": 8},
        {"t": 9.5, "host": "h", "kind": "mark", "name": "slo_window",
         "seq": 9, "slo": "rebuffer", "metric": "twin.stall_ms",
         "quantile": "p95", "value": 12.5, "good": True,
         "burn_fast": 1.25, "burn_slow": 0.5, "budget_remaining": 0.875,
         "firing": False, "window": 2, "t_s": 8.0},
        {"t": 10.0, "host": "h", "kind": "span", "name": "dispatch",
         "t_start": 9.75, "dur_s": 0.25, "group": 0, "chunk": 1,
         "seq": 10},
        {"t": 10.5, "host": "h", "kind": "row", "key": "ab" * 32,
         "group": 0, "index": 3, "cached": False, "journaled": True,
         "seq": 11, "ctx": {"unit": 2}},
        {"t": 11, "host": "h", "kind": "lease", "action": "steal",
         "unit": 4, "gen": 1, "prev_host": "host01", "seq": 12},
        {"t": 12.0, "host": "h", "kind": "mark", "name": "note",
         "text": "x" * 700, "seq": 13},
    ]
    return out


def _shard(module, records):
    enc = module.ShardEncoder()
    head = (json.dumps(META) + "\n").encode("utf-8")
    return head + b"".join(enc.encode(r) for r in records)


def _decode(module, data):
    dec = module.RecordDecoder()
    out = dec.feed(data)
    out.extend(dec.finish())
    return out, dec.stats.as_dict()


def test_both_writers_give_the_same_bytes():
    records = _records()
    data = _shard(ref, records)
    assert _shard(port, records) == data
    # the hot path's no-dict encode, bump by bump
    enc_r, enc_p = ref.ShardEncoder(), port.ShardEncoder()
    for r in records[:7]:
        args = (r["t"], r["host"], r["name"], r["labels"], r["n"],
                r["seq"])
        assert enc_p.encode_bump(*args) == enc_r.encode_bump(*args)
    out, stats = _decode(port, data)
    assert out == [META] + records
    assert stats == {"bad_records": 0, "torn": 0,
                     "records": len(records) + 1}


@pytest.mark.parametrize("writer,reader", [(ref, port), (port, ref)])
def test_each_side_reads_the_others_files(tmp_path, writer, reader):
    """The whole file, every byte prefix (a torn tail), a flipped
    payload bit and a flipped frame head: the same records and the
    same counts on both sides."""
    data = _shard(writer, _records())
    path = tmp_path / "shard.jsonl"
    path.write_bytes(data)
    got, got_stats = reader.read_records(str(path))
    want, want_stats = writer.read_records(str(path))
    assert got == want and got_stats.as_dict() == want_stats.as_dict()
    for cut in range(len(data) + 1):
        assert _decode(reader, data[:cut]) == _decode(writer, data[:cut])
    torn_path = tmp_path / "torn.jsonl"
    torn_path.write_bytes(data[:len(data) - port.FRAME_BYTES // 2])
    got, got_stats = reader.read_records(str(torn_path))
    want, want_stats = writer.read_records(str(torn_path))
    assert got == want and got_stats.torn == want_stats.torn >= 1
    head = len(json.dumps(META)) + 1
    for offset, mask in ((5 * port.FRAME_BYTES + 10, 0x40),
                         (3 * port.FRAME_BYTES, 0x01)):
        flipped = bytearray(data)
        flipped[head + offset] ^= mask
        got, got_stats = _decode(reader, bytes(flipped))
        want, want_stats = _decode(writer, bytes(flipped))
        assert got == want and got_stats == want_stats
        assert got_stats["bad_records"] >= 1


def test_columns_agree(tmp_path):
    """The columnar reader of a bump-only shard: the same columns from
    either side's file."""
    bumps = [r for r in _records() if r["kind"] == "counter"
             and "ctx" not in r]
    data = _shard(port, bumps)
    assert data == _shard(ref, bumps)
    path = tmp_path / "bumps.jsonl"
    path.write_bytes(data)
    got, want = port.frame_columns(str(path)), ref.frame_columns(str(path))
    assert (got is None) == (want is None)
    if got is not None:
        assert got.strings == want.strings and got.meta == want.meta
        for name in ("ctr_pos", "ctr_t", "ctr_name", "ctr_labels",
                     "ctr_n"):
            assert getattr(got, name).tobytes() == \
                getattr(want, name).tobytes()
