"""PyTorch port, the fleet's wire layer (``repro_torch/launch/
transport.py``) against the JAX package's (``repro/launch/transport.py``,
imported live): frames byte for byte, the partial-feed reassembly, the
write-op codec, the ``transport.drop`` site of ``MemoryChannel``, the
worker client's recv timeout against the port's ``serve_worker``, the
asyncio front door, and the refusal of a ``torch.Tensor`` in a frame.

The seeded codec and recv-timeout cases of ``tests/torch_fleet_script.py``
are compared with the committed JAX fixture as the other fleet files do.
"""
import asyncio
import json

import numpy as np
import pytest
import torch

import torch_fleet_script as script
from repro.core import writes as jax_writes
from repro.launch import transport as jax_transport
from repro_torch.core import faults, writes
from repro_torch.launch import transport
from test_torch_cluster import assert_case_matches_jax, port_namespace
from test_torch_store_index_edges import one_torch_thread  # noqa: F401

WIRE_CASES = tuple(n for n in script.CLUSTER_CASES
                   if n.startswith(("frame_", "write_op_", "worker_client")))

MESSAGES = [
    {"op": "result", "n": np.int64(3), "ok": np.bool_(True),
     "rows": np.arange(3), "ms": np.float32(1.5)},
    {"op": "query", "doc": {"type": "actor", "id": 323,
                            "_in_edge": {"type": "film.actor"}},
     "tenant": "té", "budget_ms": None, "rid": "0" * 32, "epoch": 2,
     "primary": 1},
    {"status": "OK", "rows": np.array([[1, -1], [2, 3]], np.int32),
     "f": np.array([0.1, 1e-30, -2.5], np.float32),
     "d": np.float64(1 / 3), "nested": [np.uint8(7), (np.int16(-2),)],
     "_load": {"wave_ms": 0.123456789, "inflight": 0}},
    {"op": "replicate", "waves": [{"seq": 1, "ts": 7, "epoch": 1, "txns": [
        {"rid": "w1", "create_v": [[4, 1, 9, [0.5, 0.0], [2030, 0]]],
         "update_v": [], "delete_v": [], "create_e": [], "delete_e": []}]}],
     "pins": [3, 5]},
]


@pytest.mark.parametrize("name", WIRE_CASES)
def test_case_matches_jax(name):
    assert_case_matches_jax(name)


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_frames_byte_equal_to_jax(i):
    msg = MESSAGES[i]
    frame = transport.encode_frame(msg)
    assert frame == jax_transport.encode_frame(msg)
    assert transport.decode_frame(frame) == jax_transport.decode_frame(frame)
    buf = transport.FrameBuffer()
    got = []
    for b in frame + frame:                  # one byte at a time
        got += buf.feed(bytes([b]))
    assert got == [transport.decode_frame(frame)] * 2


def _ops(w):
    return [w.CreateVertex("film", 999, {"year": 2030, "gross": 0.5}),
            w.CreateVertex("actor", 7),
            w.UpdateVertex(12, "actor", {"dob": 1970}),
            w.DeleteVertex(5),
            w.CreateEdge(2, 3, "film.actor", check=False),
            w.DeleteEdge(2, 3, "film.actor")]


def test_write_op_codec_equal_to_jax():
    ours = [transport.encode_write_op(o) for o in _ops(writes)]
    theirs = [jax_transport.encode_write_op(o) for o in _ops(jax_writes)]
    assert ours == theirs
    assert [transport.encode_frame(e) for e in ours] == [
        jax_transport.encode_frame(e) for e in theirs]
    assert [transport.decode_write_op(e) for e in theirs] == _ops(writes)


@pytest.mark.parametrize("payload", [
    torch.arange(3), torch.tensor(1.5), [1, torch.zeros(2, 2)],
    {"rows": torch.ones(1, dtype=torch.int64)}])
def test_a_tensor_in_a_frame_raises(payload):
    """A tensor reaching the encoder is the caller's bug: converting it
    would hide a device-to-host copy."""
    with pytest.raises(TypeError, match="torch.Tensor"):
        transport.encode_frame({"status": "OK", "x": payload})


def test_oversized_frame_is_refused():
    head = transport._LEN.pack(transport.MAX_FRAME + 1)
    with pytest.raises(ValueError, match="frame too large"):
        transport.FrameBuffer().feed(head + b"{}")


def test_memory_channel_drops_each_direction():
    """``transport.drop`` at visit 0 loses the request (the handler never
    ran), at visit 2 the second round trip's response (the handler did
    run: the duplicate the rid cache absorbs)."""
    class Owner:
        faults = faults.FaultInjector(0).inject(
            "transport.drop", action="race", times=(0, 2))
    seen = []

    def handler(msg):
        seen.append(msg)
        return {"status": "OK", "echo": msg["i"]}

    ch = transport.MemoryChannel(handler, Owner)
    assert ch.request({"i": 0}) is None and seen == []
    assert ch.request({"i": 1}) is None and seen == [{"i": 1}]
    assert ch.request({"i": 2}) == {"status": "OK", "echo": 2}
    assert (ch.sent, ch.dropped) == (5, 2)
    assert [list(f) for f in Owner.faults.fired] == [
        ["transport.drop", 0, "race"], ["transport.drop", 2, "race"]]


def test_serve_worker_answers_handler_errors_without_dropping_the_link():
    def handler(msg):
        if msg.get("boom"):
            raise KeyError("boom")
        return {"status": "OK", "x": np.int32(msg["x"])}

    port, shutdown = transport.serve_worker(handler)
    try:
        c = transport.WorkerClient("127.0.0.1", port, recv_timeout=10.0)
        try:
            assert c.request({"x": 1}) == {"status": "OK", "x": 1}
            err = c.request({"boom": True})
            assert err["status"] == "ERROR" and "boom" in err["reason"]
            assert c.request({"x": 2}) == {"status": "OK", "x": 2}
            assert not c.suspect and c.timeouts == 0
        finally:
            c.close()
    finally:
        shutdown()


def test_serve_frontend_answers_frames_over_tcp():
    """The asyncio front door over a port fleet: a client writes two
    frames in pieces and reads one frame back per request."""
    m = port_namespace()
    fe = m.Frontend(script.busy_db(m), 2, caps=script.cl_caps(m),
                    read_batch=1)

    async def session():
        server = await transport.serve_frontend(fe)
        port = server.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           port)
            blob = (transport.encode_frame({"op": "query",
                                            "doc": script.q_chain(0)})
                    + transport.encode_frame({"op": "nope"}))
            for off in range(0, len(blob), 7):
                writer.write(blob[off:off + 7])
                await writer.drain()
            buf, got = transport.FrameBuffer(), []
            while len(got) < 2:
                got += buf.feed(await asyncio.wait_for(reader.read(65536),
                                                       30.0))
            writer.write(transport.encode_frame(
                {"op": "result", "qid": got[0]["qid"]}))
            await writer.drain()
            while len(got) < 3:
                got += buf.feed(await asyncio.wait_for(reader.read(65536),
                                                       30.0))
            writer.close()
            return got
        finally:
            server.close()
            await server.wait_closed()

    try:
        got = asyncio.run(session())
    finally:
        fe.close()
    assert got[0]["status"] == "OK" and got[0]["qid"].count(":") == 1
    assert got[1]["status"] == "ERROR"
    assert got[2]["result"]["status"] == "OK"
    assert json.loads(json.dumps(got)) == got
