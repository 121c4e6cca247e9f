"""Cluster transport: length-prefixed JSON frames + channels (Fig. 4).

Port of ``repro/launch/transport.py``.  The A1 fleet talks through an SLB
in front of coordinator processes; this module is the wire layer under
:mod:`repro_torch.launch.cluster`:

  * **frames**: every message is one length-prefixed JSON frame
    (4-byte big-endian length + UTF-8 JSON body), byte for byte the JAX
    package's frame for the same message.  JSON keeps the protocol
    debuggable (``nc``-able) and forces the routing layer to stay
    data-only; a numpy-safe encoder folds result arrays to plain lists at
    the boundary.  A ``torch.Tensor`` is refused (``TypeError``): folding
    one would hide a device-to-host copy inside the encoder, so the
    coordinator hands the wire host values only.
  * **write-op codec**: the typed mutation-op records
    (:mod:`repro_torch.core.writes`) serialize to tagged dicts so clients
    can submit writes over the wire.
  * :class:`MemoryChannel`: the in-process channel used by inproc
    coordinator fleets and the chaos checks: every request/response pair
    still round-trips through *real encoded frames*, and each frame
    consults the ``transport.drop`` fault site, so drop/duplicate
    schedules are deterministic and the idempotency contract (resend the
    same ``rid``, get the same answer) is testable without sockets.
  * :class:`WorkerClient` / :func:`serve_worker`: a blocking JSON-frame
    TCP client and a threaded socket server: the frontend's link to
    spawned coordinator worker processes.
  * :func:`serve_frontend`: the asyncio front door: clients connect over
    TCP, send frames, get frames back (the SLB's public face).

Frame-level loss is the *client's* problem by design: a dropped request or
response returns ``None`` from :meth:`MemoryChannel.request` and the caller
retransmits with the same ``rid``; the coordinator's rid cache makes the
retry idempotent even when the first attempt executed (response lost after
the work was done, the classic at-least-once duplicate).
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct
import threading
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import writes as writes_mod

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024


class _NumpyEncoder(json.JSONEncoder):
    """Results carry numpy scalars/arrays; the wire carries plain JSON.
    A tensor is the caller's bug: its values would need a device-to-host
    copy, which the encoder must not make behind the caller's back."""

    def default(self, o):
        if isinstance(o, torch.Tensor):
            raise TypeError(f"a torch.Tensor ({o.device}) reached the "
                            "frame encoder; hand the wire host values")
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.bool_):
            return bool(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return super().default(o)


def encode_frame(obj: dict) -> bytes:
    body = json.dumps(obj, cls=_NumpyEncoder,
                      separators=(",", ":")).encode()
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame too large ({len(body)} bytes)")
    return _LEN.pack(len(body)) + body


def decode_frame(frame: bytes) -> dict:
    (n,) = _LEN.unpack_from(frame)
    return json.loads(frame[_LEN.size:_LEN.size + n].decode())


class FrameBuffer:
    """Incremental frame decoder for a byte stream (TCP reassembly)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[dict]:
        self._buf += data
        out = []
        while len(self._buf) >= _LEN.size:
            (n,) = _LEN.unpack_from(self._buf)
            if n > MAX_FRAME:
                raise ValueError(f"frame too large ({n} bytes)")
            if len(self._buf) < _LEN.size + n:
                break
            out.append(json.loads(bytes(
                self._buf[_LEN.size:_LEN.size + n]).decode()))
            del self._buf[:_LEN.size + n]
        return out


# ---------------------------------------------------------------------------
# write-op wire codec
# ---------------------------------------------------------------------------

_WRITE_OPS = {cls.__name__: cls for cls in writes_mod._OP_TYPES}


def encode_write_op(op) -> dict:
    if type(op).__name__ not in _WRITE_OPS:
        raise TypeError(f"not a write op: {type(op).__name__}")
    return {"op": type(op).__name__, **dataclasses.asdict(op)}


def decode_write_op(d: dict):
    d = dict(d)
    cls = _WRITE_OPS[d.pop("op")]
    return cls(**d)


# ---------------------------------------------------------------------------
# in-process channel (deterministic chaos)
# ---------------------------------------------------------------------------

class MemoryChannel:
    """Frame-encoded request/response against an in-process handler.

    Both directions are real frames: the request is encoded, the
    ``transport.drop`` site is consulted (``race`` = this frame is lost),
    the handler sees the *decoded* frame, and the response frame gets its
    own drop check.  A response-side drop is the nasty one — the handler
    already executed — which is exactly the duplicate-delivery case the
    coordinator rid cache must absorb.  ``owner`` carries the fault
    injector (the shared db in the cluster, so one schedule drives every
    channel deterministically)."""

    def __init__(self, handler: Callable[[dict], dict], owner=None):
        self._handler = handler
        self._owner = owner
        self.sent = 0
        self.dropped = 0

    def request(self, msg: dict) -> Optional[dict]:
        """One round trip; ``None`` = a frame was lost, caller retransmits."""
        frame = encode_frame(msg)
        self.sent += 1
        if faults_mod.check(self._owner, "transport.drop"):
            self.dropped += 1
            return None                       # request frame lost
        resp = self._handler(decode_frame(frame))
        frame = encode_frame(resp)
        self.sent += 1
        if faults_mod.check(self._owner, "transport.drop"):
            self.dropped += 1
            return None                       # response frame lost
        return decode_frame(frame)


# ---------------------------------------------------------------------------
# TCP worker link (process mode)
# ---------------------------------------------------------------------------

def _recv_frame(sock: socket.socket) -> Optional[dict]:
    hdr = b""
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large ({n} bytes)")
    body = b""
    while len(body) < n:
        chunk = sock.recv(min(65536, n - len(body)))
        if not chunk:
            return None
        body += chunk
    return json.loads(body.decode())


class WorkerClient:
    """JSON-frame request/response client to one worker socket.

    One in-flight request at a time per client (the frontend serializes
    per-worker traffic; cross-worker requests are concurrent because each
    worker has its own client/socket).

    A worker that *hangs* (accepts the frame, never answers) must not
    wedge the frontend: every recv is bounded by ``recv_timeout``.  A
    timeout desynchronizes the frame stream — the late response would
    misalign against the next request — so the socket is dropped and
    rebuilt with a bounded, jitter-backed reconnect.  The outcome is
    surfaced as ``suspect=True`` (hung, lease should stop renewing —
    membership's problem) rather than ``dead`` (connection refused/reset:
    the process is gone).  A clean round trip clears suspicion."""

    def __init__(self, host: str, port: int, timeout: float = 30.0, *,
                 recv_timeout: Optional[float] = None,
                 reconnect_attempts: int = 3,
                 backoff_s: float = 0.05, seed: int = 0):
        self.addr = (host, port)
        self.connect_timeout = timeout
        self.recv_timeout = timeout if recv_timeout is None else recv_timeout
        self.reconnect_attempts = int(reconnect_attempts)
        self.backoff_s = float(backoff_s)
        self.suspect = False
        self.timeouts = 0
        self.reconnects = 0
        import random
        self._rng = random.Random((seed << 17) ^ port)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            self.addr, timeout=self.connect_timeout)
        self._sock.settimeout(self.recv_timeout)

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _reconnect(self) -> bool:
        """Bounded reconnect with jittered exponential backoff: the fleet's
        clients must not stampede a worker that is coming back up."""
        import time as _time
        self._drop_sock()
        for attempt in range(self.reconnect_attempts):
            _time.sleep(self.backoff_s * (2 ** attempt)
                        * (0.5 + self._rng.random()))
            try:
                self._connect()
                self.reconnects += 1
                return True
            except OSError:
                continue
        return False

    def request(self, msg: dict) -> Optional[dict]:
        """One round trip; ``None`` means no answer — check ``suspect`` to
        tell a hung worker (route around, don't bury) from a dead one."""
        with self._lock:
            if self._sock is None and not self._reconnect():
                return None                   # worker gone
            try:
                self._sock.sendall(encode_frame(msg))
                resp = _recv_frame(self._sock)
                if resp is not None:
                    self.suspect = False      # clean round trip
                return resp
            except socket.timeout:
                # hung, not dead: the stream is now desynced — drop it,
                # rebuild lazily, and flag the worker suspect so the
                # frontend routes around it instead of blocking forever
                self.timeouts += 1
                self.suspect = True
                self._drop_sock()
                self._reconnect()
                return None
            except OSError:
                self._drop_sock()
                return None                   # worker gone

    def close(self) -> None:
        self._drop_sock()


def serve_worker(handler: Callable[[dict], dict], host: str = "127.0.0.1",
                 port: int = 0):
    """Threaded frame server for a coordinator worker process.

    Returns ``(bound_port, shutdown)``.  Each accepted connection gets a
    thread running a strict frame-in/frame-out loop; the handler is the
    coordinator's dispatch (which does its own locking)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(16)
    stop = threading.Event()

    def _conn_loop(conn: socket.socket) -> None:
        with conn:
            while not stop.is_set():
                try:
                    msg = _recv_frame(conn)
                except (OSError, ValueError):
                    return
                if msg is None:
                    return
                try:
                    resp = handler(msg)
                except Exception as e:          # never kill the link
                    resp = {"status": "ERROR", "reason": repr(e)}
                try:
                    conn.sendall(encode_frame(resp))
                except OSError:
                    return

    def _accept_loop() -> None:
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=_conn_loop, args=(conn,),
                             daemon=True).start()

    threading.Thread(target=_accept_loop, daemon=True).start()

    def shutdown() -> None:
        stop.set()
        try:
            srv.close()
        except OSError:
            pass

    return srv.getsockname()[1], shutdown


# ---------------------------------------------------------------------------
# asyncio front door (the SLB's public face)
# ---------------------------------------------------------------------------

async def serve_frontend(frontend, host: str = "127.0.0.1", port: int = 0):
    """Serve ``frontend.handle`` over asyncio TCP; returns the server.

    Clients send JSON frames (``{"op": ..., ...}``) and receive one frame
    per request.  The frontend's handler is synchronous (waves are
    CPU-bound device dispatches, not I/O), so it runs on the default
    executor to keep the event loop responsive to other connections."""
    import asyncio
    loop = asyncio.get_running_loop()

    async def _client(reader: "asyncio.StreamReader",
                      writer: "asyncio.StreamWriter") -> None:
        buf = FrameBuffer()
        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    break
                for msg in buf.feed(data):
                    resp = await loop.run_in_executor(
                        None, frontend.handle, msg)
                    writer.write(encode_frame(resp))
                    await writer.drain()
        finally:
            writer.close()

    return await asyncio.start_server(_client, host, port)
