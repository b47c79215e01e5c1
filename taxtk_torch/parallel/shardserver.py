"""Copy of taxtk/parallel/shardserver.py: the port keeps its own copy and imports nothing of taxtk.

Cross-host refpack shard fetch service.

The reference runs one whole refpack per process and scales out by manual
file splitting (README.md FAQ#9-10).  taxtk shards the refpack by seqid
hash (see taxtk.parallel.refpack); within one host the shards are local
directories, and across hosts each shard is owned by one process.  This
module provides the transport for the cross-host case: a tiny
length-prefixed binary protocol over TCP through which a host serves
segment fetches from its local shard, and a client-side store
(`RemoteShardStore`) that speaks it while implementing the engine's store
protocol (`sequence_length` / `get_sequence` / `fetch_encode_batch`).

Only encoded candidate *segments* travel — never the database — so the
wire cost per RPA candidate is tens to hundreds of bytes.  Batched
fetches ship as ONE request per shard per alignment round (the same
grouping ShardedRefpackStore does locally), so the per-round added
latency is one network round-trip, overlapped across shards.

The protocol is deliberately dumb (no pickle, no auth — run it inside the
cluster like the reference runs NFS):

    request  := u8 op | body
    op=1 LEN    body := u16 n | seqid[n]
                reply:  i64 length (-1 = unknown id)
    op=2 GET    body := u16 n | seqid[n] | i64 start | i64 stop | u8 revcomp
                reply:  i64 m | bytes[m]   (m = -1 = error)
    op=3 BATCH  body := u8 protein | u32 k | k x GET-body
                reply:  u32 k | k x (i64 m | codes[m])  (uint8 code arrays)
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

OP_LEN = 1
OP_GET = 2
OP_BATCH = 3


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("shard server connection closed")
        buf.extend(chunk)
    return bytes(buf)


def _read_spec(sock) -> Tuple[str, int, int, bool]:
    (n,) = struct.unpack("<H", _recv_exact(sock, 2))
    seqid = _recv_exact(sock, n).decode()
    start, stop = struct.unpack("<qq", _recv_exact(sock, 16))
    (rc,) = struct.unpack("<B", _recv_exact(sock, 1))
    return seqid, start, stop, bool(rc)


def _pack_spec(seqid: str, start: int, stop: int, revcomp: bool) -> bytes:
    sid = seqid.encode()
    return (
        struct.pack("<H", len(sid))
        + sid
        + struct.pack("<qq", start, stop)
        + struct.pack("<B", 1 if revcomp else 0)
    )


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):  # one connection, many requests
        store = self.server.store  # type: ignore[attr-defined]
        sock = self.request
        try:
            while True:
                op = sock.recv(1)
                if not op:
                    return
                op = op[0]
                if op == OP_LEN:
                    (n,) = struct.unpack("<H", _recv_exact(sock, 2))
                    seqid = _recv_exact(sock, n).decode()
                    try:
                        ln = int(store.sequence_length(seqid))
                    except Exception:
                        ln = -1
                    sock.sendall(struct.pack("<q", ln))
                elif op == OP_GET:
                    seqid, start, stop, _rc = _read_spec(sock)
                    try:
                        data = store.get_sequence(seqid, start, stop)
                        sock.sendall(struct.pack("<q", len(data)) + data)
                    except Exception:
                        sock.sendall(struct.pack("<q", -1))
                elif op == OP_BATCH:
                    (protein,) = struct.unpack("<B", _recv_exact(sock, 1))
                    (k,) = struct.unpack("<I", _recv_exact(sock, 4))
                    specs = [_read_spec(sock) for _ in range(k)]
                    from .refpack import _encode_spec

                    if hasattr(store, "fetch_encode_batch"):
                        arrays = store.fetch_encode_batch(
                            specs, protein=bool(protein)
                        )
                    else:
                        arrays = [
                            _encode_spec(store, s, bool(protein)) for s in specs
                        ]
                    out = [struct.pack("<I", k)]
                    for arr in arrays:
                        b = np.asarray(arr, np.uint8).tobytes()
                        out.append(struct.pack("<q", len(b)))
                        out.append(b)
                    sock.sendall(b"".join(out))
                else:
                    return  # unknown op: drop connection
        except ConnectionError:
            return


class ShardServer(socketserver.ThreadingTCPServer):
    """Serves one local shard store over TCP.  Use as a context manager or
    call serve_background() to run in a daemon thread."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, store, host: str = "0.0.0.0", port: int = 0):
        super().__init__((host, port), _Handler)
        self.store = store

    @property
    def port(self) -> int:
        return self.server_address[1]

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


class RemoteShardStore:
    """Engine-protocol store backed by a remote ShardServer.

    One persistent connection, thread-safe via a lock (the engine issues
    one batched fetch per alignment round, so contention is nil)."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self._addr = (host, port)
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    def _conn(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=self._timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def close(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def sequence_length(self, seqid: str) -> int:
        sid = seqid.encode()
        with self._lock:
            s = self._conn()
            s.sendall(bytes([OP_LEN]) + struct.pack("<H", len(sid)) + sid)
            (ln,) = struct.unpack("<q", _recv_exact(s, 8))
        if ln < 0:
            raise KeyError(seqid)
        return ln

    def get_sequence(self, seqid: str, start: int, stop: int) -> bytes:
        with self._lock:
            s = self._conn()
            s.sendall(bytes([OP_GET]) + _pack_spec(seqid, start, stop, False))
            (m,) = struct.unpack("<q", _recv_exact(s, 8))
            if m < 0:
                raise KeyError(seqid)
            return _recv_exact(s, m)

    def fetch_encode_batch(self, specs, protein: bool = False) -> List[np.ndarray]:
        body = [
            bytes([OP_BATCH]),
            struct.pack("<B", 1 if protein else 0),
            struct.pack("<I", len(specs)),
        ]
        for seqid, start, stop, revcomp in specs:
            body.append(_pack_spec(seqid, start, stop, revcomp))
        with self._lock:
            s = self._conn()
            s.sendall(b"".join(body))
            (k,) = struct.unpack("<I", _recv_exact(s, 4))
            out: List[np.ndarray] = []
            for _ in range(k):
                (m,) = struct.unpack("<q", _recv_exact(s, 8))
                if m < 0:
                    raise RuntimeError("remote fetch failed")
                out.append(np.frombuffer(_recv_exact(s, m), np.uint8).copy())
        return out


def connect_sharded(endpoints: Sequence[Tuple[str, int]]):
    """Build a ShardedRefpackStore whose shard i is served remotely at
    endpoints[i] (ordering must match the split-refpack shard order)."""
    from .refpack import ShardedRefpackStore

    return ShardedRefpackStore([RemoteShardStore(h, p) for h, p in endpoints])
