"""Length-prefixed socket framing for the multi-process serving tier: the
port's copy of ``paddle_tpu/serving/rpc.py``, byte-compatible with it both
ways (a frame either package encodes decodes in the other).

The reference's process boundary is gRPC (``grpc_client.cc:66`` /
``grpc_server.cc`` behind ``listen_and_serv``); ours is deliberately
stdlib-only: a frame is an 8-byte big-endian payload length, a 4-byte
header length, a JSON header, and an ``np.savez`` blob carrying the
arrays. That is enough to move feeds/fetches between the router and its
workers with zero new dependencies, and — the point of this layer — it
gives the chaos harness two *wire-level* fault sites:

  * ``rpc.send``  — tripped before a frame is written. ``error`` raises
    :class:`~paddle_tpu_torch.reliability.faults.InjectedFault` in the sender,
    ``corrupt`` damages the payload bytes so the PEER fails the decode
    (the torn-write drill), ``hang`` stalls the write.
  * ``rpc.recv``  — tripped before a frame is read; ``corrupt`` damages
    the received payload before parsing (the torn-read drill).

Every decode failure surfaces as a typed :class:`RpcError` (clean EOF at
a frame boundary is :class:`ConnectionClosed`) so recovery layers can
tell a broken peer from a broken program.

Deadline propagation convention: request headers carry
``deadline_s`` — the budget REMAINING at send time, in seconds (never an
absolute timestamp: the two processes do not share a clock). Each hop
re-derives a local :class:`~paddle_tpu_torch.reliability.policy.Deadline` from
it, so queue time spent anywhere on the path keeps counting and a worker
can refuse already-expired work without doing it.

Trace propagation convention (``paddle_tpu_torch.obs.trace``): request headers
may carry ``trace`` — ``{"tid": <64-bit-hex trace id>, "sid": <64-bit-hex
span id>}``. Unlike the deadline, the TRACE ID propagates verbatim for
the whole request (it names the trace); the SPAN ID is re-injected by
each hop with its own current span, so the receiver's spans parent under
the sender's. Peers that don't trace ignore the key (unknown header keys
are always ignored — that is what makes both conventions zero wire-format
changes) and, when forwarding, keep it intact by copying the header.
"""

import io
import json
import socket
import struct

import numpy as np

from ..reliability import faults

__all__ = ["RpcError", "ConnectionClosed", "send_msg", "recv_msg",
           "connect", "MAX_FRAME_BYTES"]

_LEN = struct.Struct("!Q")
_HDR = struct.Struct("!I")

#: refuse frames beyond this size instead of letting a corrupt length
#: prefix turn into an unbounded allocation
MAX_FRAME_BYTES = 1 << 30


class RpcError(RuntimeError):
    """A frame failed to move or decode (broken pipe, torn frame,
    corrupt payload). Retryable at the dispatch layer — the REQUEST is
    not known to be bad, the hop is."""


class ConnectionClosed(RpcError):
    """The peer closed cleanly at a frame boundary (EOF before the first
    length byte) — the normal end of a persistent connection."""


def encode_msg(header, arrays=None):
    """One wire frame's payload: 4-byte header length + JSON header +
    ``np.savez`` blob (empty when there are no arrays)."""
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    if arrays:
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        body = buf.getvalue()
    else:
        body = b""
    return _HDR.pack(len(hdr)) + hdr + body


def decode_msg(payload):
    """Inverse of :func:`encode_msg`; raises :class:`RpcError` on any
    malformed byte instead of leaking codec exceptions upward."""
    try:
        if len(payload) < _HDR.size:
            raise ValueError("frame shorter than its header-length field")
        (hlen,) = _HDR.unpack_from(payload)
        if hlen > len(payload) - _HDR.size:
            raise ValueError("header length %d overruns the frame" % hlen)
        header = json.loads(
            payload[_HDR.size:_HDR.size + hlen].decode("utf-8"))
        body = payload[_HDR.size + hlen:]
        arrays = {}
        if body:
            with np.load(io.BytesIO(body), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        return header, arrays
    except RpcError:
        raise
    except Exception as e:
        raise RpcError("bad frame: %s: %s" % (type(e).__name__, e)) from e


def _read_exact(sock, n, at_boundary=False):
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except socket.timeout as e:
            raise RpcError("recv timed out (%d/%d bytes)" % (got, n)) from e
        except OSError as e:
            raise RpcError("recv failed: %s" % e) from e
        if not chunk:
            if at_boundary and got == 0:
                raise ConnectionClosed("peer closed the connection")
            raise RpcError("peer closed mid-frame (%d/%d bytes)" % (got, n))
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_msg(sock, header, arrays=None):
    """Write one frame. Fault site ``rpc.send``: ``error`` raises in the
    sender, ``corrupt`` ships a damaged payload the peer will reject."""
    mode = faults.trip("rpc.send")
    payload = encode_msg(header, arrays)
    if mode == "corrupt":
        payload = faults.corrupt_bytes(payload)
    try:
        sock.sendall(_LEN.pack(len(payload)) + payload)
    except socket.timeout as e:
        raise RpcError("send timed out") from e
    except OSError as e:
        raise RpcError("send failed: %s" % e) from e


def recv_msg(sock):
    """Read one frame -> ``(header, arrays)``. Fault site ``rpc.recv``:
    ``corrupt`` damages the received payload before the parse."""
    mode = faults.trip("rpc.recv")
    raw = _read_exact(sock, _LEN.size, at_boundary=True)
    (n,) = _LEN.unpack(raw)
    if n > MAX_FRAME_BYTES:
        raise RpcError("frame length %d exceeds MAX_FRAME_BYTES (corrupt "
                       "length prefix?)" % n)
    payload = _read_exact(sock, n)
    if mode == "corrupt":
        payload = faults.corrupt_bytes(payload)
    return decode_msg(payload)


def connect(address, timeout=None):
    """TCP connect with ``TCP_NODELAY`` (frames are latency-sensitive and
    already coalesced — Nagle only adds tail)."""
    host, port = address
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    return sock
