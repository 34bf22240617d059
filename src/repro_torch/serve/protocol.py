"""Wire protocol for the selection serving front end (a copy of
``repro.serve.protocol``: the same frames and feedback encodings, byte for
byte).

One frame = a 4-byte big-endian unsigned length prefix + that many bytes of
UTF-8 JSON.  Both directions use the same framing; a frame larger than
``MAX_MESSAGE_BYTES`` is a protocol error (the peer is misbehaving or the
stream is corrupt — fail loudly, never try to resync).  The framing is
deliberately stdlib-only (``socket`` + ``struct`` + ``json``) so a client
needs nothing beyond Python to speak to the server; numpy is used only for
the optional packed feedback encodings.

Request objects carry ``{"op": <name>, ...}``; responses carry
``{"ok": true, ...}`` or ``{"ok": false, "error": <code>, "message": ...}``.
The op vocabulary, job lifecycle and failure codes are documented in
``docs/serving.md``.

Feedback encodings for ``tick`` requests, smallest first:

* ``"xb": <base64>`` — 1-bit packed success bits (``np.packbits`` order,
  8 clients/byte): the sync wire twin of the repo's packed trace format.
* ``"xl": <base64>`` — uint8 completion-lag codes, one byte per client;
  ``LAG_NEVER`` (255) encodes a client that never completes (the engine's
  ``DEAD_LAG``).
* ``"x": [..]`` — a plain JSON list: success bits (sync) or lag codes
  (async, ``-1`` = never).  Convenient, ~10x the bytes.
"""
from __future__ import annotations

import base64
import json
import socket
import struct
from typing import Optional

import numpy as np

from repro_torch.core.volatility import DEAD_LAG as _ENGINE_DEAD_LAG

__all__ = [
    "MAX_MESSAGE_BYTES",
    "LAG_NEVER",
    "DEAD_LAG",
    "ProtocolError",
    "ConnectionClosed",
    "send_message",
    "recv_message",
    "encode_bits",
    "decode_bits",
    "encode_lags",
    "decode_lags",
    "feedback_lags",
]

MAX_MESSAGE_BYTES = 64 << 20  # one frame; ~6e7 clients as packed bits
LAG_NEVER = 255  # uint8 wire code for "never completes"
DEAD_LAG = -1  # engine-side sentinel (== repro_torch.core.volatility.DEAD_LAG)
_HEADER = struct.Struct("!I")

assert DEAD_LAG == _ENGINE_DEAD_LAG, "wire and engine dead-lag sentinels drifted"


class ProtocolError(RuntimeError):
    """Malformed frame or payload — the stream cannot be trusted further."""


class ConnectionClosed(ProtocolError):
    """The peer closed the connection at a frame boundary (clean EOF)."""


def _recv_exact(sock: socket.socket, n: int, *, at_boundary: bool) -> bytes:
    """Read exactly ``n`` bytes; EOF at a frame boundary raises
    ``ConnectionClosed``, EOF mid-frame raises ``ProtocolError``."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if at_boundary and got == 0:
                raise ConnectionClosed("peer closed the connection")
            raise ProtocolError(f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_message(sock: socket.socket, obj: dict) -> None:
    """Serialize ``obj`` as one length-prefixed JSON frame."""
    body = json.dumps(obj, allow_nan=False, separators=(",", ":")).encode()
    if len(body) > MAX_MESSAGE_BYTES:
        raise ProtocolError(f"frame of {len(body)} bytes exceeds MAX_MESSAGE_BYTES")
    sock.sendall(_HEADER.pack(len(body)) + body)


def recv_message(sock: socket.socket, max_bytes: int = MAX_MESSAGE_BYTES) -> dict:
    """Read one frame; raises ``ConnectionClosed`` on clean EOF."""
    (length,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size, at_boundary=True))
    if length > max_bytes:
        raise ProtocolError(f"peer announced a {length}-byte frame (max {max_bytes})")
    body = _recv_exact(sock, length, at_boundary=False)
    try:
        obj = json.loads(body)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:  # non-UTF-8 bytes too
        raise ProtocolError(f"invalid JSON frame: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError(f"frame is not a JSON object: {type(obj).__name__}")
    return obj


# -- feedback payload encodings ---------------------------------------------


def encode_bits(x) -> str:
    """1-bit pack a success-bit vector (anything nonzero = success)."""
    bits = np.asarray(x).astype(bool)
    return base64.b64encode(np.packbits(bits).tobytes()).decode()


def decode_bits(s: str, K: int) -> np.ndarray:
    """Inverse of ``encode_bits``; returns float32 ``(K,)`` success bits."""
    raw = np.frombuffer(base64.b64decode(s), np.uint8)
    if raw.size * 8 < K:
        raise ProtocolError(f"packed bits cover {raw.size * 8} clients, need {K}")
    return np.unpackbits(raw, count=K).astype(np.float32)


def encode_lags(lag) -> str:
    """Byte-pack a completion-lag vector; ``DEAD_LAG`` (or any negative /
    >=255 value) becomes the ``LAG_NEVER`` wire code."""
    a = np.asarray(lag, np.int64)
    out = np.where((a < 0) | (a >= LAG_NEVER), LAG_NEVER, a).astype(np.uint8)
    return base64.b64encode(out.tobytes()).decode()


def decode_lags(s: str, K: int) -> np.ndarray:
    """Inverse of ``encode_lags``; returns int32 ``(K,)`` lags with
    ``LAG_NEVER`` mapped back to ``DEAD_LAG``."""
    raw = np.frombuffer(base64.b64decode(s), np.uint8)
    if raw.size < K:
        raise ProtocolError(f"lag codes cover {raw.size} clients, need {K}")
    lag = raw[:K].astype(np.int32)
    return np.where(lag == LAG_NEVER, DEAD_LAG, lag)


def feedback_lags(req: dict, K: int, staleness: int) -> Optional[np.ndarray]:
    """Normalise a ``tick`` request's feedback into int32 ``(K,)`` lag codes
    (the engines' common currency): 0 = on time, ``1..S`` = that many rounds
    late, ``DEAD_LAG`` = never completes.  Sync servers (``staleness == 0``)
    accept success bits and map failure to ``DEAD_LAG``.  Returns None when
    the request carries no feedback field at all.
    """
    if "xb" in req:
        bits = decode_bits(req["xb"], K)
        return np.where(bits > 0, 0, DEAD_LAG).astype(np.int32)
    if "xl" in req:
        return decode_lags(req["xl"], K)
    if "x" in req:
        a = np.asarray(req["x"])
        if a.shape != (K,):
            raise ProtocolError(f"feedback shape {a.shape} != ({K},)")
        if staleness == 0:
            return np.where(a > 0, 0, DEAD_LAG).astype(np.int32)
        lag = a.astype(np.int32)
        return np.where(lag < 0, DEAD_LAG, lag)
    return None
